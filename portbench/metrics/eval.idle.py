"""The share of the traced eval window in which no operation ran on the
card, in percent."""

from portbench.harness.trace import idle_share


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * idle_share(ctx.trace)
