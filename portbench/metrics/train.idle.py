"""The share of the train loop's time in which no operation runs on the
card, in percent: one less the card's busy time a step (the traced
steps' device operations) over the mean step interval of the traced
run's window (CUDA events at its step boundaries, no profiler running).
The profiled steps themselves run slower than the loop (the profiler's
per-launch cost falls on a host that issues ~5,000 launches a step), so
their own idle share, which the result's ``busy_s`` and ``window_s``
give, overstates the loop's."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 \
            or not ctx.counts.get('traced_steps') \
            or not ctx.counts.get('event_steps'):
        return None
    busy = ctx.trace.busy_s / ctx.counts['traced_steps']
    step = ctx.counts['event_s'] / ctx.counts['event_steps']
    return 100.0 * (1.0 - busy / step)
