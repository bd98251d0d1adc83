"""The 95th percentile of the window's step intervals, in milliseconds,
from CUDA events recorded at each step boundary of a traced run's
window (before its profiled steps)."""

import statistics


def read(ctx):
    ms = ctx.counts.get('step_ms')
    if not ms or len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[-1]
