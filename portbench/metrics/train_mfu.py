"""The whole train step's share of the card's fp32 peak, in percent: the
frozen count of a step's FLOPs (``harness.flops.train_flops``) times the
steps between the first and the last CUDA event of a traced run's window
(one a step boundary, no profiler running), over the device time between
those events."""


def read(ctx):
    if ctx.peaks is None or not ctx.counts.get('event_steps') \
            or not ctx.counts.get('event_s'):
        return None
    work = ctx.counts['step_flops'] * ctx.counts['event_steps']
    return 100.0 * work / ctx.counts['event_s'] / ctx.peaks.fp32_flops
