"""The whole eval's share of the card's fp32 peak, in percent: the
backbone's FLOPs over the window's frames plus row 1's over its videos
and blocks, over the traced window's seconds."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.counts.get('row1'):
        return None
    work = (ctx.counts['frame_flops'] * ctx.counts['frames']
            + sum(w['flops'] for w in ctx.counts['row1']))
    return 100.0 * work / ctx.trace.window_s / ctx.peaks.fp32_flops
