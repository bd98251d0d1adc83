"""Row 1's share of its roofline, in percent: the least time the card
could take for the windowed scores that the window's videos need
(``harness.flops.row1_work``: operations over the fp32 peak or bytes
over the memory bandwidth, the larger; counted once whatever computes
them) over row 1's device time in the traced window."""

from portbench.harness.flops import roofline_seconds
from portbench.harness.trace import device_seconds

ROW1 = ('video_topk', 'video_wide')


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.counts.get('row1'):
        return None
    s = device_seconds(ctx.trace, keys=ROW1)
    if s <= 0:
        return None
    least = sum(roofline_seconds(w, ctx.peaks.fp32_flops,
                                 ctx.peaks.bytes_per_s)
                for w in ctx.counts['row1'])
    return 100.0 * least / s
