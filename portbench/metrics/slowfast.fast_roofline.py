"""The fast pathway's forward share of its roofline, in percent: the
least time the card could take for its convolutions
(``harness.conv_work.slowfast_work``'s ``fast``: their FLOPs over the
fp32 peak or their inputs, weights and outputs over the memory
bandwidth, the larger) over the device time launched inside the
program's span ``slowfast.fast``, over the profiled steps. None where
the run recorded no such span."""

from portbench.harness.flops import roofline_seconds
from portbench.harness.program_trace import row


def read(ctx):
    r = row(ctx.counts.get('program'), 'slowfast.fast')
    work = ctx.counts.get('slowfast_work')
    steps = ctx.counts.get('traced_steps')
    if r is None or not r['device_s'] or ctx.peaks is None or not work \
            or not steps:
        return None
    least = steps * roofline_seconds(work['fast'], ctx.peaks.fp32_flops,
                                     ctx.peaks.bytes_per_s)
    return 100.0 * least / r['device_s']
