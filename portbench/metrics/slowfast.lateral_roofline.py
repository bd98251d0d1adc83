"""The laterals' share of their roofline, in percent: the least time the
card could take for the four lateral convolutions and their
concatenations (``harness.conv_work.slowfast_work``'s ``lateral``, FLOPs
and bytes, plus the bytes the concatenations write, the program's
counter ``slowfast.concat_bytes``; FLOPs over the fp32 peak or bytes
over the memory bandwidth, the larger) over the device time launched
inside the program's span ``slowfast.lateral``, over the profiled steps.
None where the run recorded no such span or counter."""

from portbench.harness.flops import roofline_seconds
from portbench.harness.program_trace import row


def read(ctx):
    program = ctx.counts.get('program')
    r = row(program, 'slowfast.lateral')
    work = ctx.counts.get('slowfast_work')
    steps = ctx.counts.get('traced_steps')
    if r is None or not r['device_s'] or ctx.peaks is None or not work \
            or not steps:
        return None
    written = program.counts.get('slowfast.concat_bytes')
    if not written:
        return None
    lateral = work['lateral']
    least = roofline_seconds(
        dict(flops=steps * lateral['flops'],
             bytes=steps * lateral['bytes'] + written),
        ctx.peaks.fp32_flops, ctx.peaks.bytes_per_s)
    return 100.0 * least / r['device_s']
