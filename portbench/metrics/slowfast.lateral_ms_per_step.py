"""Device milliseconds a profiled step of the work launched inside the
program's span ``slowfast.lateral`` (the four laterals with their concatenations,
``models/backbones/resnet3d_variants.py::ResNet3dSlowFast``; the
forward pass: the backward runs outside it), over the profiled steps.
None where the run recorded no such span."""

from portbench.harness.program_trace import row


def read(ctx):
    r = row(ctx.counts.get('program'), 'slowfast.lateral')
    if r is None or not r['device_s'] or not ctx.counts.get('traced_steps'):
        return None
    return 1e3 * r['device_s'] / ctx.counts['traced_steps']
