"""Device milliseconds a step of the work launched inside the on-device
augmentation chain (``ops/device_aug.py::DeviceAugChain``) in the traced
steps."""

from portbench.harness.trace import device_seconds


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('traced_steps'):
        return None
    s = device_seconds(ctx.trace, span_name='device_aug')
    return 1e3 * s / ctx.counts['traced_steps'] if s > 0 else None
