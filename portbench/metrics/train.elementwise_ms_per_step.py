"""Device milliseconds a step of ATen's elementwise kernels (activations,
residual adds, BatchNorm's normalisation, the optimizer's chain; by
name) in the traced steps."""

from portbench.harness.trace import device_seconds

KEYS = ('elementwise', 'vectorized', 'unrolled')


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('traced_steps'):
        return None
    s = device_seconds(ctx.trace, keys=KEYS)
    return 1e3 * s / ctx.counts['traced_steps'] if s > 0 else None
