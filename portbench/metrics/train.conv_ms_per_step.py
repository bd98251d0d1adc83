"""Device milliseconds a step of the backbone's convolutions (cuDNN's
forward, data-gradient and weight-gradient kernels, by name) in the
traced steps."""

from portbench.harness.trace import device_seconds

KEYS = ('conv', 'cudnn', 'xmma', 'wgrad', 'dgrad', 'fprop', 'implicit')


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('traced_steps'):
        return None
    s = device_seconds(ctx.trace, keys=KEYS)
    return 1e3 * s / ctx.counts['traced_steps'] if s > 0 else None
