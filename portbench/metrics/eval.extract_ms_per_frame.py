"""Device milliseconds a frame of the work launched inside the tracker's
``_extract_feats`` (the ResNet over the frames, cuDNN, and the bank
copies), from the traced window."""

from portbench.harness.trace import device_seconds


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('frames'):
        return None
    s = device_seconds(ctx.trace, span_name='extract')
    return 1e3 * s / ctx.counts['frames'] if s > 0 else None
