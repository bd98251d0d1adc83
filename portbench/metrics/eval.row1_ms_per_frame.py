"""Device milliseconds a frame of row 1, the windowed top-k affinity
kernel (``csrc/video_topk_affinity.cu``'s ``video_topk_kernel``, or the
wide kernel past the core's limits), summed over every block, from the
traced window."""

from portbench.harness.trace import device_seconds

ROW1 = ('video_topk', 'video_wide')


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('frames'):
        return None
    s = device_seconds(ctx.trace, keys=ROW1)
    return 1e3 * s / ctx.counts['frames'] if s > 0 else None
