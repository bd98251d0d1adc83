"""Host milliseconds a frame that the prefetch thread spends decoding a
video (the self time of the program's span ``test.decode`` around
``dataset[i]``: JPEG decode and the pipeline), over the traced window's
frames. None where the run recorded no program spans."""

from portbench.harness.program_trace import row


def read(ctx):
    r = row(ctx.counts.get('program'), 'test.decode')
    if r is None or not ctx.counts.get('frames'):
        return None
    return 1e3 * r['self_s'] / ctx.counts['frames']
