"""Host milliseconds a profiled step in runtime calls that wait for the
card (stream, event or device synchronisations and synchronous copies)
inside the program's span ``train.step``, over the profiled steps. None
where the run recorded no program spans."""

from portbench.harness.program_trace import row


def read(ctx):
    r = row(ctx.counts.get('program'), 'train.step')
    if r is None or not ctx.counts.get('traced_steps'):
        return None
    return 1e3 * r['wait_s'] / ctx.counts['traced_steps']
