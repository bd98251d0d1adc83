"""Host milliseconds a profiled step that the step issues work rather
than waits for the card: the program's span ``train.step``
(``apis/train.py::make_train_step``) less the runtime calls inside it
that block the host, over the profiled steps. None where the run
recorded no program spans."""

from portbench.harness.program_trace import row


def read(ctx):
    r = row(ctx.counts.get('program'), 'train.step')
    if r is None or not ctx.counts.get('traced_steps'):
        return None
    return 1e3 * (r['host_s'] - r['wait_s']) / ctx.counts['traced_steps']
