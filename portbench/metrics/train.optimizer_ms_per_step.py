"""Device milliseconds a profiled step of the work launched inside the
program's span ``train.optimizer`` (the update of ``core/optimizer``'s
written-out SGD), over the profiled steps. None where the run recorded
no program spans."""

from portbench.harness.program_trace import row


def read(ctx):
    r = row(ctx.counts.get('program'), 'train.optimizer')
    if r is None or not ctx.counts.get('traced_steps'):
        return None
    return 1e3 * r['device_s'] / ctx.counts['traced_steps']
