"""Host milliseconds a frame that the eval loop waits for the prefetch
thread's next video (the program's span ``test.wait_input`` around
``pending.result()`` in ``apis/test.py::single_process_test``), over the
traced window's frames. None where the run recorded no program spans."""

from portbench.harness.program_trace import row


def read(ctx):
    r = row(ctx.counts.get('program'), 'test.wait_input')
    if r is None or not ctx.counts.get('frames'):
        return None
    return 1e3 * r['host_s'] / ctx.counts['frames']
