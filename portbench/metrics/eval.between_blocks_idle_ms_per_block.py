"""Milliseconds a block (one feature bank of a video) that the card
stands idle while the host sets up the block's labels or reads its masks
back: the idle gaps whose midpoint falls in the program's spans
``tracker.labels`` or ``tracker.readback``
(``models/trackers/vanilla_tracker.py``), over its counter
``tracker.blocks``. None where the run recorded no program spans."""

from portbench.harness.program_trace import row


def read(ctx):
    program = ctx.counts.get('program')
    if program is None or not program.counts.get('tracker.blocks'):
        return None
    idle = sum(r['idle_s'] for r in (row(program, 'tracker.labels'),
                                     row(program, 'tracker.readback'))
               if r is not None)
    return 1e3 * idle / program.counts['tracker.blocks']
