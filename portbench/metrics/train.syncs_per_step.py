"""Host calls a step that wait for the card (stream, event or device
synchronisations, through which a copy to the host waits, and
synchronous copies) in the traced steps. Reads 0 where the steps never
wait, which is what a loop dispatched ahead wants."""


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('traced_steps') \
            or not ctx.trace.kernels:
        return None
    return ctx.trace.blocking_calls / ctx.counts['traced_steps']
