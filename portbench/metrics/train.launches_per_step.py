"""Kernels launched a step in the traced steps."""


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('traced_steps') \
            or not ctx.trace.kernels:
        return None
    return ctx.trace.kernels / ctx.counts['traced_steps']
