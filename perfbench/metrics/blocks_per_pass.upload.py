"""Blocks the shared dispatcher carried a pass over the window."""


def read(ctx):
    return ctx.blocks / ctx.passes if ctx.passes > 0 else None
