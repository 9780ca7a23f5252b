"""Mean ms a block waited in the shared dispatcher's queue, from its
submission to the start of its pass: the program's ``dispatch.queue``
span."""

from perfbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "dispatch.queue")
