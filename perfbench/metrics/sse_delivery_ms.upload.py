"""Mean ms from the registry's write of an upload's verdict to the SSE
stream yielding it: the program's ``sse.deliver`` span."""

from perfbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "sse.deliver")
