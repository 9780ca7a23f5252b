"""The whole search path's share of the chip's peak: the least time at
peak of every fragment alignment (K3) the window started, ÷ the window,
in %."""

from perfbench.readers import peak_share_pct


def read(ctx):
    return peak_share_pct(ctx, ("k3",))
