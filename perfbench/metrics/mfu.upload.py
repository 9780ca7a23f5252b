"""The whole verdict path's share of the chip's peak: the least time at
peak of every fingerprint pass (K1) and nearest-row scan (K4) the window
started, ÷ the window, in %."""

from perfbench.readers import peak_share_pct


def read(ctx):
    return peak_share_pct(ctx, ("k1", "k4"))
