"""The whole verdict path's share of the chip's peak under a family hash:
the least time at peak of every family fingerprint pass and nearest-row
scan (K4) the window started, ÷ the window, in %."""

from perfbench.readers import peak_share_pct


def read(ctx):
    return peak_share_pct(ctx, ("fp_family", "k4"))
