"""The fragment alignment's share of its roofline: Σ peaks.align_bound_s of
each call's real query and video lengths ÷ the device time launched inside
the corpus's ``_fragment_query`` calls, in %."""

from perfbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k3")
