"""The nearest-row scan's share of its roofline: Σ peaks.scan_bound_s of
each call's (queries, corpus rows, words) ÷ the device time launched inside
the corpus's ``_query_nearest`` calls, in %."""

from perfbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k4")
