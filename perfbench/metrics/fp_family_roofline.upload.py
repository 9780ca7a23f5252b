"""The family fingerprint pass's share of its roofline: Σ its least time
(``peaks_family.family_bound_s`` of each dispatcher pass's shapes) ÷ the
device time of all work launched inside the passes' ``forward_streams``
calls, in %."""

from perfbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "fp_family")
