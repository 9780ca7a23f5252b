"""Share of the analyzer's wall it spent blocked on the decoder: Σ the
``decode.wait`` children of the window's whole ``analyze`` spans ÷ Σ their
wall, in %."""

from perfbench.spans import children_by_parent, whole_analyses, window_spans


def read(ctx):
    spans = window_spans(ctx)
    analyses = whole_analyses(ctx, spans)
    wall = sum(sp.t1 - sp.t0 for sp in analyses)
    if wall <= 0:
        return None
    kids = children_by_parent(spans)
    wait = sum(c.t1 - c.t0 for sp in analyses for c in kids.get(sp.id, ())
               if c.name == "decode.wait")
    return 100.0 * wait / wall
