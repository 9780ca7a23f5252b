"""Share of the analyzer's wall outside every direct child span of
``analyze`` (stages, store, checkpoint, decode wait, thumbnail, progress,
finalize), over the window's whole ``analyze`` spans, in %."""

from perfbench.spans import children_by_parent, whole_analyses, window_spans


def read(ctx):
    spans = window_spans(ctx)
    analyses = whole_analyses(ctx, spans)
    wall = sum(sp.t1 - sp.t0 for sp in analyses)
    if wall <= 0:
        return None
    kids = children_by_parent(spans)
    covered = sum(c.t1 - c.t0 for sp in analyses for c in kids.get(sp.id, ()))
    return 100.0 * (1.0 - covered / wall)
