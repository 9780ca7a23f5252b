"""The program's own spans, as the per-layer readers of them take them.

The program keeps, while a profiler session records, a ring of finished
spans (``tvidz_tpu_torch.utils.timing.TRACER``): name, ``perf_counter``
start and end, id, parent id, trace id and attrs. A reader takes those
whose start falls in the window, ``[kind.t0, kind.t0 + window_s)``, and
gets nothing from a program that keeps no such ring.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def window_spans(ctx) -> List:
    """The program's spans that started in the window; [] without any."""
    try:
        from tvidz_tpu_torch.utils import timing

        finished = timing.TRACER.finished
    except (ImportError, AttributeError):
        return []
    t0, t1 = ctx.kind.t0, ctx.kind.t0 + ctx.window_s
    return [sp for sp in finished() if t0 <= sp.t0 < t1]


def named(spans, name: str) -> List:
    return [sp for sp in spans if sp.name == name]


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean wall of the window's spans of one name, in ms."""
    walls = [sp.t1 - sp.t0 for sp in named(window_spans(ctx), name)]
    return 1e3 * sum(walls) / len(walls) if walls else None


def children_by_parent(spans) -> Dict[int, List]:
    out: Dict[int, List] = {}
    for sp in spans:
        if sp.parent is not None:
            out.setdefault(sp.parent, []).append(sp)
    return out


def whole_analyses(ctx, spans) -> List:
    """The window's ``analyze`` spans that also ended in it: tracing stops
    with the window, so one still running then lacks its later children."""
    end = ctx.kind.t0 + ctx.window_s
    return [sp for sp in named(spans, "analyze") if sp.t1 <= end]
