"""Arithmetic the per-layer readers in ``perfbench/metrics`` share.

Each returns None when the run gave it nothing to read, and device
quantities (a roofline share, the idle share, the share of the peak) only
from a traced run on the card: never from a CPU run.
"""

from __future__ import annotations

from typing import Optional


def mean_ms(values) -> Optional[float]:
    values = list(values)
    return 1e3 * sum(values) / len(values) if values else None


def span_mean_ms(ctx, name: str) -> Optional[float]:
    return mean_ms(sp.seconds for sp in ctx.rec.spans.get(name, ()))


def stage_ms(ctx, stage: str) -> Optional[float]:
    """Mean host ms of one ``StageTimer`` stage over the window's calls."""
    s = ctx.stages.get(stage)
    if not s or s["count"] <= 0:
        return None
    return 1e3 * s["total_s"] / s["count"]


def _on_card(ctx) -> bool:
    return ctx.platform == "gpu" and ctx.trace is not None


def roofline_pct(ctx, span: str) -> Optional[float]:
    """Σ least time of the op's calls ÷ Σ device time launched from inside
    them, over the calls the trace saw run, in %."""
    if not _on_card(ctx):
        return None
    bound = device = 0.0
    for sp in ctx.rec.spans.get(span, ()):
        d = ctx.trace["by_span"].get(sp.seq, 0.0)
        if d > 0:
            bound += sp.info["bound_s"]
            device += d
    return 100.0 * bound / device if device > 0 else None


def idle_pct(ctx) -> Optional[float]:
    if not _on_card(ctx) or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])


def peak_share_pct(ctx, spans) -> Optional[float]:
    """Σ least time at peak of every device op the window started ÷ the
    window: the whole path's share of the chip's peak, in %."""
    if not _on_card(ctx):
        return None
    t0, t1 = ctx.kind.t0, ctx.kind.t0 + ctx.window_s
    need = sum(sp.info["bound_s"] for name in spans
               for sp in ctx.rec.spans.get(name, ()) if t0 <= sp.t0 < t1)
    return 100.0 * need / ctx.window_s if need > 0 else None
