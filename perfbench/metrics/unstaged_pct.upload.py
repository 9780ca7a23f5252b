"""Share of the analyzer's wall outside every ``StageTimer`` stage: host
decode and resize, prefetch waits, store writes and bookkeeping, in %."""


def read(ctx):
    wall = sum(sp.seconds for sp in ctx.rec.spans.get("analyze", ()))
    staged = sum(s["total_s"] for s in ctx.stages.values())
    return 100.0 * (1.0 - staged / wall) if wall > 0 else None
