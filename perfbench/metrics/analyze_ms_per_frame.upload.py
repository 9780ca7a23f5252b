"""Σ ``Analyzer.analyze`` wall ÷ frames analysed, in ms a frame."""


def read(ctx):
    frames = ctx.rec.counts.get("frames", 0)
    walls = [sp.seconds for sp in ctx.rec.spans.get("analyze", ())]
    return 1e3 * sum(walls) / frames if frames and walls else None
