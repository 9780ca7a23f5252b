"""Host decode, ms a frame: Σ the program's ``decode.block`` spans (one
step of the decoder on the prefetch thread: Y4M read and resize) ÷ Σ their
``frames``."""

from perfbench.spans import named, window_spans


def read(ctx):
    steps = named(window_spans(ctx), "decode.block")
    frames = sum(sp.attrs.get("frames", 0) for sp in steps)
    return 1e3 * sum(sp.t1 - sp.t0 for sp in steps) / frames if frames else None
