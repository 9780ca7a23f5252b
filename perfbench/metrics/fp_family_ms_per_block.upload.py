"""Mean host ms a block of the program's family fingerprint pass: Σ the
wall of the window's ``fingerprint.family`` spans ÷ the blocks they hashed
(attr ``frames`` ÷ the configuration's ``block_frames``). On the card that
wall is the host's launch of the pass."""

from perfbench.spans import named, window_spans


def read(ctx):
    spans = named(window_spans(ctx), "fingerprint.family")
    blocks = sum(sp.attrs.get("frames", 0) for sp in spans) / float(
        ctx.kind.cfg.pipeline.block_frames)
    if blocks <= 0:
        return None
    return 1e3 * sum(sp.t1 - sp.t0 for sp in spans) / blocks
