"""Mean host ms of the ``fp-search`` stage a block: the nearest-row scan
(K4) and the evidence count."""

from perfbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "fp-search")
