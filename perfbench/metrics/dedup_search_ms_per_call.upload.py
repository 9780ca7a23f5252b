"""Mean host ms of the ``dedup-search`` stage a call: the timestamp
upsert and match."""

from perfbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "dedup-search")
