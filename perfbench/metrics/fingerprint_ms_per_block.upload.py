"""Mean host ms of the ``fingerprint`` stage a block (dispatch to K1 and
back, scene scoring)."""

from perfbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "fingerprint")
