"""Mean host ms of a /search/fragments request outside its
``locate_fragments`` call: body parsing, store reads, result resolution."""

from perfbench.readers import mean_ms


def read(ctx):
    return mean_ms(sp.seconds - sp.info.get("locate_s", 0.0)
                   for sp in ctx.rec.spans.get("request", ()))
