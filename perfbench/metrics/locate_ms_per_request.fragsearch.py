"""Mean ms of ``DeviceCorpus.locate_fragments`` a request: placing the
queries, syncing the buckets, K3 a bucket, pulling and ranking."""

from perfbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "locate")
