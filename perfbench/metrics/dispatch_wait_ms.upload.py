"""Mean ms from an upload's S3 put to the service starting its analysis
thread: the S3 event, the SQS queue and the poller's cadence."""

from perfbench.readers import mean_ms


def read(ctx):
    put, go = ctx.rec.marks.get("put", {}), ctx.rec.marks.get("dispatch", {})
    return mean_ms(go[k] - put[k] for k in put if k in go)
