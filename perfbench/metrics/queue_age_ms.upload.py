"""Mean ms an upload's S3 event waited in the queue: the program's
``queue.age`` span, from the record's ``eventTime`` to the poller's
receipt of it."""

from perfbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "queue.age")
