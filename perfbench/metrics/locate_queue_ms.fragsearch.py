"""Mean ms a request waited before its own alignments ran: for each
``locate`` span with ``k3_device_s``, the time from its start to the end of
its ``locate.pull`` child, less that device time, floored at 0. The pull
ends when the request's last scan has; its scans are launched under the
corpus lock, back to back, so what is left over is the wait ahead of them,
wherever it sits: for the corpus lock, for the queries' copy behind the
other requests' scans on the one stream, or in the pull."""

from perfbench.spans import children_by_parent, named, window_spans


def read(ctx):
    spans = window_spans(ctx)
    kids = children_by_parent(spans)
    waits = []
    for sp in named(spans, "locate"):
        pulls = [c for c in kids.get(sp.id, ()) if c.name == "locate.pull"]
        if "k3_device_s" in sp.attrs and pulls:
            until = max(c.t1 for c in pulls) - sp.t0
            waits.append(max(0.0, until - sp.attrs["k3_device_s"]))
    return 1e3 * sum(waits) / len(waits) if waits else None
