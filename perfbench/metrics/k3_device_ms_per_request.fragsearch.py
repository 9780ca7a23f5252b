"""Mean device ms of one request's fragment alignments (K3 and any bucket
sync among them): the CUDA-event time the program puts on its ``locate``
span as ``k3_device_s``."""

from perfbench.spans import named, window_spans


def read(ctx):
    k3 = [sp.attrs["k3_device_s"] for sp in named(window_spans(ctx), "locate")
          if "k3_device_s" in sp.attrs]
    return 1e3 * sum(k3) / len(k3) if k3 else None
