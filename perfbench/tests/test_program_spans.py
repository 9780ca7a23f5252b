"""The readers of the program's own spans (``perfbench/spans.py``) on
synthetic spans: the window, nothing to read, and hand-worked values."""

import types

import pytest

from perfbench import core
from tvidz_tpu_torch.utils import timing

CELL = {"upload": "upload-phash64", "fragsearch": "fragsearch-phash256"}
UPLOAD = ["queue_age_ms.upload", "sse_delivery_ms.upload",
          "decode_ms_per_frame.upload", "decode_wait_pct.upload",
          "analyze_untraced_pct.upload", "vid_table_copy_ms_per_block.upload",
          "dispatch_queue_ms_per_block.upload"]
SEARCH = ["k3_device_ms_per_request.fragsearch", "locate_queue_ms.fragsearch"]


def read(name, ctx):
    return core.Cell(CELL[name.rsplit(".", 1)[1]]).reader(name)(ctx)


def ctx():
    """A window of 10 s from t = 100."""
    return types.SimpleNamespace(window_s=10.0, kind=types.SimpleNamespace(t0=100.0))


@pytest.fixture
def spans(monkeypatch):
    """A fresh program ring; ``add(name, t0, t1, parent=None, **attrs)``
    appends a finished span and returns its id."""
    tracer = timing.Tracer()
    monkeypatch.setattr(timing, "TRACER", tracer)
    ids = iter(range(1, 1000))

    def add(name, t0, t1, parent=None, **attrs):
        sid = next(ids)
        tracer.keep(timing.SpanRecord(name, t0, t1, sid, parent, "k", "t",
                                      attrs))
        return sid
    return add


@pytest.mark.parametrize("name", UPLOAD + SEARCH)
def test_nothing_to_read(spans, name):
    assert read(name, ctx()) is None


@pytest.mark.parametrize("name", UPLOAD + SEARCH)
def test_a_program_without_the_ring(monkeypatch, name):
    monkeypatch.delattr(timing, "TRACER")
    assert read(name, ctx()) is None


def test_means_of_single_spans(spans):
    spans("queue.age", 100.0, 100.9)
    spans("queue.age", 105.0, 106.1)
    spans("queue.age", 99.0, 104.0)          # put before the window
    spans("queue.age", 110.0, 110.5)         # at the window's end: outside
    spans("sse.deliver", 101.0, 101.08)
    spans("corpus.vid_copy", 102.0, 102.01, bytes=67108864)
    spans("corpus.vid_copy", 103.0, 103.03, bytes=67108864)
    spans("dispatch.queue", 104.0, 104.0005)
    c = ctx()
    assert read("queue_age_ms.upload", c) == pytest.approx(1000.0)
    assert read("sse_delivery_ms.upload", c) == pytest.approx(80.0)
    assert read("vid_table_copy_ms_per_block.upload", c) == pytest.approx(20.0)
    assert read("dispatch_queue_ms_per_block.upload", c) == pytest.approx(0.5)


def test_decode_per_frame(spans):
    spans("decode.block", 101.0, 101.1, frames=128)
    spans("decode.block", 101.2, 101.3, frames=72)
    spans("decode.block", 101.3, 101.35)     # the decoder's end: no frames
    spans("decode.block", 90.0, 95.0, frames=128)   # before the window
    assert read("decode_ms_per_frame.upload", ctx()) == pytest.approx(1.25)


def test_analyze_children(spans):
    a = spans("analyze", 101.0, 102.0)
    spans("decode.wait", 101.0, 101.3, a)
    spans("fingerprint", 101.3, 101.5, a)
    spans("dispatch.pass", 101.3, 101.4, spans("x", 101.3, 101.5, a))  # deeper
    b = spans("analyze", 103.0, 104.0)
    spans("decode.wait", 103.0, 103.1, b)
    spans("finalize", 103.1, 103.8, b)
    late = spans("analyze", 109.0, 111.0)   # ran past the window: left out
    spans("decode.wait", 109.0, 109.1, late)
    c = ctx()
    # walls 2.0 s; decode.wait 0.4 s; direct children 0.3+0.2+0.2 + 0.1+0.7
    assert read("decode_wait_pct.upload", c) == pytest.approx(20.0)
    assert read("analyze_untraced_pct.upload", c) == pytest.approx(25.0)


def test_locate_queue_is_floored_at_zero(spans):
    r1 = spans("locate", 101.0, 101.4, k3_device_s=0.07)
    spans("locate.pull", 101.1, 101.35, r1)  # 350 ms to the pull's end, 70 own: 280
    r2 = spans("locate", 102.0, 102.2, k3_device_s=0.08)
    spans("locate.pull", 102.0, 102.05, r2)  # done before its own K3's time: 0
    r3 = spans("locate", 103.0, 103.1)       # no device time (CPU): skipped
    spans("locate.pull", 103.0, 103.05, r3)
    r4 = spans("locate", 80.0, 80.5, k3_device_s=0.07)   # before the window
    spans("locate.pull", 80.0, 80.4, r4)
    c = ctx()
    assert read("k3_device_ms_per_request.fragsearch", c) == pytest.approx(75.0)
    assert read("locate_queue_ms.fragsearch", c) == pytest.approx(140.0)
