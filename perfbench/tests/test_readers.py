"""Each per-layer reader on recorded spans and counters, and the reading of
a profiler trace, against hand-worked values."""

import json
import types

import pytest

from perfbench import core
from perfbench.probes import Recorder, read_trace

CELL = {"upload": "upload-phash64", "fragsearch": "fragsearch-phash256"}


def span(rec, name, t0, t1, **info):
    with rec.span(name, **info) as sp:
        pass
    sp.t0, sp.t1 = t0, t1
    return sp


def ctx(rec, trace=None, platform="gpu", stages=None, passes=0, blocks=0):
    return types.SimpleNamespace(
        rec=rec, trace=trace, platform=platform, window_s=10.0,
        stages=stages or {}, passes=passes, blocks=blocks,
        kind=types.SimpleNamespace(t0=100.0))


def read(name, c):
    return core.Cell(CELL[name.rsplit(".", 1)[1]]).reader(name)(c)


def test_host_span_readers():
    rec = Recorder(False)
    rec.mark("put", "a", 1.0)
    rec.mark("dispatch", "a", 1.5)
    rec.mark("put", "b", 2.0)
    rec.mark("dispatch", "b", 4.5)
    rec.mark("put", "c", 3.0)                   # never dispatched: not counted
    span(rec, "analyze", 0.0, 2.0)
    span(rec, "analyze", 0.0, 1.0)
    rec.add("frames", 1500)
    span(rec, "request", 0.0, 0.2, locate_s=0.15)
    span(rec, "request", 0.0, 0.1, locate_s=0.09)
    span(rec, "locate", 0.0, 0.15)
    span(rec, "locate", 0.0, 0.09)
    stages = {"fingerprint": {"total_s": 0.6, "count": 3},
              "fp-search": {"total_s": 0.2, "count": 4},
              "dedup-search": {"total_s": 0.0, "count": 0},
              "download": {"total_s": 0.25, "count": 2}}
    c = ctx(rec, stages=stages, passes=4, blocks=5)
    assert read("dispatch_wait_ms.upload", c) == pytest.approx(1500.0)
    assert read("analyze_ms_per_frame.upload", c) == pytest.approx(2.0)
    assert read("unstaged_pct.upload", c) == pytest.approx(65.0)
    assert read("blocks_per_pass.upload", c) == pytest.approx(1.25)
    assert read("fingerprint_ms_per_block.upload", c) == pytest.approx(200.0)
    assert read("fp_search_ms_per_block.upload", c) == pytest.approx(50.0)
    assert read("dedup_search_ms_per_call.upload", c) is None
    assert read("route_host_ms.fragsearch", c) == pytest.approx(30.0)
    assert read("locate_ms_per_request.fragsearch", c) == pytest.approx(120.0)


def test_device_readers():
    rec = Recorder(False)
    a = span(rec, "k4", 100.5, 100.6, bound_s=0.001)
    b = span(rec, "k4", 101.0, 101.1, bound_s=0.003)
    span(rec, "k4", 120.0, 120.1, bound_s=0.5)      # after the window, unseen
    k1 = span(rec, "k1", 102.0, 102.1, bound_s=0.0005)
    k3 = span(rec, "k3", 103.0, 103.2, bound_s=0.01)
    trace = {"window_s": 10.0, "busy_s": 0.25,
             "by_span": {a.seq: 0.004, b.seq: 0.006, k1.seq: 0.002,
                         k3.seq: 0.05}}
    c = ctx(rec, trace)
    assert read("k4_roofline.upload", c) == pytest.approx(40.0)
    assert read("k1_roofline.upload", c) == pytest.approx(25.0)
    assert read("k3_roofline.fragsearch", c) == pytest.approx(20.0)
    assert read("device_idle_pct.upload", c) == pytest.approx(97.5)
    assert read("device_idle_pct.fragsearch", c) == pytest.approx(97.5)
    assert read("mfu.upload", c) == pytest.approx(0.045)
    assert read("mfu.fragsearch", c) == pytest.approx(0.1)


def test_no_device_number_from_a_cpu_run():
    rec = Recorder(False)
    a = span(rec, "k4", 100.5, 100.6, bound_s=0.001)
    trace = {"window_s": 10.0, "busy_s": 0.25, "by_span": {a.seq: 0.004}}
    for name in ("k4_roofline.upload", "device_idle_pct.upload", "mfu.upload"):
        assert read(name, ctx(rec, trace, platform="cpu")) is None
        assert read(name, ctx(rec, None)) is None


def test_read_trace(tmp_path):
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "args": args}

    events = [
        x("user_annotation", "perfbench.window", 0, 1000),
        x("user_annotation", "perfbench.k4#7", 100, 200, tid=5),
        x("cuda_runtime", "cudaLaunchKernel", 150, 5, tid=5, correlation=1),
        x("kernel", "scan", 200, 50, tid=9, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 550, 5, tid=6, correlation=2),
        x("kernel", "other", 600, 100, tid=9, correlation=2),
        x("gpu_memcpy", "Memcpy HtoD", 650, 100, tid=9),
        x("kernel", "late", 990, 50, tid=9),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = read_trace(str(path), host_state=lambda t: "queued" if t > 0.0005 else None)
    assert got["window_s"] == pytest.approx(0.001)
    assert got["busy_s"] == pytest.approx((50 + 150 + 10) / 1e6)
    assert got["by_span"] == {7: pytest.approx(50e-6)}
    assert got["device_ops"][0] == ["other", pytest.approx(100e-6)]
    assert [g[0] for g in got["idle_gaps"]] == [
        "no request in flight", "queued", "k4"]
    assert [g[1] for g in got["idle_gaps"]] == pytest.approx(
        [350e-6, 240e-6, 200e-6])
