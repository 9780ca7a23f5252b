"""The upload-phash256 cell: the family pass's least time against
hand-worked values, its three readers on a tiny context, and a whole run at
a size the CPU holds, correct, with its control (the reference's hash with
TF32 on, in place of the family pass's) not correct on every seed."""

import types

import pytest

from perfbench import control, core, peaks_family
from perfbench.probes import Recorder
from perfbench.tests.tiny import tiny_root
from tvidz_tpu_torch.utils import timing

CELL = "upload-phash256"
NEW = ["fp_family_roofline.upload", "fp_family_ms_per_block.upload",
       "mfu.upload256"]


def test_family_least_time():
    # 128 frames of 90x160 to 256 bits: 69,468,160 float32 operations
    # (1.04 µs at 67 TFLOP/s) against 1,847,296 bytes (0.55 µs).
    ops = 2 * 128 * 16 * (90 * 160 + 160 * 16)
    assert peaks_family.family_ops(128, 90, 160, 16) == ops == 69468160
    assert peaks_family.family_bound_s([128], 90, 160, 16) == pytest.approx(
        ops / 67e12)
    # Two streams' 100 real frames to 64 bits: the bytes bound it.
    nbytes = 100 * 14400 + 100 * 8
    assert peaks_family.family_ops(100, 90, 160, 8) / 67e12 < nbytes / 3.35e12
    assert peaks_family.family_bound_s([60, 40], 90, 160, 8) == pytest.approx(
        nbytes / 3.35e12)


def span(rec, name, t0, t1, **info):
    with rec.span(name, **info) as sp:
        pass
    sp.t0, sp.t1 = t0, t1
    return sp


def ctx(rec, trace=None, platform="gpu"):
    kind = types.SimpleNamespace(
        t0=100.0, cfg=types.SimpleNamespace(
            pipeline=types.SimpleNamespace(block_frames=128)))
    return types.SimpleNamespace(rec=rec, trace=trace, platform=platform,
                                 window_s=10.0, stages={}, passes=0, blocks=0,
                                 kind=kind)


def read(name, c):
    return core.Cell(CELL).reader(name)(c)


@pytest.fixture
def ring(monkeypatch):
    tracer = timing.Tracer()
    monkeypatch.setattr(timing, "TRACER", tracer)
    ids = iter(range(1, 1000))

    def add(name, t0, t1, **attrs):
        tracer.keep(timing.SpanRecord(name, t0, t1, next(ids), None, "k", "t",
                                      attrs))
    return add


def test_device_readers():
    rec = Recorder(False)
    f1 = span(rec, "fp_family", 100.5, 100.6, bound_s=0.001)
    f2 = span(rec, "fp_family", 101.0, 101.1, bound_s=0.002)
    k4 = span(rec, "k4", 102.0, 102.1, bound_s=0.004)
    span(rec, "fp_family", 99.0, 99.1, bound_s=0.5)    # before the window
    span(rec, "k1", 103.0, 103.1, bound_s=0.5)         # not this path's
    trace = {"window_s": 10.0, "busy_s": 0.5,
             "by_span": {f1.seq: 0.01, f2.seq: 0.02, k4.seq: 0.01}}
    c = ctx(rec, trace)
    assert read("fp_family_roofline.upload", c) == pytest.approx(10.0)
    assert read("mfu.upload256", c) == pytest.approx(0.07)
    for name in ("fp_family_roofline.upload", "mfu.upload256"):
        assert read(name, ctx(rec, trace, platform="cpu")) is None
        assert read(name, ctx(rec, None)) is None
        assert read(name, ctx(Recorder(False), trace)) is None


def test_family_ms_per_block(ring):
    ring("fingerprint.family", 100.0, 100.004, algorithm="phash256",
         frames=128, words=8)
    ring("fingerprint.family", 101.0, 101.006, algorithm="phash256",
         frames=256, words=8)                       # two blocks in one pass
    ring("fingerprint.family", 99.0, 99.5, frames=128)   # before the window
    ring("dispatch.pass", 100.0, 100.1, blocks=1)
    assert read("fp_family_ms_per_block.upload", ctx(None)) == pytest.approx(
        10.0 / 3)


def test_family_ms_per_block_nothing_to_read(ring, monkeypatch):
    assert read("fp_family_ms_per_block.upload", ctx(None)) is None
    monkeypatch.delattr(timing, "TRACER")
    assert read("fp_family_ms_per_block.upload", ctx(None)) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")), {
        "uploads-poisson-phash256": {"rate_per_s": 4.0,
                                     "duplicate_share": 0.25}})


def test_cell_runs_correct_with_its_metrics(root):
    c = core.Cell(CELL, root)
    assert c.cell["config"] == "phash256-16m-upload" and c.cell["chips"] == 1
    assert c.config["settings"]["hash"]["algorithm"] == "phash256"
    assert c.traffic["kind"] == "upload_open_loop_hash"
    assert {m["name"] for m in c.end_to_end} == {
        "verdict_p50_ms", "verdict_p95_ms", "setup_s"}
    names = {m["name"] for m in c.per_layer}
    assert set(NEW) <= names
    assert not names & {"k1_roofline.upload", "mfu.upload",
                        "dispatch_wait_ms.upload", "unstaged_pct.upload"}
    line = core.run_cell(CELL, 2 ** 33 + 256, 3, False, device="cpu", root=root,
                         say=lambda *a, **k: None)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"verdict_p50_ms", "verdict_p95_ms", "setup_s"}
    assert set(line["checks"]) == set(c.limits)
    assert all(chk["value"] == 0 for name, chk in line["checks"].items()
               if name != "hash_bits_pct")


def test_control_fails(root):
    for reading in control.readings(CELL, [31, 2 ** 35 + 32, 33], 3,
                                    device="cpu", root=root):
        assert reading["correct"] is False and reading["failed"] == 0
        chk = reading["checks"]["hash_bits_pct"]
        assert chk["value"] > chk["limit"]
