"""Port parity: the multistream engine (``pipeline/multistream.py``).

Mirrors tests/test_multistream.py on the port (device ``cpu``: the plain
versions, no transfer pump), and holds ``fingerprint_streams`` against the
JAX package's on the same seeded Y4M files: per stream the cuts and the
fingerprints equal (the plain version's hashes equal the reference's on
these inputs, as tests/test_torch_forward_streams.py finds), and each stream
equals a lone analysis of its file. Also the two faults of the reference's
engine that the port does not copy (ADVICE.md): a resolver that hits a
BaseException no longer hangs ``drain()``, and on an abnormal exit no pass
folds after ``fingerprint_streams`` has returned.
"""

import threading
import time

import numpy as np
import pytest

from tvidz_tpu.config import Config as JaxConfig
from tvidz_tpu.models.fingerprint import FingerprintModel as JaxModel
from tvidz_tpu.pipeline.multistream import fingerprint_streams as jax_streams
from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.decode import synthetic_video, write_synthetic_y4m, write_y4m
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.pipeline import multistream as ms
from tvidz_tpu_torch.pipeline.multistream import fingerprint_streams


def _cfg(cls=Config):
    cfg = cls()
    cfg.pipeline.block_frames = 32
    cfg.pipeline.scene_height = 72
    cfg.pipeline.scene_width = 96
    return cfg


def _model():
    return FingerprintModel(_cfg(), device="cpu")


def _videos(tmp_path, specs, seed, prefix="v"):
    paths = []
    for i, (frames, cuts) in enumerate(specs):
        luma, _ = synthetic_video(num_frames=frames, height=72, width=96,
                                  cut_frames=cuts, seed=seed + i)
        paths.append(str(tmp_path / f"{prefix}{i}.y4m"))
        write_y4m(paths[-1], luma, fps=25.0)
    return paths


def _assert_lone(results):
    for r in results:
        assert r.error is None
        want_cuts, want_fps = _model().analyze_path(r.path)
        assert r.scene_cuts == want_cuts
        np.testing.assert_array_equal(r.fingerprints, want_fps)


def test_streams_match_reference_and_single_stream(tmp_path):
    paths = _videos(tmp_path, [(96, (30, 60)), (160, (50,)), (64, (20, 40))], 20)
    results, stats = fingerprint_streams(paths, model=_model())
    assert stats.streams == 3 and stats.frames == 96 + 160 + 64
    assert stats.wall_s > 0 and stats.device_s >= 0
    assert 0 < stats.dispatches <= 3 + 5 + 2
    _assert_lone(results)
    want, _ = jax_streams(paths, model=JaxModel(_cfg(JaxConfig)))
    for r, w in zip(results, want):
        assert r.scene_cuts == w.scene_cuts and r.frames == w.frames
        np.testing.assert_array_equal(r.fingerprints, w.fingerprints)


def test_streams_isolate_errors(tmp_path):
    (good,) = _videos(tmp_path, [(64, (20,))], 5)
    bad = str(tmp_path / "missing.y4m")
    results, _ = fingerprint_streams([good, bad], config=_cfg(), device="cpu")
    assert results[0].error is None and results[0].frames == 64
    assert results[1].error is not None and results[1].frames == 0


def test_dispatch_failure_does_not_leak_decoder_threads(tmp_path, monkeypatch):
    cfg = Config()
    cfg.pipeline.block_frames = 16
    cfg.pipeline.scene_height = 48
    cfg.pipeline.scene_width = 64
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"s{i}.y4m"))
        write_synthetic_y4m(paths[-1], num_frames=200, height=48, width=64,
                            cut_frames=(50,), seed=i)
    model = FingerprintModel(cfg, device="cpu")
    calls = {"n": 0}
    real_forward = model.forward_streams

    def dying_forward(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 4:
            raise RuntimeError("injected device fault")
        return real_forward(*a, **kw)

    monkeypatch.setattr(model, "forward_streams", dying_forward)
    before = threading.active_count()
    results, _ = fingerprint_streams(paths, model=model)
    assert any(r.error and "injected device fault" in r.error for r in results)
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "decoder threads leaked"


@pytest.mark.parametrize("max_active", [1, 2, 8])
def test_admission_control_results_and_parity(tmp_path, max_active):
    paths = _videos(tmp_path, [(96, (30, 60)), (64, (20,)), (128, (40, 80, 100))], 40)
    results, stats = fingerprint_streams(paths, model=_model(),
                                         max_active=max_active)
    assert stats.frames == 96 + 64 + 128
    _assert_lone(results)


def test_one_pass_takes_every_ready_stream(tmp_path):
    """3 streams of 3 blocks each: fewer passes than blocks, and none of
    the streams' carries or cuts cross."""
    paths = _videos(tmp_path, [(96, (30, 60))] * 3, 60, prefix="b")
    results, stats = fingerprint_streams(paths, model=_model(), max_active=3)
    assert stats.dispatches <= 9
    _assert_lone(results)


def test_warm_dispatch_runs_every_bucket():
    model = _model()
    seen = []
    real = model.forward_streams
    model.forward_streams = lambda l, c, v: seen.append(len(l)) or real(l, c, v)
    ms.warm_dispatch(model, 3)
    assert seen == [1, 2, 4]


def test_async_resolve_parity(tmp_path, monkeypatch):
    paths = _videos(tmp_path, [(96, (30, 60)), (160, (50,)), (64, (20, 40))], 80, "r")
    assert ms.ASYNC_RESOLVE is None
    monkeypatch.setattr(ms, "ASYNC_RESOLVE", True)
    a_results, a_stats = fingerprint_streams(paths, model=_model(), max_active=3)
    monkeypatch.setattr(ms, "ASYNC_RESOLVE", False)
    s_results, s_stats = fingerprint_streams(paths, model=_model(), max_active=3)
    assert a_stats.frames == s_stats.frames == 96 + 160 + 64
    for ra, rs in zip(a_results, s_results):
        assert ra.error is None and rs.error is None
        assert ra.scene_cuts == rs.scene_cuts
        np.testing.assert_array_equal(ra.fingerprints, rs.fingerprints)
    assert s_stats.resolve_busy_s == s_stats.resolve_s


def test_resolve_failure_surfaces_per_stream(tmp_path, monkeypatch):
    paths = _videos(tmp_path, [(96, (30,))] * 2, 90, "f")
    real_resolve = ms._resolve
    state = {"n": 0}

    def flaky_resolve(m, pending):
        state["n"] += 1
        if state["n"] == 2:
            raise RuntimeError("injected resolve fault")
        return real_resolve(m, pending)

    monkeypatch.setattr(ms, "_resolve", flaky_resolve)
    monkeypatch.setattr(ms, "ASYNC_RESOLVE", True)
    results, _ = fingerprint_streams(paths, model=_model(), max_active=1)
    errs = [r for r in results if r.error and "injected resolve fault" in r.error]
    ok = [r for r in results if r.error is None]
    assert len(errs) == 1, [r.error for r in results]
    assert len(ok) == 1 and ok[0].frames == 96


class _Fatal(BaseException):
    """Not an Exception: the reference's resolver thread died on it."""


def test_resolver_survives_a_base_exception(tmp_path, monkeypatch):
    """ADVICE r5: the reference's resolver marked an item done only after a
    caught Exception, so a BaseException killed the thread and drain()
    waited forever. Here the pass's stream fails and the call returns."""
    paths = _videos(tmp_path, [(96, (30,))] * 2, 95, "x")
    real_resolve = ms._resolve
    state = {"n": 0}

    def fatal_resolve(m, pending):
        state["n"] += 1
        if state["n"] == 1:
            raise _Fatal("injected fatal resolve")
        return real_resolve(m, pending)

    monkeypatch.setattr(ms, "_resolve", fatal_resolve)
    monkeypatch.setattr(ms, "ASYNC_RESOLVE", True)
    out = {}
    worker = threading.Thread(target=lambda: out.update(r=fingerprint_streams(
        paths, model=_model(), max_active=1)), daemon=True)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive(), "fingerprint_streams hung on a dead resolver"
    results, _ = out["r"]
    assert [bool(r.error and "injected fatal resolve" in r.error)
            for r in results] == [True, False]
    assert results[1].frames == 96


def test_no_pass_folds_after_an_abnormal_return(tmp_path, monkeypatch):
    """ADVICE r5: on an abnormal exit the reference queued its stop
    sentinel behind unresolved passes, which went on folding into the
    streams after fingerprint_streams had returned. Here they are dropped
    and the resolver is joined before the exception leaves the call."""
    paths = _videos(tmp_path, [(160, (30,))] * 2, 97, "y")
    gate = threading.Event()
    folds = []
    real_resolve = ms._resolve

    def slow_resolve(m, pending):
        gate.wait(5)
        real_resolve(m, pending)
        folds.append(time.perf_counter())

    real_dispatch = ms._dispatch
    calls = {"n": 0}

    def interrupting_dispatch(m, ready):
        calls["n"] += 1
        if calls["n"] == 4:
            threading.Timer(0.2, gate.set).start()
            raise KeyboardInterrupt("injected interrupt")
        return real_dispatch(m, ready)

    monkeypatch.setattr(ms, "_resolve", slow_resolve)
    monkeypatch.setattr(ms, "_dispatch", interrupting_dispatch)
    monkeypatch.setattr(ms, "ASYNC_RESOLVE", True)
    with pytest.raises(KeyboardInterrupt):
        fingerprint_streams(paths, model=_model(), max_active=2)
    returned = time.perf_counter()
    n = len(folds)
    time.sleep(1.0)
    assert len(folds) == n and all(t <= returned for t in folds)
    assert not any(t.name == "resolver" for t in threading.enumerate())


class _PoisonWrap:
    """forward_streams raises whenever its pass holds a block of the poison
    video (all-255 luma)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def forward_streams(self, lumas, carries, valid):
        if any(int(l.min()) == 255 for l in lumas):
            raise RuntimeError("poison block")
        return self._inner.forward_streams(lumas, carries, valid)


def test_stream_failure_isolated_to_its_stream(tmp_path):
    model = _PoisonWrap(_model())
    (good,) = _videos(tmp_path, [(96, (30, 60))], 7, "g")
    poison = str(tmp_path / "poison.y4m")
    write_y4m(poison, np.full((64, 72, 96), 255, np.uint8), fps=25.0)
    results, _ = fingerprint_streams([good, poison], model=model, max_active=2)
    by_path = {r.path: r for r in results}
    g, p = by_path[good], by_path[poison]
    assert p.error is not None and "poison" in p.error
    assert g.error is None and g.frames == 96
    solo, _ = fingerprint_streams([good], model=_model())
    assert g.scene_cuts == solo[0].scene_cuts
    assert np.array_equal(g.fingerprints, solo[0].fingerprints)


class _FailingPump:
    """A transfer pump whose every copy fails (as a CUDA fault on the
    pump's stream would): it hands the block its error at once."""

    def submit(self, holder, payload):
        holder[0] = RuntimeError("h2d copy failed")


def test_pump_failure_fails_its_stream_alone(tmp_path, monkeypatch):
    """A copy the pump failed is not swallowed: the pass that takes the
    block raises its error, which fails that stream alone, with the error."""

    class _PumpedStream(ms._Stream):
        def __init__(self, path, model, depth=2, pump=None):
            if "pumped" in path:
                pump = _FailingPump()
            super().__init__(path, model, depth=depth, pump=pump)

    monkeypatch.setattr(ms, "_Stream", _PumpedStream)
    (good,) = _videos(tmp_path, [(96, (30, 60))], 11, "g")
    (pumped,) = _videos(tmp_path, [(64, (20,))], 12, "pumped")
    results, _ = fingerprint_streams([good, pumped], model=_model(), max_active=2)
    by_path = {r.path: r for r in results}
    assert "h2d copy failed" in (by_path[pumped].error or "")
    assert by_path[good].error is None and by_path[good].frames == 96
    _assert_lone([by_path[good]])

