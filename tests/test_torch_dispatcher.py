"""The port's SharedBlockDispatcher on the CPU.

A batched pass gives every block what a lone ``process_block`` gives it, bit
for bit; one failing block fails only its own future; ``stop()`` fails what
is still queued and every later submission. (The pinned-memory side-stream
copy is CUDA-only and runs in chip_smoke.py's service phase.)
"""

import threading
import types

import numpy as np
import pytest
import torch

from tvidz_tpu_torch._reference import Config, synthetic
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.ops import phash
from tvidz_tpu_torch.ops.fused import FingerprintCarry
from tvidz_tpu_torch.ops.scene import NativeSceneScorer, SceneCarry
from tvidz_tpu_torch.pipeline.dispatcher import SharedBlockDispatcher
from tvidz_tpu_torch.pipeline.multistream import _bucket

T, H, W = 16, 36, 64


def _model() -> FingerprintModel:
    cfg = Config()
    cfg.pipeline.block_frames = T
    cfg.pipeline.scene_height = H
    cfg.pipeline.scene_width = W
    return FingerprintModel(cfg, device="cpu")


def _video(seed: int, n: int = 2 * T + 7) -> np.ndarray:
    luma, _ = synthetic.synthetic_video(n, H, W, cut_frames=(6, 21), seed=seed)
    return luma


def _blocks(luma):
    pts = np.arange(luma.shape[0]) / 25.0
    return [types.SimpleNamespace(luma=luma[s:s + T], pts=pts[s:s + T], mafd=None)
            for s in range(0, luma.shape[0], T)]


def test_batched_pass_equals_lone_process_block():
    """Three streams' first blocks, queued before the worker starts, ride
    one pass; later rounds batch as they arrive. Every stream's fps, cuts
    and carry equal the direct path's."""
    direct = _model()
    batched = _model()
    d = SharedBlockDispatcher(batched, max_bucket=4)
    batched.dispatcher = d
    videos = [_blocks(_video(s)) for s in (1, 2, 3)]
    want = []
    for blocks in videos:
        carry, scorer, out = direct.init_carry(), NativeSceneScorer(False), []
        for b in blocks:
            fps, carry, cuts, t = direct.process_block(b, carry, scorer)
            out.append((fps, cuts, t))
        want.append((out, carry))
    carries = [batched.init_carry() for _ in videos]
    scorers = [NativeSceneScorer(False) for _ in videos]
    for r in range(len(videos[0])):
        results = [None] * len(videos)

        def run(j, r=r):
            results[j] = batched.process_block(videos[j][r], carries[j],
                                               scorers[j])

        threads = [threading.Thread(target=run, args=(j,))
                   for j in range(len(videos))]
        for th in threads:
            th.start()
        if r == 0:
            while d._q.qsize() < len(videos):   # all queued, worker idle
                threading.Event().wait(0.01)
            d.start()
        for th in threads:
            th.join(timeout=30)
        if r == 0:
            assert (d.passes, d.blocks) == (1, len(videos))
        for j, (fps, carry, cuts, t) in enumerate(results):
            wfps, wcuts, wt = want[j][0][r]
            assert fps.dtype == np.uint32 and t == wt and cuts == wcuts
            np.testing.assert_array_equal(fps, wfps)
            carries[j] = carry
    for j in range(len(videos)):
        assert torch.equal(carries[j].scene.prev_frame,
                           want[j][1].scene.prev_frame)
    assert d.blocks == 3 * len(videos[0]) and d.passes <= d.blocks
    assert d.pass_age_s() == 0.0
    d.stop()


def test_failing_block_fails_only_its_own_future():
    model = _model()
    d = SharedBlockDispatcher(model, max_bucket=4)
    good = _video(4)[:T]
    bad_carry = FingerprintCarry(scene=SceneCarry(
        prev_frame=torch.zeros((H + 1, W)), prev_mafd=torch.zeros(()),
        has_prev=torch.ones((), dtype=torch.bool)))
    futs = [d.submit(good, model.init_carry(), T),
            d.submit(good, bad_carry, T),
            d.submit(good, model.init_carry(), T - 3)]
    d.start()
    with pytest.raises(RuntimeError):
        futs[1].result(timeout=30)
    for f, vt in ((futs[0], None), (futs[2], T - 3)):
        scores, fps, carry = f.result(timeout=30)
        s1, f1, c1 = model.forward(torch.from_numpy(good), model.init_carry(),
                                   valid_t=vt)
        np.testing.assert_array_equal(scores, s1.numpy())
        np.testing.assert_array_equal(fps, phash.words_to_numpy(f1))
        assert torch.equal(carry.scene.prev_frame, c1.scene.prev_frame)
    # The failed batch was re-run block by block; the worker still serves.
    assert d.blocks == 2
    assert d.submit(good, model.init_carry(), T).result(timeout=30)[1].shape == (T, 2)
    d.stop()


def test_stop_fails_queued_and_later_submissions():
    model = _model()
    d = SharedBlockDispatcher(model)
    block = _video(5)[:T]
    queued = [d.submit(block, model.init_carry(), T) for _ in range(3)]
    d.stop()
    for f in queued:
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        d.submit(block, model.init_carry(), T).result(timeout=5)
    started = SharedBlockDispatcher(model).start()
    started.stop()
    assert not started._thread.is_alive()


def test_window_clamp_and_warm():
    model = _model()
    assert SharedBlockDispatcher(model, dispatcher_window_s=5.0).dispatcher_window_s == 1.0
    assert SharedBlockDispatcher(model, dispatcher_window_s=-1).dispatcher_window_s == 0.0
    assert [_bucket(k) for k in (1, 2, 3, 4, 5)] == [1, 2, 4, 4, 8]
    calls = []
    forward_streams = model.forward_streams
    model.forward_streams = lambda *a: calls.append(len(a[0])) or forward_streams(*a)
    SharedBlockDispatcher(model, max_bucket=4).warm()
    assert calls == [1, 2, 4]
