"""Port parity: coefficient shipping (``PipelineConfig.ship_dct_coeffs``).

Mirrors tests/test_ship_coeffs.py on the port, and holds it against the JAX
package with the same seeded numpy inputs: the host projection equals the
reference's ``phash_project_host`` exactly (numpy, the golden sequence) and
its hashes equal ``golden.phash``; the coefficient tail equals the
reference's ``phash_from_coeffs_batched``, median ties included; whole
analyses in coefficient mode equal the luma mode and the JAX package's
coefficient mode (cuts equal, fingerprints equal: the projection is
bit-exact in both packages, so no bit may differ). Scores in this mode are
zeros on the device and come from the host (tolerance: exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.config import Config as JaxConfig
from tvidz_tpu.models.fingerprint import FingerprintModel as JaxModel
from tvidz_tpu.ops import phash as jax_phash
from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.decode import synthetic_video, write_y4m
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.ops import fused, golden, phash


def _cfg(ship=True, cls=Config):
    cfg = cls()
    cfg.pipeline.block_frames = 32
    cfg.pipeline.scene_height = 72
    cfg.pipeline.scene_width = 96
    cfg.pipeline.ship_dct_coeffs = ship
    return cfg


def _model(ship=True, **over):
    cfg = _cfg(ship)
    for k, v in over.items():
        setattr(cfg.pipeline, k, v)
    return FingerprintModel(cfg, device="cpu")


def _words(t):
    return t.numpy().view(np.uint32)


def test_projection_matches_reference_and_golden():
    """Host projection == the reference's, bit for bit; projection + tail
    == golden.phash."""
    rng = np.random.default_rng(7)
    luma = rng.integers(0, 256, (24, 72, 96), dtype=np.uint8)
    coeffs = phash.phash_project_host(luma)
    assert coeffs.shape == (24, 64) and coeffs.dtype == np.float32
    np.testing.assert_array_equal(coeffs, jax_phash.phash_project_host(luma))
    got = _words(phash.phash_from_coeffs_batched(torch.from_numpy(coeffs)))
    np.testing.assert_array_equal(got, np.stack([golden.phash(f) for f in luma]))


@pytest.mark.parametrize("hash_size,dct_size", [(8, 32), (16, 32), (8, 16)])
def test_coeff_tail_matches_reference_with_ties(hash_size, dct_size):
    """The median threshold + pack equals the reference's tail, on real
    projections and on rows with planted median ties (equal middle order
    statistics, values equal to the median)."""
    rng = np.random.default_rng(8 + hash_size)
    luma = rng.integers(0, 256, (6, 40, 56), dtype=np.uint8)
    real = phash.phash_project_host(luma, dct_size, hash_size)
    n = hash_size * hash_size
    ties = rng.integers(-3, 4, size=(8, n)).astype(np.float32)
    ties[0] = 0.0                                   # every value the median
    ties[1, : n // 2 + 1] = 1.5                     # the two middle values tie
    low = np.concatenate([real, ties])
    got = _words(phash.phash_from_coeffs_batched(torch.from_numpy(low), hash_size))
    want = np.asarray(jax_phash.phash_from_coeffs_batched(jnp.asarray(low), hash_size))
    np.testing.assert_array_equal(got, want)
    assert not got[len(real)].any()                 # strictly above the median


def test_projection_linear_in_padding():
    rng = np.random.default_rng(8)
    luma = rng.integers(0, 256, (5, 72, 96), dtype=np.uint8)
    padded = np.concatenate([luma, np.repeat(luma[-1:], 3, axis=0)])
    a = phash.phash_project_host(padded)
    b = phash.phash_project_host(luma)
    np.testing.assert_array_equal(a, np.concatenate([b, np.repeat(b[-1:], 3, axis=0)]))


def test_coeff_forwards_zero_scores_and_pass_the_carry():
    """fingerprint_block(s_batched)_coeffs: zero scores, carries untouched,
    the batched pass equal to the single one; a raw luma block raises with
    the reference's message."""
    model = _model()
    rng = np.random.default_rng(9)
    blocks = [torch.from_numpy(phash.phash_project_host(
        rng.integers(0, 256, (32, 72, 96), dtype=np.uint8))) for _ in range(3)]
    carry = model.init_carry()
    s1, f1, c1 = model.forward(blocks[0], carry)
    assert c1 is carry and not s1.any() and f1.shape == (32, 2)
    scores, fps, carries = model.forward_streams(blocks, [carry] * 3, [32, 32, 7])
    assert scores.shape == (3, 32) and not scores.any()
    assert all(c is carry for c in carries)
    assert torch.equal(fps[0], f1)
    with pytest.raises(ValueError, match="raw luma block passed to a ship_dct_coeffs"):
        model.forward(torch.zeros((32, 72, 96), dtype=torch.uint8), carry)
    with pytest.raises(ValueError, match="raw luma block passed to a ship_dct_coeffs"):
        fused.fingerprint_blocks_batched_coeffs(
            [torch.zeros((32, 72, 96))], [carry], [32])


def test_only_phash_ships_coeffs():
    cfg = _cfg()
    cfg.hash.algorithm = "ahash"
    with pytest.raises(ValueError, match="phash-specific projection"):
        FingerprintModel(cfg, device="cpu")


def test_example_payload_follows_the_mode():
    assert tuple(_model().example_payload().shape) == (32, 64)
    assert _model().example_payload().dtype == torch.float32
    assert tuple(_model(ship=False).example_payload().shape) == (32, 72, 96)


def test_analyze_path_parity_with_luma_mode_and_reference(tmp_path):
    """Same video, coefficient mode against the luma mode and against the
    JAX package's coefficient mode: identical cuts and fingerprints."""
    luma, _ = synthetic_video(num_frames=100, height=72, width=96,
                              cut_frames=(30, 64), seed=11)
    p = str(tmp_path / "v.y4m")
    write_y4m(p, luma, fps=25.0)
    cuts_a, fps_a = _model(ship=False).analyze_path(p)
    cuts_b, fps_b = _model(ship=True).analyze_path(p)
    cuts_j, fps_j = JaxModel(_cfg(True, JaxConfig)).analyze_path(p)
    assert cuts_a == cuts_b == cuts_j
    np.testing.assert_array_equal(fps_b, fps_a)
    np.testing.assert_array_equal(fps_b, fps_j)


def test_analyze_array_host_fallback_scores():
    """No decoder mafd: the scorer's host fallback supplies the scores (the
    device's are zeros), so the planted cut is still found, as in the
    reference's coefficient mode."""
    luma, pts = synthetic_video(num_frames=96, height=72, width=96,
                                cut_frames=(40,), seed=12)
    cuts_a, fps_a = _model(ship=False).analyze_array(luma, pts)
    cuts_b, fps_b = _model(ship=True).analyze_array(luma, pts)
    cuts_j, fps_j = JaxModel(_cfg(True, JaxConfig)).analyze_array(luma, pts)
    assert cuts_b == cuts_a == cuts_j and cuts_b
    np.testing.assert_array_equal(fps_b, fps_a)
    np.testing.assert_array_equal(fps_b, fps_j)


def test_host_fallback_block_boundary_invariance():
    luma, pts = synthetic_video(num_frames=96, height=72, width=96,
                                cut_frames=(20, 50, 70), seed=13)
    ref = None
    for bf in (16, 32, 96):
        cuts, fps = _model(block_frames=bf).analyze_array(luma, pts)
        if ref is None:
            ref = (cuts, fps)
        else:
            assert cuts == ref[0], f"cuts fork at block_frames={bf}"
            np.testing.assert_array_equal(fps, ref[1])


def test_dispatcher_coeff_parity():
    """Coefficient payloads ride the shared dispatcher's pass bit for bit."""
    from tvidz_tpu_torch.pipeline.dispatcher import SharedBlockDispatcher

    luma, pts = synthetic_video(num_frames=64, height=72, width=96,
                                cut_frames=(30,), seed=40)
    cuts_a, fps_a = _model().analyze_array(luma, pts)
    routed = _model()
    disp = SharedBlockDispatcher(routed, max_bucket=2)
    disp.warm()
    disp.start()
    try:
        routed.dispatcher = disp
        cuts_b, fps_b = routed.analyze_array(luma, pts)
    finally:
        routed.dispatcher = None
        disp.stop()
    assert cuts_a == cuts_b and disp.passes >= 2
    np.testing.assert_array_equal(fps_a, fps_b)


def test_multistream_coeff_parity(tmp_path):
    """Multistream in coefficient mode equals each stream's own analysis."""
    from tvidz_tpu_torch.pipeline.multistream import fingerprint_streams

    paths = []
    for i, (frames, cuts) in enumerate([(96, (30, 60)), (64, (20,))]):
        luma, _ = synthetic_video(num_frames=frames, height=72, width=96,
                                  cut_frames=cuts, seed=30 + i)
        paths.append(str(tmp_path / f"c{i}.y4m"))
        write_y4m(paths[-1], luma, fps=25.0)
    results, stats = fingerprint_streams(paths, model=_model(), max_active=2)
    assert stats.frames == 96 + 64
    for r in results:
        assert r.error is None
        want_cuts, want_fps = _model().analyze_path(r.path)
        assert r.scene_cuts == want_cuts
        np.testing.assert_array_equal(r.fingerprints, want_fps)
