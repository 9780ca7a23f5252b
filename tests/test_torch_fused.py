"""Port parity: the fingerprint block (scene scores + 64-bit pHash).

The same seeded numpy inputs go through the JAX package and the port's
plain PyTorch version (what the fingerprint-block kernel is checked
against on the card). Tolerances:
- scene scores <= 1e-6 abs — mafd sums are integer-exact in f32, so they
  are expected bit-equal;
- hashes from luma within 2 differing bits per frame (the repo's bar,
  tests/test_ops_phash.py) — the f32 projection sums run in another order;
- median threshold + pack from identical coefficients: bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.decode.synthetic import synthetic_video
from tvidz_tpu.ops import golden
from tvidz_tpu.ops.fused import fingerprint_block as jax_fingerprint_block
from tvidz_tpu.ops.fused import initial_fingerprint_carry as jax_initial_carry
from tvidz_tpu.ops.fused_pallas import fingerprint_stream_pallas
from tvidz_tpu.ops.phash import _median_threshold_bits, _pack_bits_u32
from tvidz_tpu_torch import state
from tvidz_tpu_torch.ops import fused, phash

CPU = torch.device("cpu")
T, H, W = 16, 36, 64
SCORE_TOL = 1e-6
HASH_BITS = 2


def _bit_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(a, np.uint32) ^ np.ascontiguousarray(b, np.uint32)
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _content(kind: str, n: int, h: int, w: int) -> np.ndarray:
    if kind == "random":
        return np.random.default_rng(11).integers(
            0, 256, size=(n, h, w), dtype=np.uint8)
    luma, _ = synthetic_video(n, h, w, cut_frames=(5, 23, 40), seed=11)
    return luma


@pytest.mark.parametrize("kind", ["random", "synthetic"])
def test_fingerprint_block_matches_jax_over_chained_blocks(kind):
    """3 chained full blocks, then a short block padded with its last frame
    and passed valid_t — scores, hashes and the carry match the JAX op."""
    luma = _content(kind, 3 * T + 5, H, W)
    left, right = phash.hash_operators(H, W, CPU)
    jc = jax_initial_carry(H, W)
    tc = fused.initial_fingerprint_carry(H, W, CPU)
    for s in range(0, luma.shape[0], T):
        blk = luma[s:s + T]
        t = blk.shape[0]
        if t < T:
            blk = np.concatenate([blk, np.repeat(blk[-1:], T - t, axis=0)])
        vt = t if t < T else None
        js, jf, jc = jax_fingerprint_block(
            jnp.asarray(blk), jc, valid_t=None if vt is None else jnp.int32(vt))
        ts, tf, tc = fused.fingerprint_block(torch.from_numpy(blk), tc, left,
                                             right, valid_t=vt)
        np.testing.assert_allclose(ts.numpy()[:t], np.asarray(js)[:t],
                                   rtol=0, atol=SCORE_TOL)
        diff = _bit_diff(phash.words_to_numpy(tf[:t]), np.asarray(jf)[:t])
        assert diff.max() <= HASH_BITS, diff
        np.testing.assert_array_equal(tc.scene.prev_frame.numpy(),
                                      np.asarray(jc.scene.prev_frame))
        assert abs(tc.scene.prev_mafd.item()
                   - float(jc.scene.prev_mafd)) <= SCORE_TOL
        assert bool(tc.scene.has_prev) and bool(jc.scene.has_prev)


def test_carry_from_numpy_continues_a_jax_stream():
    """A JAX carry handed across (state.fingerprint_carry_from_numpy) scores
    the next block like the JAX op does."""
    luma = _content("synthetic", 2 * T, H, W)
    _, _, jc = jax_fingerprint_block(jnp.asarray(luma[:T]), jax_initial_carry(H, W))
    tc = state.fingerprint_carry_from_numpy(
        np.asarray(jc.scene.prev_frame), np.asarray(jc.scene.prev_mafd),
        np.asarray(jc.scene.has_prev), CPU)
    js, _, _ = jax_fingerprint_block(jnp.asarray(luma[T:]), jc)
    left, right = phash.hash_operators(H, W, CPU)
    ts, _, _ = fused.fingerprint_block(torch.from_numpy(luma[T:]), tc, left, right)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=SCORE_TOL)


def test_scores_match_pallas_interpret_and_golden():
    """Whole-stream scores through the port's blocks equal the Pallas fused
    kernel (interpret mode) and the golden model."""
    n, h, w, bt = 24, 16, 32, 8
    luma = _content("synthetic", n, h, w)
    left, right = phash.hash_operators(h, w, CPU)
    carry = fused.initial_fingerprint_carry(h, w, CPU)
    got = []
    for s in range(0, n, bt):
        sc, _, carry = fused.fingerprint_block(
            torch.from_numpy(luma[s:s + bt]), carry, left, right)
        got.append(sc.numpy())
    got = np.concatenate(got)
    pallas_scores, _ = fingerprint_stream_pallas(jnp.asarray(luma), block_frames=bt)
    np.testing.assert_allclose(got, np.asarray(pallas_scores), rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(got, golden.scene_scores(luma), rtol=0,
                               atol=SCORE_TOL)


def test_hashes_match_golden():
    luma = _content("random", 6, 90, 160)
    left, right = phash.hash_operators(90, 160, CPU)
    got = phash.words_to_numpy(phash.phash_batched(torch.from_numpy(luma),
                                                   left, right))
    want = np.stack([golden.phash(f) for f in luma])
    assert _bit_diff(got, want).max() <= HASH_BITS


@pytest.mark.parametrize("pattern", ["quantized", "median_pair_tied",
                                     "all_equal", "continuous"])
def test_median_pack_bit_exact_vs_jax(pattern):
    rng = np.random.default_rng(5)
    low = rng.normal(0, 50, size=(64, 64)).astype(np.float32)
    if pattern == "quantized":             # many ties everywhere
        low = np.round(low / 40).astype(np.float32)
    elif pattern == "median_pair_tied":    # order stats 31 and 32 equal
        srt = np.sort(low, axis=1)
        low = np.where(low == srt[:, 32:33], srt[:, 31:32], low)
    elif pattern == "all_equal":
        low[:] = 3.0
    want = np.asarray(_pack_bits_u32(_median_threshold_bits(jnp.asarray(low), 8)))
    got = phash.pack_bits_i32(phash.median_threshold_bits(torch.from_numpy(low), 8))
    np.testing.assert_array_equal(phash.words_to_numpy(got), want)


def test_pack_bits_msb_first_matches_golden():
    bits = np.zeros((1, 64), np.int32)
    bits[0, [0, 33, 63]] = 1
    got = phash.words_to_numpy(phash.pack_bits_i32(torch.from_numpy(bits)))
    np.testing.assert_array_equal(got[0], golden.pack_bits(bits[0]))


def test_valid_t_out_of_range_raises():
    left, right = phash.hash_operators(H, W, CPU)
    carry = fused.initial_fingerprint_carry(H, W, CPU)
    x = torch.zeros((T, H, W), dtype=torch.uint8)
    for bad in (0, T + 1):
        with pytest.raises(ValueError):
            fused.fingerprint_block(x, carry, left, right, valid_t=bad)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor runs the plain version; any other device launches
    the kernel (CUDA) or raises."""
    left, right = phash.hash_operators(H, W, CPU)
    carry = fused.initial_fingerprint_carry(H, W, CPU)
    x = torch.zeros((T, H, W), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fingerprint_block(x, carry, left, right)
