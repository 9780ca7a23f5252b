"""Port parity: the hash families (ops/hashes.py, ops/resize.py, ops/dct.py)
and the fused block under them.

Mirrors tests/test_ops_hashes.py: the same seeded frames go through the JAX
package's batched hashes (XLA) and the port's plain-torch ones, and both
are held to the golden NumPy models within max(2, words) bits (float32 sums
in another order flip median- or mean-adjacent bits); resize and DCT within
float32 rounding; scene scores within 1e-6 of XLA's, and exactly equal
between the port's own paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.ops import dct as jax_dct
from tvidz_tpu.ops import fused as jax_fused
from tvidz_tpu.ops import hashes as jax_hashes
from tvidz_tpu.ops import resize as jax_resize
from tvidz_tpu_torch import config
from tvidz_tpu_torch.ops import dct, fused, golden, hashes, resize

CPU = torch.device("cpu")


def _frames(rng, n=5, h=90, w=160):
    """Structured content (a block grid), as the reference's hash tests."""
    g = rng.integers(0, 256, size=(n, -(-h // 8), -(-w // 8))).astype(np.float32)
    return np.kron(g, np.ones((1, 8, 8))).astype(np.uint8)[:, :h, :w]


def _bits(a, b):
    """Differing bits per frame between two (T, words) uint32 arrays."""
    x = np.ascontiguousarray(a, np.uint32) ^ np.ascontiguousarray(b, np.uint32)
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


@pytest.mark.parametrize("name", ["ahash", "dhash", "phash", "phash256"])
@pytest.mark.parametrize("h,w", [(90, 160), (33, 47)])
def test_family_matches_jax_and_golden(rng, name, h, w):
    frames = _frames(rng, h=h, w=w)
    words = hashes.hash_words(name)
    got = hashes.get_hash_fn(name)(torch.from_numpy(frames)).numpy().view(np.uint32)
    assert got.shape == (frames.shape[0], words)
    ref = np.asarray(jax_hashes.get_hash_fn(name)(jnp.asarray(frames)))
    want = np.stack([hashes.HASH_REGISTRY[name][2](f) for f in frames])
    tol = max(2, words)
    assert _bits(got, ref).max() <= tol
    assert _bits(got, want).max() <= tol


@pytest.mark.parametrize("hash_size", [8, 16])
def test_phash_bits_batched_matches_jax(rng, hash_size):
    """The reference's bit-level entry point: the same bits as the JAX
    package's within 2 a frame, and its sizes checked up front."""
    from tvidz_tpu.ops import phash as jax_phash
    from tvidz_tpu_torch.ops import phash

    frames = _frames(rng)
    got = phash.phash_bits_batched(torch.from_numpy(frames), hash_size=hash_size)
    want = np.asarray(jax_phash.phash_bits_batched(jnp.asarray(frames),
                                                   hash_size=hash_size))
    assert got.shape == want.shape == (frames.shape[0], hash_size ** 2)
    assert np.abs(got.numpy() - want).sum(axis=1).max() <= 2
    for kw in ({"hash_size": 12}, {"dct_size": 8, "hash_size": 16}):
        with pytest.raises(ValueError):
            phash.phash_bits_batched(torch.from_numpy(frames), **kw)


def test_golden_models_are_the_references():
    rng = np.random.default_rng(3)
    frames = _frames(rng, n=3)
    for name in ("ahash", "dhash", "phash256"):
        for f in frames:
            np.testing.assert_array_equal(
                hashes.HASH_REGISTRY[name][2](f),
                jax_hashes.HASH_REGISTRY[name][2](f))


def test_registry_and_config_words():
    assert set(hashes.HASH_REGISTRY) == {"ahash", "dhash", "phash", "phash256"}
    assert hashes.hash_words("phash256") == 8 and hashes.hash_words("phash") == 2
    assert config.HASH_WORDS == {k: v[1] for k, v in hashes.HASH_REGISTRY.items()}
    assert config.HASH_WORDS == {k: v[1] for k, v in jax_hashes.HASH_REGISTRY.items()}
    with pytest.raises(KeyError):
        hashes.get_hash_fn("nope")


def test_dhash_brightness_invariance(rng):
    frames = _frames(rng, n=1)
    bright = np.clip(frames.astype(np.int32) + 40, 0, 255).astype(np.uint8)
    h1 = hashes.dhash_batched(torch.from_numpy(frames)).numpy().view(np.uint32)
    h2 = hashes.dhash_batched(torch.from_numpy(bright)).numpy().view(np.uint32)
    assert _bits(h1, h2)[0] <= 6


@pytest.mark.parametrize("src,dst", [((90, 160), (8, 9)), ((33, 47), (64, 64)),
                                     ((91, 163), (32, 32))])
def test_area_resize_matches_jax(rng, src, dst):
    x = rng.integers(0, 256, size=(3, *src)).astype(np.float32)
    got = resize.area_resize_batched(torch.from_numpy(x), *dst).numpy()
    want = np.asarray(jax_resize.area_resize_batched(jnp.asarray(x), *dst))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got[0], golden.area_resize(x[0], *dst),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n", [8, 32, 64])
def test_dct2_matches_jax(rng, n):
    x = rng.uniform(0, 255, size=(2, n, n)).astype(np.float32)
    got = dct.dct2_batched(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_dct.dct2_batched(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got[1], golden.dct2(x[1]), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("algorithm,hash_size,words",
                         [("phash256", 8, 8), ("dhash", 8, 2), ("ahash", 8, 2),
                          ("phash", 16, 8)])
def test_fused_block_under_a_family(rng, algorithm, hash_size, words):
    """``fingerprint_block`` under a configuration K1 does not compute:
    the family's hashes, the same scene scores as the reference's block
    and as the default configuration, and no K1 plain version on the way."""
    frames = _frames(rng, n=8)
    h, w = frames.shape[1:]
    x = torch.from_numpy(frames)
    assert not fused.uses_k1(algorithm, hash_size)
    sc, fp, carry = fused.fingerprint_block(
        x, fused.initial_fingerprint_carry(h, w, CPU), algorithm=algorithm,
        hash_size=hash_size, dct_size=32)
    assert fp.shape == (8, words) and fp.dtype == torch.int32
    jsc, jfp, _ = jax_fused.fingerprint_block(
        jnp.asarray(frames), jax_fused.initial_fingerprint_carry(h, w),
        algorithm=algorithm, hash_size=hash_size)
    # XLA's mean and torch's may round one ulp apart (tests/test_torch_fused.py).
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=0, atol=1e-6)
    assert _bits(fp.numpy().view(np.uint32), np.asarray(jfp)).max() <= max(2, words)
    dsc, _, _ = fused.fingerprint_block(
        x, fused.initial_fingerprint_carry(h, w, CPU))
    np.testing.assert_array_equal(sc.numpy(), dsc.numpy())
    assert bool(carry.scene.has_prev)


def test_family_batch_equals_lone_blocks(rng, monkeypatch):
    """The dispatcher's pass under phash256: scene scores over the K streams
    at once equal each stream's own block, carries included; hashes equal
    (the CPU's products do not depend on the batch); never K1's plain
    version."""
    monkeypatch.setattr(fused, "fingerprint_block_plain", None)
    monkeypatch.setattr(fused, "fingerprint_blocks_batched_plain", None)
    k, t, h, w = 3, 16, 36, 64
    lumas = [torch.from_numpy(rng.integers(0, 256, size=(t, h, w), dtype=np.uint8))
             for _ in range(k)]
    carries = [fused.initial_fingerprint_carry(h, w, CPU)]
    _, _, mid = fused.fingerprint_block(lumas[0], carries[0], algorithm="phash256")
    carries += [mid, mid]
    valid = [t, 5, 11]
    sb, fb, cb = fused.fingerprint_blocks_batched(lumas, carries, valid,
                                                  algorithm="phash256")
    assert sb.shape == (k, t) and fb.shape == (k, t, 8)
    for j in range(k):
        s1, f1, c1 = fused.fingerprint_block(lumas[j], carries[j], valid_t=valid[j],
                                             algorithm="phash256")
        assert torch.equal(sb[j], s1) and torch.equal(fb[j], f1)
        assert all(torch.equal(a, b) for a, b in zip(cb[j].scene, c1.scene))
