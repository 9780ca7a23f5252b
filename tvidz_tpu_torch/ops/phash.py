"""Batched DCT perceptual hash — plain PyTorch version.

Port of ``tvidz_tpu/ops/phash.py`` (spec: ``golden.phash``): area-resize
luma to (S, S), 2-D orthonormal DCT-II, keep the low (h, h) block,
threshold strictly above its median, pack bits MSB-first into 32-bit words.

Resize and DCT fold into two per-side operators ``(D·P_h)[:h]`` (h, H) and
``(D·P_w)[:h]`` (h, W), built on the host in float64 from the golden
matrices and cast to float32 once — a device-side fold would round the
operator and flip median-adjacent bits. The fingerprint-block kernel
(ops/fused.py) consumes the same two operators.

Packed words are int32 bit-views of the reference's uint32 words on the
device (``torch.uint32`` has partial op support); the host boundary views
them back as ``np.uint32``.

The coefficient split (``PipelineConfig.ship_dct_coeffs``, the reference's
``phash_project_host`` / ``phash_from_coeffs_batched``): the host computes
each frame's low DCT coefficients in numpy with the golden model's own
dtypes and order of operations (bit-exact to ``golden.phash`` by
construction), and the device runs only the median threshold and pack —
K1's ``tvz_median_pack`` entry on CUDA at hash_size 8
(``ops/fused.median_pack_cuda``), the plain version otherwise.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from tvidz_tpu_torch.ops import golden


@functools.lru_cache(maxsize=8)
def hash_operators_np(height: int, width: int, dct_size: int = 32,
                      hash_size: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """((hash_size, H), (hash_size, W)) float32 folded resize+DCT operators
    (the same construction as tvidz_tpu/ops/phash.py:66-70)."""
    if hash_size > dct_size:
        raise ValueError(f"hash_size {hash_size} > dct_size {dct_size}")
    d64 = np.asarray(golden.dct_matrix(dct_size), np.float64)
    ph = np.asarray(golden.area_resize_matrix(height, dct_size), np.float64)
    pw = np.asarray(golden.area_resize_matrix(width, dct_size), np.float64)
    left = (d64 @ ph)[:hash_size].astype(np.float32)
    right = (d64 @ pw)[:hash_size].astype(np.float32)
    left.setflags(write=False)
    right.setflags(write=False)
    return left, right


def hash_operators(height: int, width: int, device: torch.device,
                   dct_size: int = 32, hash_size: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    left, right = hash_operators_np(height, width, dct_size, hash_size)
    return (torch.tensor(left, device=device),
            torch.tensor(right, device=device))


def median_threshold_bits(low: torch.Tensor, hash_size: int) -> torch.Tensor:
    """(N, hash_size²) float32 -> (N, hash_size²) {0,1} int32: strictly
    above the median, the mean of order statistics k-1 and k (0-based,
    k = hash_size²/2) — np.median's value for an even count."""
    srt, _ = torch.sort(low, dim=-1)
    k = hash_size * hash_size // 2
    med = (srt[:, k - 1] + srt[:, k]) * 0.5
    return (low > med[:, None]).to(torch.int32)


def pack_bits_i32(bits: torch.Tensor) -> torch.Tensor:
    """(..., n_bits) {0,1} -> (..., n_bits/32) int32 bit-views of the
    MSB-first uint32 words (golden.pack_bits order)."""
    *lead, n = bits.shape
    if n % 32:
        raise ValueError(f"{n} bits is not a multiple of 32")
    words = bits.reshape(*lead, n // 32, 32).to(torch.int64)
    shifts = 31 - torch.arange(32, dtype=torch.int64, device=bits.device)
    u = torch.sum(words << shifts, dim=-1)
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def low_coefficients(luma: torch.Tensor, left: torch.Tensor,
                     right: torch.Tensor) -> torch.Tensor:
    """(T, H, W) luma -> (T, h²) float32 low-frequency DCT coefficients,
    ``left · X · rightᵀ`` per frame in float32 (TF32 off, see backend)."""
    x = luma.to(torch.float32)
    low = torch.einsum("sh,thw,rw->tsr", left, x, right)
    return low.reshape(x.shape[0], -1)


def phash_bits_batched(luma: torch.Tensor, dct_size: int = 32,
                       hash_size: int = 8) -> torch.Tensor:
    """(T, H, W) luma -> (T, hash_size²) {0,1} int32 bits, on ``luma``'s
    device (tvidz_tpu/ops/phash.py:34). hash_size² must be a multiple of
    32 and hash_size at most dct_size; anything else is rejected up front."""
    if (hash_size * hash_size) % 32:
        raise ValueError(f"hash_size={hash_size} gives {hash_size ** 2} "
                         "bits, not a multiple of 32; supported sizes: 8 "
                         "(64-bit), 16 (256-bit)")
    _, h, w = luma.shape
    left, right = hash_operators(h, w, luma.device, dct_size, hash_size)
    return median_threshold_bits(low_coefficients(luma, left, right), hash_size)


def phash_batched(luma: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor) -> torch.Tensor:
    """(T, H, W) luma -> (T, words) int32 packed fingerprints."""
    hash_size = left.shape[0]
    if (hash_size * hash_size) % 32:
        raise ValueError(f"hash_size={hash_size} gives {hash_size ** 2} "
                         "bits, not a multiple of 32")
    low = low_coefficients(luma, left, right)
    return pack_bits_i32(median_threshold_bits(low, hash_size))


_PROJECT_CACHE: dict = {}


def _project_operators_np(h: int, w: int, dct_size: int):
    """The golden model's own resize and DCT matrices (area_resize_matrix
    float32, dct_matrix float32 cast to float64: exactly its dtypes), cached
    per geometry (tvidz_tpu/ops/phash.py:129)."""
    key = (h, w, dct_size)
    ops = _PROJECT_CACHE.get(key)
    if ops is None:
        ph = golden.area_resize_matrix(h, dct_size)            # f32
        pw = golden.area_resize_matrix(w, dct_size)            # f32
        d64 = golden.dct_matrix(dct_size).astype(np.float64)   # f32 -> f64
        ops = _PROJECT_CACHE[key] = (ph, pw, d64)
    return ops


def phash_project_host(luma: np.ndarray, dct_size: int = 32,
                       hash_size: int = 8) -> np.ndarray:
    """(T, H, W) uint8/float luma -> (T, hash_size²) float32 low-frequency
    DCT coefficients on the host (tvidz_tpu/ops/phash.py:145): per frame
    golden.area_resize in float32, ``(ph @ x) @ pw.T``, then golden.dct2 in
    float64, ``(d @ small) @ d.T``, cast to float32 — the golden sequence,
    so the packed bits equal ``golden.phash``."""
    t, h, w = luma.shape
    ph, pw, d64 = _project_operators_np(h, w, dct_size)
    x32 = np.asarray(luma, np.float32)
    out = np.empty((t, hash_size * hash_size), np.float32)
    for i in range(t):
        small = (ph @ x32[i]) @ pw.T                         # golden.area_resize
        coeffs = (d64 @ small.astype(np.float64)) @ d64.T    # golden.dct2
        out[i] = coeffs.astype(np.float32)[:hash_size, :hash_size].ravel()
    return out


def phash_from_coeffs_plain(low: torch.Tensor, hash_size: int = 8
                            ) -> torch.Tensor:
    """Plain version of the coefficient tail: (N, hash_size²) float32 ->
    (N, words) int32, median threshold and MSB-first pack."""
    return pack_bits_i32(median_threshold_bits(low, hash_size))


def phash_from_coeffs_batched(low: torch.Tensor, hash_size: int = 8
                              ) -> torch.Tensor:
    """(N, hash_size²) float32 projected coefficients -> (N, words) int32
    (tvidz_tpu/ops/phash.py:171): on a CUDA tensor at hash_size 8 one launch
    of K1's median-pack entry, else ``phash_from_coeffs_plain`` (the
    reference's XLA tail, plain torch on either device)."""
    if low.ndim != 2 or low.shape[1] != hash_size * hash_size:
        raise ValueError(f"coefficients must be (N, {hash_size * hash_size}), "
                         f"got {tuple(low.shape)}")
    if low.is_cuda and hash_size == 8:
        from tvidz_tpu_torch.ops.fused import median_pack_cuda

        return median_pack_cuda(low.contiguous())
    return phash_from_coeffs_plain(low, hash_size)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Device int32 words -> host np.uint32 (the store's and mirrors' type)."""
    return np.ascontiguousarray(words.detach().cpu().numpy()).view(np.uint32)
