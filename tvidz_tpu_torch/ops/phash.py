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
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from tvidz_tpu_torch._reference import golden


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


def phash_batched(luma: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor) -> torch.Tensor:
    """(T, H, W) luma -> (T, words) int32 packed fingerprints."""
    hash_size = left.shape[0]
    if (hash_size * hash_size) % 32:
        raise ValueError(f"hash_size={hash_size} gives {hash_size ** 2} "
                         "bits, not a multiple of 32")
    low = low_coefficients(luma, left, right)
    return pack_bits_i32(median_threshold_bits(low, hash_size))


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Device int32 words -> host np.uint32 (the store's and mirrors' type)."""
    return np.ascontiguousarray(words.detach().cpu().numpy()).view(np.uint32)
