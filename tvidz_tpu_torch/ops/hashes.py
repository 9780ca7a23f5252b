"""The perceptual-hash families beside the default 64-bit DCT pHash —
plain PyTorch.

Port of ``tvidz_tpu/ops/hashes.py``. Every family gives packed words in the
Hamming kernels' and the corpus' layout (int32 bit-views of the reference's
uint32 words):

- ``ahash``: 8x8 area resize, strictly above the mean. 64 bits.
- ``dhash``: 8x9 area resize, the sign of the horizontal gradient. 64 bits.
- ``phash``: the DCT hash of ``ops/phash`` (32x32, low 8x8). 64 bits.
- ``phash256``: 64x64 resize, low 16x16 DCT block. 256 bits (8 words), for
  fewer random collisions in corpora of 1M+ fingerprints.

The reference computes these in XLA, not in Pallas, so they are plain
torch here, float32 with TF32 off (median- and mean-adjacent bits flip under
reduced precision). ``golden_*`` are the NumPy specs.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from tvidz_tpu_torch.ops import golden
from tvidz_tpu_torch.ops.phash import hash_operators, pack_bits_i32, phash_batched
from tvidz_tpu_torch.ops.resize import resize_matrices

# -- golden models -------------------------------------------------------------


def golden_ahash(luma: np.ndarray) -> np.ndarray:
    small = golden.area_resize(np.asarray(luma, np.float32), 8, 8)
    bits = (small > small.mean()).astype(np.uint8).reshape(-1)
    return golden.pack_bits(bits)


def golden_dhash(luma: np.ndarray) -> np.ndarray:
    small = golden.area_resize(np.asarray(luma, np.float32), 8, 9)
    bits = (small[:, 1:] > small[:, :-1]).astype(np.uint8).reshape(-1)
    return golden.pack_bits(bits)


def golden_phash256(luma: np.ndarray) -> np.ndarray:
    return golden.phash(luma, dct_size=64, hash_size=16)


# -- batched PyTorch versions --------------------------------------------------


def _resized(luma: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    _, h, w = luma.shape
    ph, pw = resize_matrices(h, w, dst_h, dst_w, luma.device)
    return torch.einsum("hH,tHW,wW->thw", ph, luma.to(torch.float32), pw)


def ahash_batched(luma: torch.Tensor) -> torch.Tensor:
    """(T, H, W) -> (T, 2) int32 average hash."""
    flat = _resized(luma, 8, 8).reshape(luma.shape[0], 64)
    mean = torch.mean(flat, dim=1, keepdim=True)
    return pack_bits_i32((flat > mean).to(torch.int32))


def dhash_batched(luma: torch.Tensor) -> torch.Tensor:
    """(T, H, W) -> (T, 2) int32 difference hash (horizontal gradient)."""
    small = _resized(luma, 8, 9)
    bits = (small[:, :, 1:] > small[:, :, :-1]).to(torch.int32)
    return pack_bits_i32(bits.reshape(luma.shape[0], 64))


def phash_family(luma: torch.Tensor, dct_size: int, hash_size: int) -> torch.Tensor:
    """(T, H, W) -> (T, hash_size² / 32) int32 DCT hash at any size."""
    _, h, w = luma.shape
    left, right = hash_operators(h, w, luma.device, dct_size, hash_size)
    return phash_batched(luma, left, right)


def phash64_batched(luma: torch.Tensor) -> torch.Tensor:
    return phash_family(luma, 32, 8)


def phash256_batched(luma: torch.Tensor) -> torch.Tensor:
    """(T, H, W) -> (T, 8) int32 256-bit multi-scale DCT hash."""
    return phash_family(luma, 64, 16)


# algorithm name -> (batched fn, words, golden fn)
HASH_REGISTRY: Dict[str, tuple] = {
    "ahash": (ahash_batched, 2, golden_ahash),
    "dhash": (dhash_batched, 2, golden_dhash),
    "phash": (phash64_batched, 2, lambda f: golden.phash(f)),
    "phash256": (phash256_batched, 8, golden_phash256),
}


def get_hash_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in HASH_REGISTRY:
        raise KeyError(f"unknown hash algorithm {name!r}; "
                       f"available: {sorted(HASH_REGISTRY)}")
    return HASH_REGISTRY[name][0]


def hash_words(name: str) -> int:
    return HASH_REGISTRY[name][1]
