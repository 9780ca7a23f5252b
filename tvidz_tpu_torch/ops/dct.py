"""Orthonormal 2-D DCT-II as two matrix products — plain PyTorch.

Port of ``tvidz_tpu/ops/dct.py`` (spec: ``golden.dct_matrix`` /
``golden.dct2``): ``D @ X @ D^T`` batched over frames in float32 with TF32
off. The reference computes this in XLA, not in Pallas.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tvidz_tpu_torch.ops import golden


@functools.lru_cache(maxsize=8)
def _dct_matrix_np(n: int) -> np.ndarray:
    return golden.dct_matrix(n)


def dct_matrix(n: int, device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(n, n) float32 orthonormal DCT-II basis."""
    return torch.tensor(_dct_matrix_np(n), dtype=torch.float32, device=device)


def dct2_batched(x: torch.Tensor) -> torch.Tensor:
    """2-D DCT-II over the last two dims of (..., N, N), float32."""
    d = dct_matrix(x.shape[-1], x.device)
    return torch.einsum("kn,...nm,lm->...kl", d, x.to(torch.float32), d)
