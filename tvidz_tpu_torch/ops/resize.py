"""Exact area-average resize as two matrix products — plain PyTorch.

Port of ``tvidz_tpu/ops/resize.py``: arbitrary (H, W) -> (h, w) through the
overlap-weight matrices ``P_h (h, H)`` and ``P_w (w, W)`` of the golden
model (``golden.area_resize_matrix``), ``Y = P_h @ X @ P_w^T`` batched over
frames in float32 with TF32 off (``backend.set_full_precision``): the
hashes built on it threshold the result, and reduced precision flips bits.
The reference computes this in XLA, not in Pallas, so there is no kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from tvidz_tpu_torch.ops import golden


@functools.lru_cache(maxsize=64)
def _resize_matrices_np(src_h: int, src_w: int, dst_h: int, dst_w: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    return (golden.area_resize_matrix(src_h, dst_h),
            golden.area_resize_matrix(src_w, dst_w))


def resize_matrices(src_h: int, src_w: int, dst_h: int, dst_w: int,
                    device: torch.device = torch.device("cpu")
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((dst_h, src_h), (dst_w, src_w)) float32 area-resize matrices."""
    ph, pw = _resize_matrices_np(src_h, src_w, dst_h, dst_w)
    return (torch.tensor(ph, dtype=torch.float32, device=device),
            torch.tensor(pw, dtype=torch.float32, device=device))


def area_resize_batched(x: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """(..., H, W) -> (..., dst_h, dst_w) exact area average, float32."""
    ph, pw = resize_matrices(x.shape[-2], x.shape[-1], dst_h, dst_w, x.device)
    return torch.einsum("hH,...HW,wW->...hw", ph, x.to(torch.float32), pw)
