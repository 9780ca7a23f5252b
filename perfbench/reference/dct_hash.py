"""The DCT pHash at any (dct, keep), from its definition: the 64-bit pHash
of ``video`` at (32, 8), the 256-bit ``phash256`` at (64, 16).

Area-resize the frame to dct×dct, orthonormal 2-D DCT-II, keep the top-left
keep×keep block (DC included); a bit is 1 where a coefficient is strictly
above the block's median, the mean of its order statistics keep²/2 − 1 and
keep²/2 (0-based); bits row-major, packed most significant first into
keep²/32 32-bit words. Float32 with TF32 off, as the configuration states.

Departures from ``golden.phash``'s definition, each also ``video.phash``'s:

- the resize and the DCT fold into one operator a side, ``(D·P)[:keep]``,
  built in float64 from exact matrices and used in float32, where golden
  resizes in float32 and transforms the whole dct×dct block in float64;
- the two products run in float32 on the frame's device, the rows of the
  left operator first, in the order the matrix product sums;
- the median is ``(a + b) · 0.5`` of the two middle coefficients in
  float32.

A bit whose coefficient lies within rounding of the median can therefore
differ from golden's, and from the program's, which folds its operators from
golden's float32 matrices.

``phash(..., tf32=True)`` is the control: every operand rounded to TF32
(``video.to_tf32``), as the tensor cores do with TF32 on.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.video import operators, to_tf32


def phash(luma: torch.Tensor, dct: int, keep: int, tf32: bool = False,
          block: int = 4096) -> np.ndarray:
    """(T, H, W) uint8 luma -> (T, keep²/32) uint32 DCT pHashes."""
    if keep > dct or (keep * keep) % 32:
        raise ValueError(f"keep {keep} at dct {dct}: need keep <= dct and "
                         "keep² a multiple of 32")
    torch.backends.cuda.matmul.allow_tf32 = False
    t, h, w = luma.shape
    n, words = keep * keep, keep * keep // 32
    left_np, right_np = operators(h, w, dct, keep)
    dev = luma.device
    left = torch.tensor(left_np, device=dev)
    right = torch.tensor(right_np, device=dev)
    rnd = to_tf32 if tf32 else (lambda z: z)
    shifts = 31 - torch.arange(32, device=dev)
    out = []
    for s in range(0, t, block):
        x = luma[s:s + block].to(torch.float32)
        a = torch.matmul(rnd(left), rnd(x))                  # (b, keep, W)
        low = torch.matmul(rnd(a), rnd(right).T).reshape(-1, n)
        srt = torch.sort(low, dim=1).values
        med = (srt[:, n // 2 - 1] + srt[:, n // 2]) * 0.5
        bits = (low > med[:, None]).to(torch.int64).reshape(-1, words, 32)
        out.append((bits << shifts).sum(-1).cpu().numpy().astype(np.uint32))
    return np.concatenate(out) if out else np.zeros((0, words), np.uint32)
