"""pHash and scene cuts of uploaded frames, from their definitions.

- Decode: a YUV4MPEG2 frame's luma plane, area-averaged to the scene
  geometry (an exact 2x2 mean at 180x320 -> 90x160, rounded half to even).
- pHash (64-bit DCT): area-resize to 32x32, orthonormal 2-D DCT-II, keep the
  top-left 8x8 block (DC included), a bit is 1 where a coefficient is
  strictly above the block's median (mean of its 32nd and 33rd smallest),
  packed row-major and most significant bit first into 32-bit words. The
  resize and DCT fold into one operator a side, built in float64 and used in
  float32, as the configuration states (TF32 off).
- Scene score (FFmpeg ``select=gt(scene,0.3)``): mafd[t] = mean |luma[t] -
  luma[t-1]| at the decoded resolution (frame 0: 0), score = clip(min(mafd,
  |mafd - mafd[t-1]|) / 100, 0, 1) as float32; a cut where it exceeds the
  threshold, at frame / fps seconds rounded to 6 decimals.

``phash(..., tf32=True)`` is the control: the same arithmetic with every
operand rounded to TF32 (10 mantissa bits, to nearest even), as the tensor
cores do with TF32 on.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def area_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) float64: row d averages the source interval
    [d·src/dst, (d+1)·src/dst) by each sample's overlap with it."""
    m = np.zeros((dst, src))
    step = src / dst
    for d in range(dst):
        lo, hi = d * step, (d + 1) * step
        for s in range(int(math.floor(lo)), min(int(math.ceil(hi)), src)):
            m[d, s] = max(0.0, min(hi, s + 1) - max(lo, s))
    return m / m.sum(axis=1, keepdims=True)


def dct_matrix(n: int) -> np.ndarray:
    """(n, n) float64 orthonormal DCT-II: D[k, i] = s_k cos(pi (2i+1) k / 2n)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d[0] *= math.sqrt(1.0 / n)
    d[1:] *= math.sqrt(2.0 / n)
    return d


def operators(height: int, width: int, dct: int = 32, keep: int = 8):
    """Folded resize + DCT operators ((keep, H), (keep, W)), float32."""
    d = dct_matrix(dct)
    left = (d @ area_matrix(height, dct))[:keep]
    right = (d @ area_matrix(width, dct))[:keep]
    return left.astype(np.float32), right.astype(np.float32)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def downscale(luma: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(T, H, W) uint8 -> (T, height, width) uint8 by whole-pixel area means
    (H, W multiples of the target), rounded half to even."""
    t, h, w = luma.shape
    if (h, w) == (height, width):
        return luma
    if h % height or w % width:
        raise ValueError(f"{h}x{w} is not a whole multiple of {height}x{width}")
    x = luma.reshape(t, height, h // height, width, w // width)
    return torch.round(x.to(torch.float32).mean(dim=(2, 4))).clamp(0, 255).to(
        torch.uint8)


def phash(luma: torch.Tensor, tf32: bool = False, block: int = 4096
          ) -> np.ndarray:
    """(T, H, W) uint8 luma -> (T, 2) uint32 64-bit DCT pHashes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t, h, w = luma.shape
    left_np, right_np = operators(h, w)
    dev = luma.device
    left, right = torch.tensor(left_np, device=dev), torch.tensor(right_np, device=dev)
    rnd = to_tf32 if tf32 else (lambda z: z)
    out = []
    for s in range(0, t, block):
        x = luma[s:s + block].to(torch.float32)
        a = torch.matmul(rnd(left), rnd(x))                  # (b, 8, W)
        low = torch.matmul(rnd(a), rnd(right).T)             # (b, 8, 8)
        low = low.reshape(low.shape[0], 64)
        srt = torch.sort(low, dim=1).values
        med = (srt[:, 31] + srt[:, 32]) * 0.5
        bits = (low > med[:, None]).to(torch.int64).reshape(-1, 2, 32)
        shifts = 31 - torch.arange(32, device=dev)
        out.append((bits << shifts).sum(-1).cpu().numpy().astype(np.uint32))
    return np.concatenate(out) if out else np.zeros((0, 2), np.uint32)


def mafd(luma: torch.Tensor) -> np.ndarray:
    """(T,) float64 mean absolute frame difference of (T, H, W) uint8 luma
    at its own resolution; frame 0 reads 0."""
    t = luma.shape[0]
    out = np.zeros(t)
    if t > 1:
        d = (luma[1:].to(torch.int32) - luma[:-1].to(torch.int32)).abs()
        sums = d.reshape(t - 1, -1).sum(dim=1, dtype=torch.int64)
        out[1:] = sums.cpu().numpy().astype(np.float64) / float(
            luma.shape[1] * luma.shape[2])
    return out


def cut_frames(mafd_values: np.ndarray, threshold: float = 0.3) -> List[int]:
    """Frames whose scene score exceeds ``threshold``."""
    m = np.asarray(mafd_values, np.float64)
    prev = np.concatenate([[0.0], m[:-1]])
    scores = np.clip(np.minimum(m, np.abs(m - prev)) / 100.0, 0.0, 1.0)
    scores = scores.astype(np.float32)
    return [int(i) for i in np.nonzero(scores > threshold)[0]]
