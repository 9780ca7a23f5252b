"""The least time of the hash-family fingerprint pass on one NVIDIA H100.

The configurations the fused kernel does not hash (``phash256``, ``phash``
at another size, ``ahash``, ``dhash``) take the program's family pass:
scene scores and the family's hash of every frame. For a DCT pHash at
(dct, keep) the work counted is the folded resize and DCT, one operator a
side: per frame ``(keep, H)·(H, W)`` then ``(keep, W)·(W, keep)``, that is
2·keep·(H·W + W·keep) float32 operations outside the tensor cores (TF32
stays off); the bytes counted are the luma in and the packed words out.
The bound is the larger of the two times at the rates of ``peaks``.
"""

from __future__ import annotations

from typing import Sequence

from perfbench.peaks import FP32_OPS_PER_S, bound_s


def family_ops(frames: int, height: int, width: int, keep: int) -> float:
    """Float32 operations of the folded resize and DCT of ``frames``."""
    return 2.0 * frames * keep * (height * width + width * keep)


def family_bound_s(valid_ts: Sequence[int], height: int, width: int,
                   keep: int) -> float:
    """One family pass over K streams' blocks with ``valid_ts`` real frames
    each at (height, width), hashed to keep² bits a frame."""
    frames = sum(int(t) for t in valid_ts)
    nbytes = frames * height * width + frames * keep * keep // 8
    return bound_s(nbytes, family_ops(frames, height, width, keep),
                   FP32_OPS_PER_S)
