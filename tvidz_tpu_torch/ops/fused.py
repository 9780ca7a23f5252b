"""The fused per-block fingerprint op — the port's hot compute path.

Port of ``tvidz_tpu/ops/fused.py::fingerprint_block``: one call per block of
T luma frames returns the scene scores, the packed 64-bit pHash of every
frame and the new scene carry. On a CUDA tensor it launches kernel K1
(``csrc/fingerprint_block.cu``, which replaces
``tvidz_tpu/ops/fused_pallas.py::_fused_kernel``; the source's header note
gives what bounds it on the H100 and how its design answers that). On a CPU
tensor it runs the plain PyTorch version, ``fingerprint_block_plain``.
There is no fallback between the two: a CUDA tensor the kernel cannot take
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.ops.phash import phash_batched
from tvidz_tpu_torch.ops.scene import (
    SceneCarry,
    initial_scene_carry,
    scene_scores_block,
)

_p, _i = ctypes.c_void_p, ctypes.c_int
K1 = backend.register(backend.Kernel(
    "fingerprint_block",
    replaces="tvidz_tpu/ops/fused_pallas.py:74 (_fused_kernel)",
    entry_points={
        "tvz_fingerprint_block": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                                  _p, _p, _p, _p, _p, _p, _p],
        "tvz_median_pack": [_p, _i, _p, _p],
    },
))


class FingerprintCarry(NamedTuple):
    scene: SceneCarry


def initial_fingerprint_carry(height: int, width: int,
                              device: torch.device) -> FingerprintCarry:
    return FingerprintCarry(scene=initial_scene_carry(height, width, device))


def _check_valid_t(valid_t: Optional[int], t: int) -> int:
    v = t if valid_t is None else int(valid_t)
    if not 1 <= v <= t:
        raise ValueError(f"valid_t={valid_t} outside [1, {t}]")
    return v


def fingerprint_block_plain(
    luma: torch.Tensor, carry: FingerprintCarry, left: torch.Tensor,
    right: torch.Tensor, valid_t: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, FingerprintCarry]:
    """Plain PyTorch version of K1 on any device: ((T,) float32 scores,
    (T, words) int32 packed hashes, new carry)."""
    if luma.ndim != 3 or luma.shape[0] == 0:
        raise ValueError(f"luma must be (T, H, W) with T >= 1, got {tuple(luma.shape)}")
    _check_valid_t(valid_t, luma.shape[0])
    x = luma.to(torch.float32)
    scores, scene_carry = scene_scores_block(x, carry.scene, valid_t=valid_t)
    fps = phash_batched(x, left, right)
    return scores, fps, FingerprintCarry(scene=scene_carry)


def _fingerprint_block_cuda(luma, carry, left, right, valid_t):
    dev = luma.device
    t, h, w = luma.shape
    if left.shape[0] != 8:
        raise NotImplementedError(
            "the fingerprint-block kernel computes the 64-bit pHash only "
            f"(hash_size 8), got hash_size {left.shape[0]}")
    backend.require(luma, "luma", torch.uint8, (t, h, w), dev)
    backend.require(left, "left operator", torch.float32, (8, h), dev)
    backend.require(right, "right operator", torch.float32, (8, w), dev)
    sc = carry.scene
    backend.require(sc.prev_frame, "carry.prev_frame", torch.float32, (h, w), dev)
    backend.require(sc.prev_mafd, "carry.prev_mafd", torch.float32, (), dev)
    backend.require(sc.has_prev, "carry.has_prev", torch.bool, (), dev)
    v = _check_valid_t(valid_t, t)
    mafd = torch.empty((t,), dtype=torch.float32, device=dev)
    scores = torch.empty((t,), dtype=torch.float32, device=dev)
    fps = torch.empty((t, 2), dtype=torch.int32, device=dev)
    new = SceneCarry(
        prev_frame=torch.empty((h, w), dtype=torch.float32, device=dev),
        prev_mafd=torch.empty((), dtype=torch.float32, device=dev),
        has_prev=torch.empty((), dtype=torch.bool, device=dev),
    )
    p = backend.ptr
    K1.call("tvz_fingerprint_block", p(luma), p(sc.prev_frame),
            p(sc.prev_mafd), p(sc.has_prev), p(left), p(right), t, h, w, v,
            p(mafd), p(scores), p(fps), p(new.prev_frame), p(new.prev_mafd),
            p(new.has_prev), backend.stream_ptr(dev))
    K1.launches += 1
    return scores, fps, FingerprintCarry(scene=new)


def fingerprint_block(
    luma: torch.Tensor, carry: FingerprintCarry, left: torch.Tensor,
    right: torch.Tensor, valid_t: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, FingerprintCarry]:
    """(T, H, W) luma block -> ((T,) float32 scores, (T, words) int32 packed
    hashes, new carry). ``left``/``right`` are ``phash.hash_operators`` on
    the block's device. ``valid_t``: the real frame count of a block padded
    by repeating its last frame (the carry is taken at frame valid_t-1).

    CUDA tensors go to kernel K1 (uint8 luma, 64-bit hash); CPU tensors to
    ``fingerprint_block_plain``."""
    if luma.is_cuda:
        return _fingerprint_block_cuda(luma, carry, left, right, valid_t)
    if luma.device.type != "cpu":
        raise ValueError(f"unsupported device {luma.device}")
    return fingerprint_block_plain(luma, carry, left, right, valid_t)


def median_pack_cuda(low: torch.Tensor) -> torch.Tensor:
    """K1's own median-threshold + pack device code on given (N, 64) float32
    coefficients -> (N, 2) int32 words. For checking its tie handling bit
    for bit against ``phash.median_threshold_bits`` + ``pack_bits_i32``;
    not a launch of the fingerprint block."""
    if not low.is_cuda:
        raise ValueError("median_pack_cuda takes a CUDA tensor")
    n = low.shape[0]
    backend.require(low, "low", torch.float32, (n, 64), low.device)
    out = torch.empty((n, 2), dtype=torch.int32, device=low.device)
    K1.call("tvz_median_pack", backend.ptr(low), n, backend.ptr(out),
            backend.stream_ptr(low.device))
    return out

