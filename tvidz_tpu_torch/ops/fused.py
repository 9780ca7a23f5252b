"""The fused fingerprint op — the port's hot compute path.

Port of ``tvidz_tpu/ops/fused.py`` (``fingerprint_block``,
``fingerprint_blocks_batched``) and of the Pallas kernel's own wrapper
``tvidz_tpu/ops/fused_pallas.py::fingerprint_stream_pallas``: scene scores,
the packed 64-bit pHash of every frame and the new scene carry. On CUDA
tensors each of the three call shapes is ONE launch of kernel K1
(``csrc/fingerprint_block.cu``, which replaces
``tvidz_tpu/ops/fused_pallas.py::_fused_kernel``; the source's header note
gives what bounds it on the H100 and how its design answers that):

- ``fingerprint_block``: one stream's block and its carry (one segment);
- ``fingerprint_blocks_batched``: K streams' blocks, each with its own
  carry and ``valid_t`` (K segments; the dispatcher's pass);
- ``fingerprint_stream``: a whole stream from a fresh carry (one segment of
  every frame).

On CPU tensors they run the plain PyTorch versions (``*_plain``). There is
no fallback between the two: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.ops.phash import hash_operators, phash_batched
from tvidz_tpu_torch.ops.scene import (
    SceneCarry,
    initial_scene_carry,
    scene_scores_block,
)

_p, _i = ctypes.c_void_p, ctypes.c_int
_i64p = ctypes.POINTER(ctypes.c_int64)
K1 = backend.register(backend.Kernel(
    "fingerprint_block",
    replaces="tvidz_tpu/ops/fused_pallas.py:74 (_fused_kernel)",
    entry_points={
        "tvz_fingerprint_segments": [_i, _i, _i, _i, _i64p, _p],
        "tvz_fingerprint_grid": [ctypes.c_longlong, _i, _i,
                                 ctypes.POINTER(ctypes.c_int)],
        "tvz_median_pack": [_p, _i, _p, _p],
    },
))
# Segments one launch takes (kMaxSegments in the source): the per-segment
# pointers and valid_t ride in the launch parameters.
MAX_SEGMENTS = 64

Result = Tuple[torch.Tensor, torch.Tensor, "FingerprintCarry"]


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


# -- plain versions -------------------------------------------------------------


def fingerprint_block_plain(
    luma: torch.Tensor, carry: FingerprintCarry, left: torch.Tensor,
    right: torch.Tensor, valid_t: Optional[int] = None,
) -> Result:
    """Plain PyTorch version of K1 on any device: ((T,) float32 scores,
    (T, words) int32 packed hashes, new carry)."""
    if luma.ndim != 3 or luma.shape[0] == 0:
        raise ValueError(f"luma must be (T, H, W) with T >= 1, got {tuple(luma.shape)}")
    _check_valid_t(valid_t, luma.shape[0])
    x = luma.to(torch.float32)
    scores, scene_carry = scene_scores_block(x, carry.scene, valid_t=valid_t)
    fps = phash_batched(x, left, right)
    return scores, fps, FingerprintCarry(scene=scene_carry)


def fingerprint_blocks_batched_plain(lumas, carries, valid_ts, left, right):
    """K streams' blocks, each a ``fingerprint_block_plain`` of its own:
    ((K, T) scores, (K, T, words) fps, tuple of K carries)."""
    out = [fingerprint_block_plain(x, c, left, right, valid_t=int(v))
           for x, c, v in zip(lumas, carries, valid_ts)]
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            tuple(o[2] for o in out))


def fingerprint_stream_plain(luma: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``fingerprint_stream``: ``fingerprint_block_plain``
    chained over 128-frame blocks from a fresh carry (the last block may be
    short). Returns ((NTOT,) scores, (NTOT, words) fps)."""
    n, h, w = luma.shape
    left, right = hash_operators(h, w, luma.device)
    carry = initial_fingerprint_carry(h, w, luma.device)
    scores, fps = [], []
    for s in range(0, n, 128):
        sc, fp, carry = fingerprint_block_plain(luma[s:s + 128], carry,
                                                left, right)
        scores.append(sc)
        fps.append(fp)
    return torch.cat(scores), torch.cat(fps)


# -- K1 -------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _out_layout(s: int, t: int, h: int, w: int) -> Tuple[int, ...]:
    """Offsets, in float32 words, of scores (S, T), fps (S, T, 2), new
    frames (S, H, W), new mafd (S,) and new has_prev (S bytes) in a call's
    one output buffer (each 16-byte aligned), and the buffer's length."""
    out, off = [], 0
    for n in (s * t, 2 * s * t, s * h * w, s, -(-s // 4)):
        out.append(off)
        off += -(-n // 4) * 4
    return (*out, off)


def _launch(lumas: Sequence[torch.Tensor], carries: Sequence[FingerprintCarry],
            valid_ts: Sequence[Optional[int]], left: torch.Tensor,
            right: torch.Tensor, lone: bool = False):
    """One K1 launch over S = len(lumas) segments of the same (T, H, W):
    ((S, T) scores, (S, T, 2) fps, tuple of S carries), all views of one
    output buffer; with ``lone`` (S = 1), ((T,) scores, (T, 2) fps, the
    carry)."""
    x0 = lumas[0]
    dev = x0.device
    s = len(lumas)
    if not 1 <= s <= MAX_SEGMENTS:
        raise ValueError(f"{s} segments: one K1 launch takes 1..{MAX_SEGMENTS}")
    if x0.ndim != 3 or x0.shape[0] == 0:
        raise ValueError(f"luma must be (T, H, W) with T >= 1, got {tuple(x0.shape)}")
    t, h, w = x0.shape
    if left.shape[0] != 8:
        raise NotImplementedError(
            "the fingerprint-block kernel computes the 64-bit pHash only "
            f"(hash_size 8), got hash_size {left.shape[0]}")
    if w > 160 or w % 4 or (h * w) % 16:
        raise ValueError(f"the fingerprint-block kernel takes W <= 160, a "
                         f"multiple of 4, and H*W a multiple of 16; got {h}x{w}")
    backend.require(left, "left operator", torch.float32, (8, h), dev)
    backend.require(right, "right operator", torch.float32, (8, w), dev)
    scs = [c.scene for c in carries]
    for x, sc in zip(lumas, scs):
        backend.require(x, "luma", torch.uint8, x0.shape, dev)
        backend.require(sc.prev_frame, "carry.prev_frame", torch.float32, (h, w), dev)
        backend.require(sc.prev_mafd, "carry.prev_mafd", torch.float32, (), dev)
        backend.require(sc.has_prev, "carry.has_prev", torch.bool, (), dev)
    vts = [_check_valid_t(v, t) for v in valid_ts]
    xp = [x.data_ptr() for x in lumas]
    fp = [sc.prev_frame.data_ptr() for sc in scs]
    if any(q % 16 for q in xp + fp):
        raise ValueError("luma and carry.prev_frame must be 16-byte aligned")
    o_sc, o_fp, o_fr, o_m, o_hp, n = _out_layout(s, t, h, w)
    buf = torch.empty((n,), dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    table = (ctypes.c_int64 * (7 + 5 * s))(
        left.data_ptr(), right.data_ptr(), base + 4 * o_sc, base + 4 * o_fp,
        base + 4 * o_fr, base + 4 * o_m, base + 4 * o_hp, *xp, *fp,
        *[sc.prev_mafd.data_ptr() for sc in scs],
        *[sc.has_prev.data_ptr() for sc in scs], *vts)
    K1.call("tvz_fingerprint_segments", s, t, h, w, table,
            backend.stream_ptr(dev))
    K1.launches += 1
    i32, b8 = buf.view(torch.int32), buf.view(torch.bool)
    if lone:                             # one segment, no batch dimension
        return (buf.as_strided((t,), (1,), o_sc),
                i32.as_strided((t, 2), (2, 1), o_fp),
                FingerprintCarry(scene=SceneCarry(
                    prev_frame=buf.as_strided((h, w), (w, 1), o_fr),
                    prev_mafd=buf.as_strided((), (), o_m),
                    has_prev=b8.as_strided((), (), 4 * o_hp))))
    frames = buf.as_strided((s, h, w), (h * w, w, 1), o_fr).unbind(0)
    mafd = buf.as_strided((s,), (1,), o_m).unbind(0)
    has_prev = b8.as_strided((s,), (1,), 4 * o_hp).unbind(0)
    return (buf.as_strided((s, t), (t, 1), o_sc),
            i32.as_strided((s, t, 2), (2 * t, 2, 1), o_fp),
            tuple(FingerprintCarry(scene=SceneCarry(prev_frame=f, prev_mafd=m,
                                                    has_prev=hp))
                  for f, m, hp in zip(frames, mafd, has_prev)))


def fingerprint_grid(frames: int, height: int, width: int) -> int:
    """The number of CTAs K1 launches for ``frames`` frames of (H, W) on the
    current CUDA device (each walks a contiguous range of them)."""
    out = ctypes.c_int(0)
    K1.call("tvz_fingerprint_grid", frames, height, width, ctypes.byref(out))
    return out.value


def _device_of(luma: torch.Tensor) -> str:
    if luma.is_cuda:
        return "cuda"
    if luma.device.type != "cpu":
        raise ValueError(f"unsupported device {luma.device}")
    return "cpu"


def fingerprint_block(
    luma: torch.Tensor, carry: FingerprintCarry, left: torch.Tensor,
    right: torch.Tensor, valid_t: Optional[int] = None,
) -> Result:
    """(T, H, W) luma block -> ((T,) float32 scores, (T, words) int32 packed
    hashes, new carry). ``left``/``right`` are ``phash.hash_operators`` on
    the block's device. ``valid_t``: the real frame count of a block padded
    by repeating its last frame (the carry is taken at frame valid_t-1).
    T may be any length, a whole stream included.

    CUDA tensors go to kernel K1 (uint8 luma, 64-bit hash), one launch;
    CPU tensors to ``fingerprint_block_plain``."""
    if _device_of(luma) == "cuda":
        return _launch([luma], [carry], [valid_t], left, right, lone=True)
    return fingerprint_block_plain(luma, carry, left, right, valid_t)


def fingerprint_blocks_batched(lumas, carries, valid_ts, left: torch.Tensor,
                               right: torch.Tensor):
    """K independent streams' (T, H, W) blocks (a sequence, or one (K, T, H,
    W) tensor) with their carries and real frame counts -> ((K, T) scores,
    (K, T, words) fps, tuple of K new carries). Stream k's results equal a
    lone ``fingerprint_block`` of it bit for bit.

    On CUDA: one K1 launch per ``MAX_SEGMENTS`` streams (the blocks are not
    stacked: each segment's pointer rides in the launch); on the CPU,
    ``fingerprint_blocks_batched_plain``."""
    lumas = list(lumas)
    carries, valid_ts = list(carries), [int(v) for v in valid_ts]
    if not lumas or not len(lumas) == len(carries) == len(valid_ts):
        raise ValueError(f"{len(lumas)} blocks, {len(carries)} carries and "
                         f"{len(valid_ts)} valid_ts: need the same count >= 1")
    if _device_of(lumas[0]) == "cpu":
        return fingerprint_blocks_batched_plain(lumas, carries, valid_ts,
                                                left, right)
    parts = [_launch(lumas[i:i + MAX_SEGMENTS], carries[i:i + MAX_SEGMENTS],
                     valid_ts[i:i + MAX_SEGMENTS], left, right)
             for i in range(0, len(lumas), MAX_SEGMENTS)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([q[0] for q in parts]), torch.cat([q[1] for q in parts]),
            tuple(c for q in parts for c in q[2]))


def fingerprint_stream(luma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-stream fingerprinting from a fresh carry, the port of
    ``fingerprint_stream_pallas``: (NTOT, H, W) luma -> ((NTOT,) scores,
    (NTOT, words) fps). On CUDA one K1 launch over every frame (no frame
    depends on a block edge); on the CPU ``fingerprint_stream_plain``."""
    if luma.ndim != 3 or luma.shape[0] == 0:
        raise ValueError(f"luma must be (NTOT, H, W) with NTOT >= 1, got "
                         f"{tuple(luma.shape)}")
    if _device_of(luma) == "cpu":
        return fingerprint_stream_plain(luma)
    _, h, w = luma.shape
    left, right = hash_operators(h, w, luma.device)
    scores, fps, _ = fingerprint_block(
        luma, initial_fingerprint_carry(h, w, luma.device), left, right)
    return scores, fps


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
