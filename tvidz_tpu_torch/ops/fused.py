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
Under ``ship_dct_coeffs`` the payload is host-projected coefficients and
``fingerprint_block(s_batched)_coeffs`` run only the median threshold and
pack (K1's ``tvz_median_pack`` entry on CUDA, ``median_pack_cuda``).

K1 computes the DCT pHash at hash_size 8 (the Pallas kernel is 64-bit only,
``fused_pallas.py:165``). Every other fingerprint configuration — ahash,
dhash, phash256, phash at another hash_size — is the reference's other
branch (``tvidz_tpu/ops/fused.py:56-63``, ``:110-117``), which no Pallas
kernel computes either: scene scores from ``ops/scene`` and the family's
hashes from ``ops/hashes``, in plain torch on any device
(``fingerprint_family_block``, ``fingerprint_family_blocks_batched``).
``fingerprint_block`` and ``fingerprint_blocks_batched`` take the
configuration (``algorithm``, ``dct_size``, ``hash_size``) and go one way
or the other by it alone (``uses_k1``). The family's pass is a span,
``fingerprint.family`` (``utils.timing``; attrs ``algorithm``, ``frames``,
the K·T frames it hashes, and ``words``): on CUDA its wall is the host's
launch of the pass, whose device work the dispatcher's pull waits for.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.ops import hashes
from tvidz_tpu_torch.ops.phash import hash_operators, phash_batched
from tvidz_tpu_torch.ops.scene import (
    SceneCarry,
    initial_scene_carry,
    scene_scores_block,
    scene_scores_blocks,
)
from tvidz_tpu_torch.utils.timing import span

_p, _i = ctypes.c_void_p, ctypes.c_int
_i64p = ctypes.POINTER(ctypes.c_int64)
K1 = backend.register(backend.Kernel(
    "fingerprint_block",
    replaces="tvidz_tpu/ops/fused_pallas.py:74 (_fused_kernel)",
    entry_points={
        "tvz_fingerprint_segments": [_i, _i, _i, _i, _i, _i, _i64p, _p],
        "tvz_fingerprint_grid": [_i, ctypes.c_longlong, _i, _i, _i,
                                 ctypes.POINTER(ctypes.c_int)],
        "tvz_median_pack": [_p, _i, _p, _p],
    },
))
# Segments one launch takes (kMaxSegments in the source): the per-segment
# pointers and valid_t ride in the launch parameters.
MAX_SEGMENTS = 64
# K1's limits (the source's kMaxSmem, kMaxPixels, kMaxWidthGeneral): a
# block's shared memory on Hopper, 255 H W < 2^31 for the exact int32 mafd
# sum, and the widest row the second form takes.
_MAX_SMEM = 232448
_MAX_PIXELS = 8421504
_MAX_WIDTH = 7188
# Shared memory form 0 spends beside its frames and Lᵀ.
_SMEM_COMMON = 4 * (8 * 64 + 64 + 16) + 4 * 16
# Form 1: shared memory a CTA gives its three band slots and Lᵀ's band rows,
# so that two CTAs (and their 128 registers a thread) share an SM.
_BAND_BUDGET = 106496

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


def k1_form(height: int, width: int) -> int:
    """Which of K1's two forms computes an (H, W) scene (``csrc/
    fingerprint_block.cu``): 0, three whole frames in shared memory and five
    columns a lane (W <= 160, a multiple of 4, H*W a multiple of 16, the
    frames within a block's shared memory: the production 90x160); else 1,
    the frame cut into row bands over CTAs (``k1_band_rows``) at any H, W
    and alignment. Raises where neither fits: H*W above 8,421,504 pixels
    (the exact int32 mafd sum) or W above 7,188."""
    h, w = int(height), int(width)
    if h < 1 or w < 1 or h * w > _MAX_PIXELS or w > _MAX_WIDTH:
        raise ValueError(
            f"the fingerprint-block kernel takes 1 <= H*W <= {_MAX_PIXELS} and "
            f"W <= {_MAX_WIDTH}; got {h}x{w}")
    if (4 <= w <= 160 and w % 4 == 0 and (h * w) % 16 == 0
            and 3 * h * w + 32 * h + _SMEM_COMMON <= _MAX_SMEM):
        return 0
    return 1


def k1_band_rows(height: int, width: int) -> int:
    """Rows of a band of K1's second form: a function of (H, W) alone, so a
    frame's hash is the same bits however it is launched. As many rows as
    fit the band budget three times over (``_BAND_BUDGET``: a ring of
    three bands and Lᵀ's rows), then evened out over the bands; the last
    band may be shorter."""
    h, w = int(height), int(width)
    rows = max(1, min(h, _BAND_BUDGET // (3 * w + 32)))
    bands = -(-h // rows)
    return -(-h // bands)


# Per (device, stream): form 1's arrival counters, int32 at 0, one a frame.
# Each launch leaves them at 0, so a call allocates none unless it has more
# frames than any call before it on that stream.
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _k1_counters(dev: torch.device, frames: int) -> torch.Tensor:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    ws = _COUNTERS.get(key)
    if ws is None or ws.numel() < frames:
        cap = max(frames, 2 * (0 if ws is None else ws.numel()), 4096)
        ws = _COUNTERS[key] = torch.zeros((cap,), dtype=torch.int32, device=dev)
    return ws


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
        raise ValueError(
            "the fingerprint-block kernel computes the 64-bit pHash "
            f"(hash_size 8), got hash_size {left.shape[0]}: other families and "
            "sizes take ops/fused.fingerprint_family_block")
    form = k1_form(h, w)
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
    if form == 0 and any(q % 16 for q in xp + fp):
        raise ValueError("luma and carry.prev_frame must be 16-byte aligned")
    o_sc, o_fp, o_fr, o_m, o_hp, n = _out_layout(s, t, h, w)
    buf = torch.empty((n,), dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    rows, scratch = h, (0, 0, 0)
    if form == 1:
        # Each (frame, band)'s 64 sums and SAD (written before they are
        # read), and the frames' arrival counters (kept at 0).
        rows = k1_band_rows(h, w)
        frames, bands = s * t, -(-h // rows)
        work = torch.empty((frames * bands * 65,), dtype=torch.float32, device=dev)
        scratch = (work.data_ptr(), work.data_ptr() + 4 * 64 * frames * bands,
                   _k1_counters(dev, frames).data_ptr())
    table = (ctypes.c_int64 * (10 + 5 * s))(
        left.data_ptr(), right.data_ptr(), base + 4 * o_sc, base + 4 * o_fp,
        base + 4 * o_fr, base + 4 * o_m, base + 4 * o_hp, *scratch, *xp, *fp,
        *[sc.prev_mafd.data_ptr() for sc in scs],
        *[sc.has_prev.data_ptr() for sc in scs], *vts)
    K1.launch("tvz_fingerprint_segments", dev, form, s, t, h, w, rows, table)
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
    current CUDA device (form 0: each walks a contiguous range of them;
    form 1: bands x ranges, each CTA one band of a range)."""
    out = ctypes.c_int(0)
    K1.call("tvz_fingerprint_grid", k1_form(height, width), frames, height,
            width, k1_band_rows(height, width), ctypes.byref(out))
    return out.value


def _device_of(luma: torch.Tensor) -> str:
    if luma.is_cuda:
        return "cuda"
    if luma.device.type != "cpu":
        raise ValueError(f"unsupported device {luma.device}")
    return "cpu"


def uses_k1(algorithm: str, hash_size: int) -> bool:
    """Whether a fingerprint configuration's blocks go to K1 (on CUDA) and
    its plain version: the DCT pHash at hash_size 8, any dct_size."""
    return algorithm == "phash" and int(hash_size) == 8


def family_hashes(luma: torch.Tensor, algorithm: str, dct_size: int = 32,
                  hash_size: int = 8) -> torch.Tensor:
    """(T, H, W) -> (T, words) int32 hashes of a family (``ops/hashes``);
    ``phash`` honours ``dct_size`` and ``hash_size``, as the reference."""
    if algorithm == "phash":
        return hashes.phash_family(luma, dct_size, hash_size)
    return hashes.get_hash_fn(algorithm)(luma)


def fingerprint_family_block(luma: torch.Tensor, carry: FingerprintCarry,
                             valid_t: Optional[int] = None, *, algorithm: str,
                             dct_size: int = 32, hash_size: int = 8) -> Result:
    """One block of a configuration K1 does not compute: ((T,) scores, (T,
    words) int32 hashes, new carry), scene scores from
    ``scene_scores_block`` and hashes from ``family_hashes``, plain torch on
    the block's device."""
    if luma.ndim != 3 or luma.shape[0] == 0:
        raise ValueError(f"luma must be (T, H, W) with T >= 1, got {tuple(luma.shape)}")
    _check_valid_t(valid_t, luma.shape[0])
    with span("fingerprint.family", algorithm=algorithm,
              frames=luma.shape[0]) as sp:
        x = luma.to(torch.float32)
        scores, scene_carry = scene_scores_block(x, carry.scene, valid_t=valid_t)
        fps = family_hashes(x, algorithm, dct_size, hash_size)
        sp.note(words=fps.shape[-1])
    return scores, fps, FingerprintCarry(scene=scene_carry)


def fingerprint_family_blocks_batched(lumas, carries, valid_ts, *, algorithm: str,
                                      dct_size: int = 32, hash_size: int = 8):
    """K streams' blocks of such a configuration in one pass: scene scores
    over the K streams at once (``scene_scores_blocks``), the hashes of all
    K·T frames in one batch, as the reference's batched program."""
    lumas = list(lumas)
    k, t, h, w = len(lumas), *lumas[0].shape
    for v in valid_ts:
        _check_valid_t(v, t)
    with span("fingerprint.family", algorithm=algorithm, frames=k * t) as sp:
        x = torch.stack(lumas).to(torch.float32)
        scores, scene = scene_scores_blocks(x, [c.scene for c in carries],
                                            valid_ts)
        fps = family_hashes(x.reshape(k * t, h, w), algorithm, dct_size,
                            hash_size)
        sp.note(words=fps.shape[-1])
    return (scores, fps.reshape(k, t, -1),
            tuple(FingerprintCarry(scene=c) for c in scene))


def fingerprint_block(
    luma: torch.Tensor, carry: FingerprintCarry,
    left: Optional[torch.Tensor] = None, right: Optional[torch.Tensor] = None,
    valid_t: Optional[int] = None, *, algorithm: str = "phash",
    dct_size: int = 32, hash_size: int = 8,
) -> Result:
    """(T, H, W) luma block -> ((T,) float32 scores, (T, words) int32 packed
    hashes, new carry). ``left``/``right`` are ``phash.hash_operators`` on
    the block's device (built from ``dct_size`` when None). ``valid_t``: the
    real frame count of a block padded by repeating its last frame (the
    carry is taken at frame valid_t-1). T may be any length, a whole stream
    included.

    The 64-bit pHash (``uses_k1``): CUDA tensors go to kernel K1 (uint8
    luma), one launch; CPU tensors to ``fingerprint_block_plain``. Any other
    configuration: ``fingerprint_family_block``."""
    if not uses_k1(algorithm, hash_size):
        return fingerprint_family_block(luma, carry, valid_t, algorithm=algorithm,
                                        dct_size=dct_size, hash_size=hash_size)
    if left is None or right is None:
        left, right = hash_operators(luma.shape[1], luma.shape[2], luma.device,
                                     dct_size)
    if _device_of(luma) == "cuda":
        return _launch([luma], [carry], [valid_t], left, right, lone=True)
    return fingerprint_block_plain(luma, carry, left, right, valid_t)


def fingerprint_blocks_batched(lumas, carries, valid_ts,
                               left: Optional[torch.Tensor] = None,
                               right: Optional[torch.Tensor] = None, *,
                               algorithm: str = "phash", dct_size: int = 32,
                               hash_size: int = 8):
    """K independent streams' (T, H, W) blocks (a sequence, or one (K, T, H,
    W) tensor) with their carries and real frame counts -> ((K, T) scores,
    (K, T, words) fps, tuple of K new carries).

    The 64-bit pHash on CUDA: one K1 launch per ``MAX_SEGMENTS`` streams
    (the blocks are not stacked: each segment's pointer rides in the
    launch), stream k's results equal to a lone ``fingerprint_block`` of it
    bit for bit; on the CPU, ``fingerprint_blocks_batched_plain``. Any other
    configuration: ``fingerprint_family_blocks_batched``."""
    lumas = list(lumas)
    carries, valid_ts = list(carries), [int(v) for v in valid_ts]
    if not lumas or not len(lumas) == len(carries) == len(valid_ts):
        raise ValueError(f"{len(lumas)} blocks, {len(carries)} carries and "
                         f"{len(valid_ts)} valid_ts: need the same count >= 1")
    if not uses_k1(algorithm, hash_size):
        return fingerprint_family_blocks_batched(
            lumas, carries, valid_ts, algorithm=algorithm, dct_size=dct_size,
            hash_size=hash_size)
    if left is None or right is None:
        left, right = hash_operators(lumas[0].shape[1], lumas[0].shape[2],
                                     lumas[0].device, dct_size)
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
    """K1's own median-threshold + pack device code (``tvz_median_pack``,
    one CTA a row) on given (N, 64) float32 coefficients -> (N, 2) int32
    words: the device tail of the coefficient-shipping path
    (``phash.phash_from_coeffs_batched``), one K1 launch, held bit for bit
    against ``phash.phash_from_coeffs_plain``."""
    if not low.is_cuda:
        raise ValueError("median_pack_cuda takes a CUDA tensor")
    n = low.shape[0]
    backend.require(low, "low", torch.float32, (n, 64), low.device)
    out = torch.empty((n, 2), dtype=torch.int32, device=low.device)
    K1.launch("tvz_median_pack", low.device, backend.ptr(low), n,
              backend.ptr(out))
    return out


# -- coefficient shipping (PipelineConfig.ship_dct_coeffs) --------------------

_COEFF_SHAPE_MSG = ("coeff payload must be (T, hash²), got {} — was a raw luma "
                    "block passed to a ship_dct_coeffs model?")


def fingerprint_block_coeffs(coeffs: torch.Tensor, carry: FingerprintCarry,
                             hash_size: int = 8) -> Result:
    """The single-stream coefficient forward (tvidz_tpu/ops/fused.py:130):
    (T, hash²) float32 host-projected coefficients -> (zero (T,) scores,
    (T, words) int32 hashes, the carry untouched). Scores come from the
    host in this mode (``NativeSceneScorer``'s mafd, else its host
    fallback); the scene recurrence never runs."""
    if coeffs.ndim != 2:
        raise ValueError(_COEFF_SHAPE_MSG.format(tuple(coeffs.shape)))
    from tvidz_tpu_torch.ops.phash import phash_from_coeffs_batched

    fps = phash_from_coeffs_batched(coeffs, hash_size)
    return (torch.zeros((coeffs.shape[0],), dtype=torch.float32,
                        device=coeffs.device), fps, carry)


def fingerprint_blocks_batched_coeffs(coeffs, carries, valid_ts,
                                      hash_size: int = 8):
    """K streams' (T, hash²) coefficient blocks (a sequence or one (K, T,
    hash²) tensor) in one pass (tvidz_tpu/ops/fused.py:150): ((K, T) zero
    scores, (K, T, words) hashes, the K carries untouched); ``valid_ts`` is
    unused (the pad rows' hashes are sliced off by the caller). On CUDA at
    hash_size 8: one K1 median-pack launch over the K·T rows."""
    del valid_ts
    if isinstance(coeffs, (tuple, list)):
        if any(c.ndim != 2 for c in coeffs):
            raise ValueError(_COEFF_SHAPE_MSG.format(
                [tuple(c.shape) for c in coeffs]))
        coeffs = torch.stack(list(coeffs))
    if coeffs.ndim != 3:
        raise ValueError(_COEFF_SHAPE_MSG.format(tuple(coeffs.shape)))
    from tvidz_tpu_torch.ops.phash import phash_from_coeffs_batched

    k, t, n = coeffs.shape
    fps = phash_from_coeffs_batched(coeffs.reshape(k * t, n), hash_size)
    return (torch.zeros((k, t), dtype=torch.float32, device=coeffs.device),
            fps.reshape(k, t, -1), tuple(carries))
