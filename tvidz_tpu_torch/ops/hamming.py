"""Packed-fingerprint Hamming distances and the corpus scan.

Port of ``tvidz_tpu/ops/hamming.py``. Fingerprints are (rows, W) int32
bit-views of the reference's uint32 words. The corpus scan has the
three-output contract of the reference's Pallas scans — per corpus row the
min distance over the queries (frame_min), per query the min distance and
the FIRST row attaining it (q_min, q_arg) — and two hand-written kernels:

- K2 (``csrc/corpus_scan.cu``): XOR + popcount on the CUDA cores, for the
  full contract, (q_min, q_arg) only, or frame_min only
  (``corpus_min_distance``, ``corpus_frame_min_xor``). It replaces
  ``_corpus_scan_kernel`` and ``_corpus_scan_kernel_mxu_twophase``.
- K4 (``csrc/corpus_scan_tc.cu``): the ±1 int8 product on the tensor cores,
  in the five modes of ``MODES`` (``corpus_scan_tc``), one for each MXU
  variant of the reference: one persistent launch a call.

On CUDA tensors the wrappers launch their kernel or raise; on CPU tensors
they run the plain versions (``corpus_min_distance_plain`` for the XOR
form, ``corpus_scan_pm1_plain`` for the ±1 form). Sentinel rows (all ones)
and padding are ordinary rows to all of them: the caller decides what a
hit on them means, as in the reference. ``corpus_frame_min`` and
``corpus_query_nearest`` serve ``DeviceCorpus`` through K4's ``frame_min``
and ``query_nearest`` modes, which won the race on the card against K2
(PERF.md); K2 stays in the parity checks and the bench race.

The corpus layout is row-major (N, W) — the host mirror's own layout. The
reference's word-major (W, N) device layout served TPU lanes; the kernels
read one 8-byte row per thread instead.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from tvidz_tpu_torch import backend

_p, _i = ctypes.c_void_p, ctypes.c_int
K2 = backend.register(backend.Kernel(
    "corpus_scan",
    replaces="tvidz_tpu/ops/hamming.py:442 (_corpus_scan_kernel_mxu_twophase); "
             "tvidz_tpu/ops/hamming.py:116 (_corpus_scan_kernel)",
    entry_points={
        "tvz_corpus_scan": [_p, _i, _p, _i, _p, _p, _p, _p, _p],
        "tvz_corpus_frame_min": [_p, _i, _p, _i, _p, _p],
    },
))
K4 = backend.register(backend.Kernel(
    "corpus_scan_tc",
    replaces="tvidz_tpu/ops/hamming.py:211 (_corpus_scan_kernel_mxu); "
             "tvidz_tpu/ops/hamming.py:340 (_corpus_scan_kernel_mxu_hoisted); "
             "tvidz_tpu/ops/hamming.py:442 (_corpus_scan_kernel_mxu_twophase); "
             "tvidz_tpu/ops/hamming.py:553 (_corpus_frame_min_kernel_mxu); "
             "tvidz_tpu/ops/hamming.py:610 (_corpus_query_nearest_kernel_mxu)",
    entry_points={
        "tvz_corpus_scan_tc": [_p, _i, _p, _i, _p, _i, _p, _p, _p, _p, _p, _p],
        "tvz_corpus_scan_tc_grid": [_i, _i, ctypes.POINTER(ctypes.c_int)],
    },
))

# K4's modes, in the order of the C entry point's ``mode`` argument, and
# which outputs each produces: (frame_min, q_min and q_arg).
MODES = ("full", "full_cols", "twophase", "frame_min", "query_nearest")
_MODE_OUTPUTS = {"full": (True, True), "full_cols": (True, True),
                 "twophase": (True, True), "frame_min": (True, False),
                 "query_nearest": (False, True)}

_M32 = 0xFFFFFFFF
# Queries x corpus rows per block of the plain scan (bounds its memory).
_PLAIN_PAIRS = 1 << 20
_BIG = 1 << 30
# The kernels' largest query count.
_MAX_QUERIES = 16384


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32): no overflow anywhere."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_matrix(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(M, W) x (N, W) packed int32 -> (M, N) int32 Hamming distances."""
    x = (q.to(torch.int64)[:, None, :] & _M32) ^ (c.to(torch.int64)[None, :, :] & _M32)
    return _popcount32(x).sum(dim=-1).to(torch.int32)


def _scan_plain(q, corpus, distances, frame_min, query):
    """The reductions shared by both plain versions over the (M, B) distance
    blocks ``distances(q, rows)``: (frame_min (N,) or None, q_min (M,) or
    None, q_arg (M,) or None); an earlier block keeps a tie (first-index
    argmin)."""
    m, n = q.shape[0], corpus.shape[0]
    block = max(1, _PLAIN_PAIRS // max(m, 1))
    fmin = torch.empty((n,), dtype=torch.int32, device=q.device) if frame_min else None
    q_min = torch.full((m,), _BIG, dtype=torch.int32, device=q.device)
    q_arg = torch.zeros((m,), dtype=torch.int32, device=q.device)
    for s in range(0, n, block):
        d = distances(q, corpus[s:s + block])                        # (M, B)
        if fmin is not None:
            fmin[s:s + d.shape[1]] = d.min(dim=0).values
        if query:
            blk_min, blk_arg = d.min(dim=1)  # first index among equal minima
            better = blk_min < q_min
            q_min = torch.where(better, blk_min, q_min)
            q_arg = torch.where(better, blk_arg.to(torch.int32) + s, q_arg)
    return fmin, (q_min if query else None), (q_arg if query else None)


def corpus_min_distance_plain(
    q: torch.Tensor, corpus: torch.Tensor, frame_min: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 on any device: (frame_min (N,) int32 or
    None, q_min (M,) int32, q_arg (M,) int32), blocked over the corpus."""
    return _scan_plain(q, corpus, hamming_matrix, frame_min, True)


def unpack_bits_pm1(packed: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 words -> (N, 32*W) float32 ±1 (set bit -> +1), MSB-first
    per word (golden.pack_bits order), as the reference's unpack."""
    shifts = 31 - torch.arange(32, device=packed.device)
    bits = ((packed.to(torch.int64)[:, :, None] & _M32) >> shifts) & 1
    return bits.reshape(packed.shape[0], -1).to(torch.float32) * 2 - 1


def hamming_matrix_pm1(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(M, W) x (N, W) packed int32 -> (M, N) int32 Hamming distances as
    (bits - q_pm1 @ c_pm1^T) / 2: a float32 product of ±1 values, exact for
    sums of at most 64 terms (and in TF32 too: ±1 needs no mantissa)."""
    bits = 32 * q.shape[1]
    dots = unpack_bits_pm1(q) @ unpack_bits_pm1(c).T
    return ((bits - dots) * 0.5).to(torch.int32)


def corpus_scan_pm1_plain(q: torch.Tensor, corpus: torch.Tensor, mode: str
                          ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """Plain PyTorch version of K4 on any device: the ±1 formulation with the
    outputs of ``mode`` — (frame_min or None, q_min or None, q_arg or None).
    ``full``, ``full_cols`` and ``twophase`` differ only in how the kernel
    works, not in what it computes."""
    if mode not in _MODE_OUTPUTS:
        raise ValueError(f"unknown scan mode {mode!r}; one of {MODES}")
    frame_min, query = _MODE_OUTPUTS[mode]
    return _scan_plain(q, corpus, hamming_matrix_pm1, frame_min, query)


def _check_scan_inputs(q, corpus):
    """Shape and device checks every scan entry point makes."""
    if q.ndim != 2 or corpus.ndim != 2 or q.shape[1] != corpus.shape[1]:
        raise ValueError(f"incompatible shapes {tuple(q.shape)} and "
                         f"{tuple(corpus.shape)}")
    if q.shape[0] == 0 or corpus.shape[0] == 0:
        raise ValueError("empty query or corpus")
    if q.device != corpus.device:
        raise ValueError(f"queries on {q.device}, corpus on {corpus.device}")
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")


def _check_kernel_inputs(q, corpus, what):
    """The kernels' contract: W = 2, 1 <= M <= 16384, N < 2^31, contiguous
    int32 rows on one CUDA device."""
    dev = q.device
    m, n = q.shape[0], corpus.shape[0]
    if q.shape[1] != 2 or corpus.shape[1] != 2:
        raise NotImplementedError(
            f"the {what} kernel takes 64-bit fingerprints (2 words), got "
            f"{q.shape[1]} and {corpus.shape[1]} words")
    backend.require(q, "queries", torch.int32, (m, 2), dev)
    backend.require(corpus, "corpus", torch.int32, (n, 2), dev)
    if not 1 <= m <= _MAX_QUERIES or not 1 <= n < 2 ** 31:
        raise ValueError(f"scan shape out of range: M={m}, N={n}")
    return dev, m, n


def _corpus_min_distance_cuda(q, corpus, frame_min):
    dev, m, n = _check_kernel_inputs(q, corpus, "corpus-scan")
    fmin = torch.empty((n,), dtype=torch.int32, device=dev) if frame_min else None
    keys = torch.empty((m,), dtype=torch.int64, device=dev)
    q_min = torch.empty((m,), dtype=torch.int32, device=dev)
    q_arg = torch.empty((m,), dtype=torch.int32, device=dev)
    p = backend.ptr
    K2.call("tvz_corpus_scan", p(q), m, p(corpus), n,
            None if fmin is None else p(fmin), p(keys), p(q_min), p(q_arg),
            backend.stream_ptr(dev))
    K2.launches += 1
    return fmin, q_min, q_arg


def corpus_min_distance(
    q: torch.Tensor, corpus: torch.Tensor, frame_min: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (M, W), corpus (N, W) packed int32 on one device -> (frame_min (N,)
    int32, or None when ``frame_min=False``; q_min (M,) int32; q_arg (M,)
    int32). CUDA tensors go to kernel K2, CPU tensors to the plain version."""
    _check_scan_inputs(q, corpus)
    if q.is_cuda:
        return _corpus_min_distance_cuda(q, corpus, frame_min)
    return corpus_min_distance_plain(q, corpus, frame_min)


def corpus_frame_min_xor(q: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """frame_min (N,) int32 alone through K2's frame_min-only instance (no
    per-query key work); the plain XOR version on CPU tensors."""
    _check_scan_inputs(q, corpus)
    if not q.is_cuda:
        return corpus_min_distance_plain(q, corpus, True)[0]
    dev, m, n = _check_kernel_inputs(q, corpus, "corpus-scan")
    fmin = torch.empty((n,), dtype=torch.int32, device=dev)
    p = backend.ptr
    K2.call("tvz_corpus_frame_min", p(q), m, p(corpus), n, p(fmin),
            backend.stream_ptr(dev))
    K2.launches += 1
    return fmin


# Per (device, stream): K4's key workspace (all ones) and its ticket (0).
# Each launch leaves both as it found them, so a call allocates neither.
_WORKSPACES: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scan_workspace(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES.setdefault(key, (
            torch.full((_MAX_QUERIES,), -1, dtype=torch.int64, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev)))
    return ws


def corpus_scan_tc(q: torch.Tensor, corpus: torch.Tensor, mode: str,
                   rows: Optional[torch.Tensor] = None
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """One mode of K4 (see ``MODES``): q (M, W), corpus (N, W) packed int32
    on one device -> (frame_min (N,) or None, q_min (M,) or None, q_arg (M,)
    or None), int32, as ``mode`` produces them. ``full_cols`` reads each
    row's index from ``rows``, an (N,) int32 tensor holding 0..N-1 (built
    here when None). CUDA tensors launch K4 (one persistent launch), CPU
    tensors run ``corpus_scan_pm1_plain``."""
    if mode not in _MODE_OUTPUTS:
        raise ValueError(f"unknown scan mode {mode!r}; one of {MODES}")
    _check_scan_inputs(q, corpus)
    if not q.is_cuda:
        return corpus_scan_pm1_plain(q, corpus, mode)
    dev, m, n = _check_kernel_inputs(q, corpus, "tensor-core scan")
    want_fmin, want_query = _MODE_OUTPUTS[mode]
    if mode == "full_cols":
        if rows is None:
            rows = torch.arange(n, dtype=torch.int32, device=dev)
        backend.require(rows, "rows", torch.int32, (n,), dev)
    else:
        rows = None
    empty = lambda shape: torch.empty(shape, dtype=torch.int32, device=dev)  # noqa: E731
    fmin = empty((n,)) if want_fmin else None
    q_min = empty((m,)) if want_query else None
    q_arg = empty((m,)) if want_query else None
    keys, ticket = _scan_workspace(dev) if want_query else (None, None)
    p = lambda t: None if t is None else backend.ptr(t)  # noqa: E731
    K4.call("tvz_corpus_scan_tc", p(q), m, p(corpus), n, p(rows),
            MODES.index(mode), p(fmin), p(keys), p(ticket), p(q_min), p(q_arg),
            backend.stream_ptr(dev))
    K4.launches += 1
    return fmin, q_min, q_arg


def corpus_scan_tc_grid(mode: str, n: int, device: torch.device) -> int:
    """The number of CTAs K4's ``mode`` launches on ``device`` for an
    ``n``-row corpus. CTA c walks the tiles ``[tiles c / grid, tiles (c+1) /
    grid)`` of 256 rows in ascending order, so tests can plant ties at the
    edges of the ranges the card really uses. Launches nothing."""
    if mode not in _MODE_OUTPUTS:
        raise ValueError(f"unknown scan mode {mode!r}; one of {MODES}")
    grid = ctypes.c_int(0)
    with torch.cuda.device(device):
        K4.call("tvz_corpus_scan_tc_grid", MODES.index(mode), int(n),
                ctypes.byref(grid))
    return grid.value


def corpus_query_nearest(q: torch.Tensor, corpus: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_min, q_arg) only — the nearest_video_counts verdict path, through
    K4's ``query_nearest`` mode (no frame_min store)."""
    _, q_min, q_arg = corpus_scan_tc(q, corpus, "query_nearest")
    return q_min, q_arg


def corpus_frame_min(q: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """frame_min only — the search_fingerprints evidence path, through K4's
    ``frame_min`` mode (no per-query key work)."""
    return corpus_scan_tc(q, corpus, "frame_min")[0]
