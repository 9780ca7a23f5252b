"""Packed-fingerprint Hamming distances and the corpus scan.

Port of ``tvidz_tpu/ops/hamming.py``. Fingerprints are (rows, W) int32
bit-views of the reference's uint32 words. ``corpus_min_distance`` has the
three-output contract of the reference's Pallas scans — per corpus row the
min distance over the queries, per query the min distance and the FIRST
row attaining it. On CUDA tensors it launches kernel K2
(``csrc/corpus_scan.cu``, which replaces ``_corpus_scan_kernel`` and
``_corpus_scan_kernel_mxu_twophase``; see its header note); on CPU tensors
it runs ``corpus_min_distance_plain``. Sentinel rows (all ones) and padding
are ordinary rows to both: the caller decides what a hit on them means, as
in the reference.

The corpus layout is row-major (N, W) — the host mirror's own layout. The
reference's word-major (W, N) device layout served TPU lanes; K2 reads one
8-byte row per thread instead.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tvidz_tpu_torch import backend

_p, _i = ctypes.c_void_p, ctypes.c_int
K2 = backend.register(backend.Kernel(
    "corpus_scan",
    replaces="tvidz_tpu/ops/hamming.py:442 (_corpus_scan_kernel_mxu_twophase); "
             "tvidz_tpu/ops/hamming.py:116 (_corpus_scan_kernel)",
    entry_points={
        "tvz_corpus_scan": [_p, _i, _p, _i, _p, _p, _p, _p, _p],
    },
))

_M32 = 0xFFFFFFFF
# Queries x corpus rows per block of the plain scan (bounds its memory).
_PLAIN_PAIRS = 1 << 20
_BIG = 1 << 30


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


def corpus_min_distance_plain(
    q: torch.Tensor, corpus: torch.Tensor, frame_min: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 on any device: (frame_min (N,) int32 or
    None, q_min (M,) int32, q_arg (M,) int32), blocked over the corpus;
    an earlier block keeps a tie (first-index argmin)."""
    m, n = q.shape[0], corpus.shape[0]
    block = max(1, _PLAIN_PAIRS // max(m, 1))
    fmin = torch.empty((n,), dtype=torch.int32, device=q.device) if frame_min else None
    q_min = torch.full((m,), _BIG, dtype=torch.int32, device=q.device)
    q_arg = torch.zeros((m,), dtype=torch.int32, device=q.device)
    for s in range(0, n, block):
        d = hamming_matrix(q, corpus[s:s + block])                  # (M, B)
        if fmin is not None:
            fmin[s:s + d.shape[1]] = d.min(dim=0).values
        blk_min, blk_arg = d.min(dim=1)      # first index among equal minima
        better = blk_min < q_min
        q_min = torch.where(better, blk_min, q_min)
        q_arg = torch.where(better, blk_arg.to(torch.int32) + s, q_arg)
    return fmin, q_min, q_arg


def _corpus_min_distance_cuda(q, corpus, frame_min):
    dev = q.device
    m, n = q.shape[0], corpus.shape[0]
    if q.shape[1] != 2 or corpus.shape[1] != 2:
        raise NotImplementedError(
            "the corpus-scan kernel takes 64-bit fingerprints (2 words), got "
            f"{q.shape[1]} and {corpus.shape[1]} words")
    backend.require(q, "queries", torch.int32, (m, 2), dev)
    backend.require(corpus, "corpus", torch.int32, (n, 2), dev)
    if not 1 <= m <= 16384 or not 1 <= n < 2 ** 31:
        raise ValueError(f"scan shape out of range: M={m}, N={n}")
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
    if q.ndim != 2 or corpus.ndim != 2 or q.shape[1] != corpus.shape[1]:
        raise ValueError(f"incompatible shapes {tuple(q.shape)} and "
                         f"{tuple(corpus.shape)}")
    if q.shape[0] == 0 or corpus.shape[0] == 0:
        raise ValueError("empty query or corpus")
    if q.device != corpus.device:
        raise ValueError(f"queries on {q.device}, corpus on {corpus.device}")
    if q.is_cuda:
        return _corpus_min_distance_cuda(q, corpus, frame_min)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return corpus_min_distance_plain(q, corpus, frame_min)


def corpus_query_nearest(q: torch.Tensor, corpus: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_min, q_arg) only — the nearest_video_counts verdict path; the
    kernel skips its frame_min store."""
    _, q_min, q_arg = corpus_min_distance(q, corpus, frame_min=False)
    return q_min, q_arg


def corpus_frame_min(q: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """frame_min only — the search_fingerprints evidence path."""
    return corpus_min_distance(q, corpus, frame_min=True)[0]
