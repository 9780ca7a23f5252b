"""Fingerprint sequence alignment for partial-reuse localization.

Port of ``tvidz_tpu/ops/align.py`` and of the Pallas fragment kernel's
wrappers (``tvidz_tpu/ops/align_pallas.py:208-320``). Given a query
fingerprint sequence and a candidate video's sequence, find the temporal
offset at which they best line up: one (Tq, Tc) Hamming matrix, thresholded
to a 0/1 match matrix, then anti-diagonal sums — ``score[o]`` counts query
frames t with q[t] matching c[t+o].

Output convention (the reference's, exactly): scores are indexed by
``d = o + Tq_pad - 1`` over the full ``Tq_pad + Tc - 1`` row, where Tq_pad is
the padded query length the caller passes; the answer is the first-index
argmax, reported as ``d - (Tq_pad - 1)``, so an all-zero row reports
``-(Tq_pad - 1)``. Counts accumulate in int32 (the reference's int8 staging
of its tree, ``align.py:72-85``, is not copied).

``fragment_search_batch`` / ``fragment_search`` launch kernel K3
(``csrc/fragment_search.cu``, int8 ±1 products on the tensor cores, rows of
any W from 1 to ``K3_MAX_WORDS`` words: W = 2 for the 64-bit pHash, 8 for
phash256, 32 at ``TVIDZ_HASH_SIZE=32``, 128 at ``TVIDZ_DCT_SIZE=64
TVIDZ_HASH_SIZE=64``; past 23 words the kernel walks them in chunks) on
CUDA tensors and run the plain versions
(``fragment_search_batch_plain`` / ``fragment_core``) on CPU tensors; there
is no fallback between the two. Fingerprints are int32 bit-views of the
reference's uint32 words.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.ops.hamming import hamming_matrix

_p, _i = ctypes.c_void_p, ctypes.c_int
K3 = backend.register(backend.Kernel(
    "fragment_search",
    replaces="tvidz_tpu/ops/align_pallas.py:91 (_fragment_kernel)",
    entry_points={
        "tvz_fragment_search": [_p, _p, _i, _i, _p, _p, _i, _i, _i, _i,
                                _p, _p, _p, _p],
    },
))

# The widest rows K3 takes (kMaxKeyWords in its source): its match gate
# 32·W - 2·thr stays an int32. Shared memory sets no limit (wide rows walk
# their words in chunks).
K3_MAX_WORDS = 1 << 24
# int32 elements per step of the plain versions (bounds their memory: the
# Hamming matrix and the skewed match matrix of a group of videos).
_PLAIN_ELEMS = 1 << 22


def _diag_scores(match: torch.Tensor) -> torch.Tensor:
    """Anti-diagonal sums of (..., m, n) match matrices -> (..., m + n - 1)
    int32: ``scores[d] = sum_t match[t, d - (m-1) + t]``.

    Row t of the row-reversed matrix is shifted right by t with a strided
    view: padded to width L = n + m and read with row stride L - 1, every
    out-of-row position lands in the zero padding."""
    *lead, m, n = match.shape
    width = n + m
    x = torch.nn.functional.pad(match.to(torch.int32).flip(-2), (0, m))
    x = x.reshape(-1, m, width).contiguous()
    skew = x.as_strided((x.shape[0], m, n + m - 1), (m * width, width - 1, 1),
                        x.storage_offset())
    return skew.sum(dim=1, dtype=torch.int32).reshape(*lead, n + m - 1)


def _first_argmax(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first index of the maximum, the maximum) along the last axis, int32."""
    best = s.max(dim=-1, keepdim=True).values
    idx = torch.arange(s.shape[-1], dtype=torch.int32, device=s.device)
    big = torch.full_like(s, s.shape[-1])
    first = torch.where(s == best, idx, big).min(dim=-1).values
    return first.to(torch.int32), best[..., 0]


def align_scores(q_fp: torch.Tensor, c_fp: torch.Tensor,
                 hamming_threshold: int = 10) -> torch.Tensor:
    """(Tq, W) x (Tc, W) packed -> (Tq + Tc - 1,) int32 offset scores; entry
    o + Tq - 1 counts t with hamming(q[t], c[t+o]) <= threshold."""
    return _diag_scores(hamming_matrix(q_fp, c_fp) <= hamming_threshold)


def best_alignment(q_fp: torch.Tensor, c_fp: torch.Tensor,
                   hamming_threshold: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_offset_frames, match_count) — the first argmax of align_scores."""
    arg, best = _first_argmax(align_scores(q_fp, c_fp, hamming_threshold))
    return arg - (q_fp.shape[0] - 1), best


def fragment_chunk(local_v: int) -> int:
    """The reference's chunk-divisor policy (the largest of 16, 8, 4, 2, 1
    dividing the video count) — the default video group of ``fragment_core``
    when the plain scan's memory bound allows it."""
    return next(c for c in (16, 8, 4, 2, 1) if local_v % c == 0)


def fragment_core(
    q_fp: torch.Tensor,                 # (Tq_pad, W); rows >= q_len are padding
    q_len: Union[int, torch.Tensor],    # number of REAL query rows
    corpus_fp: torch.Tensor,            # (V, Tc, W) padded candidates
    corpus_len: torch.Tensor,           # (V,) valid lengths
    hamming_threshold: int,
    chunk: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 for one query, on any device: (V,) int32
    best offsets and (V,) int32 match counts, exactly ``fragment_core`` of
    the reference. Videos are scanned ``chunk`` at a time (default: the
    reference's ``fragment_chunk``, capped so a group stays within the
    plain scan's memory bound)."""
    tq = q_fp.shape[0]
    v, tc, _ = corpus_fp.shape
    dev = q_fp.device
    row_valid = (torch.arange(tq, device=dev)
                 < torch.as_tensor(q_len, device=dev))[:, None]     # (Tq, 1)
    cols = torch.arange(tc, device=dev)
    lens = corpus_len.to(device=dev, dtype=torch.int64)
    group = chunk or fragment_chunk(v)
    group = max(1, min(group, _PLAIN_ELEMS // (tq * (tc + tq))))
    offs, scores = [], []
    for s in range(0, v, group):
        c = corpus_fp[s:s + group]
        b = c.shape[0]
        h = hamming_matrix(q_fp, c.reshape(b * tc, -1)).reshape(tq, b, tc)
        col_valid = cols[None, :] < lens[s:s + b, None]            # (B, Tc)
        match = ((h.permute(1, 0, 2) <= hamming_threshold)
                 & row_valid[None] & col_valid[:, None, :])
        arg, best = _first_argmax(_diag_scores(match))
        offs.append(arg - (tq - 1))
        scores.append(best)
    return torch.cat(offs), torch.cat(scores)


def batch_best_alignment(
    q_fp: torch.Tensor,             # (Tq, W) query sequence
    corpus_fp: torch.Tensor,        # (V, Tc, W) padded candidate sequences
    corpus_fp_len: torch.Tensor,    # (V,) valid lengths
    hamming_threshold: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best (offset, score) of the whole query inside each of V candidates
    (positions >= corpus_fp_len are masked; every query row counts)."""
    return fragment_core(q_fp, q_fp.shape[0], corpus_fp, corpus_fp_len,
                         hamming_threshold)


def fragment_search_batch_plain(
    q_fps: torch.Tensor, q_lens: torch.Tensor, corpus: torch.Tensor,
    lens: torch.Tensor, hamming_threshold: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 on any device: Q queries, (Q, V) int32
    offsets and scores, row q equal to ``fragment_core`` of query q."""
    rows = [fragment_core(q_fps[i], q_lens[i], corpus, lens, hamming_threshold)
            for i in range(q_fps.shape[0])]
    return (torch.stack([r[0] for r in rows]),
            torch.stack([r[1] for r in rows]))


def _fragment_search_cuda(q_fps, q_lens, corpus, lens, thr):
    """One launch of K3 (after the checks its C entry point relies on)."""
    dev = q_fps.device
    qn, tq_pad, w = q_fps.shape
    v, tc, _ = corpus.shape
    if not 1 <= w <= K3_MAX_WORDS:
        raise ValueError(f"the fragment-search kernel takes rows of "
                         f"1..{K3_MAX_WORDS} words, got {w}")
    backend.require(q_fps, "queries", torch.int32, (qn, tq_pad, w), dev)
    backend.require(q_lens, "query lengths", torch.int32, (qn,), dev)
    backend.require(corpus, "corpus", torch.int32, (v, tc, w), dev)
    backend.require(lens, "corpus lengths", torch.int32, (v,), dev)
    if not 1 <= qn <= 65535 or tq_pad + tc >= 2 ** 31 or qn * v >= 2 ** 31:
        raise ValueError(f"fragment search shape out of range: Q={qn}, "
                         f"Tq_pad={tq_pad}, V={v}, Tc={tc}")
    keys = torch.empty((qn, v), dtype=torch.int64, device=dev)
    offs = torch.empty((qn, v), dtype=torch.int32, device=dev)
    scores = torch.empty((qn, v), dtype=torch.int32, device=dev)
    p = backend.ptr
    K3.launch("tvz_fragment_search", dev, p(q_fps), p(q_lens), qn, tq_pad,
              p(corpus), p(lens), v, tc, w, int(thr), p(keys), p(offs),
              p(scores))
    return offs, scores


def fragment_search_batch(
    q_fps: torch.Tensor,        # (Q, Tq_pad, W) packed queries (padded rows)
    q_lens: torch.Tensor,       # (Q,) int32 REAL rows per query
    corpus: torch.Tensor,       # (V, Tc, W) padded candidates
    lens: torch.Tensor,         # (V,) int32 valid lengths
    hamming_threshold: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best (offset, score) of each of Q query fragments inside each of V
    candidate sequences: ((Q, V) int32 offsets, (Q, V) int32 scores). CUDA
    tensors go to kernel K3, CPU tensors to the plain version."""
    if q_fps.ndim != 3 or corpus.ndim != 3 or q_fps.shape[2] != corpus.shape[2]:
        raise ValueError(f"incompatible shapes {tuple(q_fps.shape)} and "
                         f"{tuple(corpus.shape)}")
    if 0 in q_fps.shape or 0 in corpus.shape:
        raise ValueError("empty query or corpus")
    if len({q_fps.device, q_lens.device, corpus.device, lens.device}) != 1:
        raise ValueError("queries, lengths and corpus must share a device")
    if q_fps.is_cuda:
        return _fragment_search_cuda(q_fps, q_lens, corpus, lens,
                                     hamming_threshold)
    if q_fps.device.type != "cpu":
        raise ValueError(f"unsupported device {q_fps.device}")
    return fragment_search_batch_plain(q_fps, q_lens, corpus, lens,
                                       hamming_threshold)


def fragment_search(
    q_fp: torch.Tensor,                 # (Tq_pad, W)
    q_len: Union[int, torch.Tensor],    # REAL query rows
    corpus: torch.Tensor,               # (V, Tc, W)
    lens: torch.Tensor,                 # (V,)
    hamming_threshold: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Q=1 case of ``fragment_search_batch``: (V,) offsets and scores."""
    q_lens = torch.as_tensor(q_len, dtype=torch.int32,
                             device=q_fp.device).reshape(1)
    offs, scores = fragment_search_batch(q_fp[None], q_lens, corpus, lens,
                                         hamming_threshold)
    return offs[0], scores[0]
