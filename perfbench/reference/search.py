"""Nearest rows, fingerprint evidence, timestamp matches and fragment
alignment over packed fingerprints, from their definitions.

A fingerprint is W 32-bit words; the Hamming distance of two is the number
of differing bits. As a ±1 vector per bit (1 - 2·bit), two fingerprints'
dot product is 32·W - 2·distance, so distances come from one matrix
product, exact in float16 with float32 or float16 sums up to W = 64 (every
partial sum is an integer below 2048) and in float32 on the CPU.

- ``nearest``: per query row, the least distance to any catalog row and the
  first row that attains it.
- ``evidence``: per catalog video, the query rows whose nearest row is one
  of its rows, within the threshold (the analyzer's fingerprint evidence).
- ``timestamp_matches``: per catalog video, the query timestamps that equal
  one of its own (compared as float32, as stored), kept at ``min_match`` or
  more.
- ``Catalog.align``: for a query run of frames and each catalog video, the offset o
  that counts the most frames t with distance(q[t], c[t + o]) at or below
  the threshold (the first such o), the video's score; videos with a score
  above 0, best first, in catalog order among equals.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _pm1(words: np.ndarray, device, dtype) -> torch.Tensor:
    """(N, W) uint32 -> (N, 32·W) ±1 (bit 1 -> -1), most significant first."""
    w = torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)
    shifts = 31 - torch.arange(32, device=device, dtype=torch.int32)
    bits = (w[..., None] >> shifts) & 1
    return (1 - 2 * bits).reshape(w.shape[0], -1).to(dtype)


def _dtype(device) -> torch.dtype:
    return torch.float16 if torch.device(device).type == "cuda" else torch.float32


def nearest(queries: np.ndarray, rows: np.ndarray, device,
            elems: int = 1 << 30) -> Tuple[np.ndarray, np.ndarray]:
    """((M,) int64 least distance, (M,) int64 first row attaining it) of
    each query row against ``rows`` (N, W) uint32, in blocks of at most
    ``elems`` products."""
    m, words = queries.shape
    bits = 32 * words
    dt = _dtype(device)
    best = np.full(m, 1 << 30, np.int64)
    arg = np.zeros(m, np.int64)
    q_block = min(m, 1024) or 1
    r_block = max(1, elems // q_block)
    for s in range(0, rows.shape[0], r_block):
        c = _pm1(rows[s:s + r_block], device, dt)
        for a in range(0, m, q_block):
            q = _pm1(queries[a:a + q_block], device, dt)
            top, at = torch.matmul(q, c.T).max(dim=1)
            dist = ((bits - top.to(torch.float32)) * 0.5).round().to(torch.int64)
            dist, at = dist.cpu().numpy(), at.cpu().numpy() + s
            better = dist < best[a:a + q_block]
            best[a:a + q_block] = np.where(better, dist, best[a:a + q_block])
            arg[a:a + q_block] = np.where(better, at, arg[a:a + q_block])
    return best, arg


def evidence(dist: np.ndarray, row: np.ndarray, row_video: np.ndarray,
             threshold: int, exclude: Optional[int]) -> Dict[int, int]:
    """{video: query rows whose nearest row is that video's, within the
    threshold}; rows of no video (-1) and the excluded video give none."""
    out: Dict[int, int] = {}
    for d, r in zip(dist.tolist(), row.tolist()):
        if d <= threshold and r < len(row_video):
            v = int(row_video[r])
            if v >= 0 and v != exclude:
                out[v] = out.get(v, 0) + 1
    return out


def timestamp_matches(query: Sequence[float],
                      catalog: Sequence[Tuple[int, Sequence[float]]],
                      min_match: int, exclude: Optional[int],
                      max_cuts: int = 128) -> List[Tuple[int, int]]:
    """Sorted [(video, matching query timestamps)] with at least
    ``min_match``; each side keeps its first ``max_cuts`` timestamps."""
    q = set(np.asarray(list(query)[:max_cuts], np.float32).tolist())
    out = []
    for vid, ts in catalog:
        if vid == exclude:
            continue
        own = set(np.asarray(list(ts)[:max_cuts], np.float32).tolist())
        n = len(q & own)
        if n >= min_match:
            out.append((int(vid), n))
    return sorted(out)


class Catalog:
    """Catalog videos as ±1 rows on the device, unpacked once, for
    ``align``; ``videos`` [(video, (T, W) uint32)] in catalog order."""

    def __init__(self, videos: Sequence[Tuple[int, np.ndarray]], device,
                 chunk: int = 1 << 20):
        self.device = device
        self.vids = [int(v) for v, fp in videos if len(fp)]
        lens = [len(fp) for _, fp in videos if len(fp)]
        self.starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        rows = np.concatenate([fp for _, fp in videos if len(fp)])
        self.words = rows.shape[1]
        dt = _dtype(device)
        self.pm1 = torch.empty((rows.shape[0], 32 * self.words), dtype=dt,
                               device=device)
        for s in range(0, rows.shape[0], chunk):
            self.pm1[s:s + chunk] = _pm1(rows[s:s + chunk], device, dt)

    def align(self, query: np.ndarray, threshold: int, top_k: int,
              exclude: Optional[int], elems: int = 1 << 30
              ) -> List[Tuple[int, int, int]]:
        """[(video, offset, score)] of the ``top_k`` best-scoring videos for
        the (Tq, W) uint32 ``query``."""
        tq = query.shape[0]
        bits = 32 * self.words
        q = _pm1(query, self.device, self.pm1.dtype)
        n = self.pm1.shape[0]
        block = max(1, elems // max(tq, 1))
        vs, os_ = [], []
        for s in range(0, n, block):
            dot = torch.matmul(q, self.pm1[s:s + block].T)
            t, r = torch.nonzero(dot >= bits - 2 * threshold, as_tuple=True)
            r = r.cpu().numpy() + s
            t = t.cpu().numpy()
            v = np.searchsorted(self.starts, r, side="right") - 1
            vs.append(v)
            os_.append(r - self.starts[v] - t)
        v = np.concatenate(vs)
        o = np.concatenate(os_)
        scores: Dict[int, Dict[int, int]] = {}
        for vi, oi in zip(v.tolist(), o.tolist()):
            if self.vids[vi] == exclude:
                continue
            per = scores.setdefault(vi, {})
            per[oi] = per.get(oi, 0) + 1
        best = []
        for vi in sorted(scores):
            per = scores[vi]
            top = max(per.values())
            best.append((vi, min(k for k, c in per.items() if c == top), top))
        best.sort(key=lambda x: -x[2])
        return [(self.vids[vi], int(off), int(sc)) for vi, off, sc in best[:top_k]]
