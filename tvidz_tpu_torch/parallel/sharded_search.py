"""Corpus-sharded search over a device mesh.

Port of ``tvidz_tpu/parallel/sharded_search.py`` (single process; the
multi-process placement is ``parallel/distributed.py``, which runs these
searches over each rank's local mesh). The corpus lives
sharded over the mesh's ``corpus`` axis; each shard computes local evidence
with the port's kernels on its own device, and only the small per-shard
vectors travel: where the reference's shard_map ``all_gather``s them, the
port concatenates them in shard order on the mesh's first device (or
merges them there), which is where every result lands.

A sharded tensor is a ``Sharded``: one tensor per mesh cell, laid out as
the reference's ``NamedSharding`` lays it (block c of the rows on the cells
of corpus column c, replicated over ``data``; or block d on data row d;
or the whole tensor everywhere). Every function takes a ``Sharded`` or a
plain tensor, which it places first. Corpus-axis work runs once per shard,
on data row 0's cells; the 2-D batch (``sharded_fragment_search_batch``)
and ``step.multichip_analysis_step`` use every cell.

On CUDA tensors ``sharded_frame_min(_rows)`` and ``sharded_nearest`` launch
K4 per shard, ``sharded_fragment_search(_batch)`` K3 per shard (or tile);
on CPU tensors they run the kernels' plain versions. Timestamp matching and
``sharded_hamming_topk`` are plain torch, as they are XLA in the reference,
but for the top-1 (the multi-host verdict's nearest row), which is K4
``query_nearest``'s function and runs on it per shard.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tvidz_tpu_torch.ops.align import fragment_search, fragment_search_batch
from tvidz_tpu_torch.ops.hamming import (
    corpus_frame_min,
    corpus_query_nearest,
    hamming_matrix,
)
from tvidz_tpu_torch.ops.timestamps import timestamp_match_counts
from tvidz_tpu_torch.parallel.mesh import CORPUS_AXIS, DATA_AXIS, Mesh

# Distance assigned to masked (padding) rows in top-k queries; any result
# at or above this is not a real neighbour.
_TOPK_INVALID = 1 << 20
# Queries x corpus rows per block of the top-k's distance matrix.
_TOPK_PAIRS = 1 << 20


class Sharded:
    """A global tensor of ``shape`` laid out over ``mesh`` along ``axis``
    (``CORPUS_AXIS``, ``DATA_AXIS`` or None for replicated): ``local[d][c]``
    is the block cell (d, c) holds. Cells on one device share a tensor."""

    def __init__(self, mesh: Mesh, axis: Optional[str],
                 local: List[List[torch.Tensor]], shape: Tuple[int, ...]):
        self.mesh, self.axis, self.local, self.shape = mesh, axis, local, shape

    @property
    def block_rows(self) -> int:
        return self.shape[0] // (1 if self.axis is None else self.mesh.shape[self.axis])

    def block(self, d: int, c: int) -> torch.Tensor:
        return self.local[d][c]


def _to(block, device: torch.device) -> torch.Tensor:
    if isinstance(block, np.ndarray):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(device)


def place(x, mesh: Mesh, axis: Optional[str] = None,
          put: Optional[Callable[[np.ndarray, torch.device], torch.Tensor]] = None,
          keep: Optional[Sharded] = None, dirty=()) -> Sharded:
    """Lay ``x`` (a numpy array or tensor whose rows divide evenly over
    ``axis``) out over ``mesh``. Each block leaves ``x`` once, for the
    first cell that holds it (through ``put(host_block, device)`` where
    given); every other device holding it gets a device-to-device copy of
    that tensor. With ``keep`` (a ``Sharded`` of the same layout), only the
    blocks in ``dirty`` are placed anew and the others are kept."""
    n = 1 if axis is None else mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over the {axis} "
                         f"axis of {n}")
    rows = x.shape[0] // n
    on_device: Dict[Tuple[torch.device, int], torch.Tensor] = {}
    first: Dict[int, torch.Tensor] = {}
    local = []
    for d, devices in enumerate(mesh.devices):
        cells = []
        for c, dev in enumerate(devices):
            k = c if axis == CORPUS_AXIS else d if axis == DATA_AXIS else 0
            t = on_device.get((dev, k))
            if t is None:
                if keep is not None and k not in dirty:
                    t = keep.local[d][c]
                elif k in first:
                    t = first[k].to(dev)
                else:
                    block = x[k * rows:(k + 1) * rows]
                    t = first[k] = put(block, dev) if put else _to(block, dev)
                on_device[(dev, k)] = t
            cells.append(t)
        local.append(cells)
    return Sharded(mesh, axis, local, tuple(x.shape))


def as_sharded(x, mesh: Mesh, axis: Optional[str]) -> Sharded:
    """``x`` itself when it is a ``Sharded`` of that layout, else ``place``d."""
    if isinstance(x, Sharded):
        if x.mesh is not mesh or x.axis != axis:
            raise ValueError(f"tensor sharded over {x.axis!r} of another mesh "
                             f"where {axis!r} of this one is needed")
        return x
    return place(x, mesh, axis)


def _gather(parts: Sequence[torch.Tensor], mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The reference's tiled ``all_gather``: the parts concatenated in
    order on the mesh's first device."""
    return torch.cat([p.to(mesh.home) for p in parts], dim=dim)


def sharded_timestamp_match(
    query_ts,                   # (K,) float32, NaN-padded — replicated
    corpus_ts,                  # (N, MAX) float32 — sharded over corpus
    corpus_len,                 # (N,) int32 — sharded over corpus
    mesh: Mesh,
    tolerance: float = 0.0,
) -> torch.Tensor:
    """(N,) int32 match counts: ``ops/timestamps``' blocked
    ``match_counts_block`` per shard; N must divide by the corpus axis."""
    q = as_sharded(query_ts, mesh, None)
    ts = as_sharded(corpus_ts, mesh, CORPUS_AXIS)
    ln = as_sharded(corpus_len, mesh, CORPUS_AXIS)
    return _gather([timestamp_match_counts(q.block(0, s), ts.block(0, s),
                                           ln.block(0, s), tolerance=tolerance)
                    for s in range(mesh.shape[CORPUS_AXIS])], mesh)


def _smallest(d: torch.Tensor, idx: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row the ``k`` smallest of ``d`` with their ``idx``, equal
    distances in column order (a stable sort: ``torch.topk`` promises no
    order among ties, ``jax.lax.top_k`` gives the lower index first)."""
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return d.gather(1, order), idx.gather(1, order)


def sharded_hamming_topk(
    query_fp,                   # (M, W) int32 — replicated
    corpus_fp,                  # (N, W) int32 — sharded over corpus
    mesh: Mesh,
    k: int = 16,
    valid=None,                 # (N,) bool — sharded over corpus
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k nearest corpus fingerprints per query: (distances (M,
    k) int32 ascending, indices (M, k) int32 global), equal distances in
    ascending global index. Per shard, the distances of each block of rows
    are cut to their k smallest, then the shard's blocks, then the shards'
    candidates are merged (each merge keeps the candidates in ascending
    index among equal distances). ``valid`` masks padding rows to
    ``_TOPK_INVALID``: an all-ones pad row sits at 64 - popcount(q) from a
    query and would outrank real rows of ones-heavy queries."""
    q = as_sharded(query_fp, mesh, None)
    c = as_sharded(corpus_fp, mesh, CORPUS_AXIS)
    ok = None if valid is None else as_sharded(valid, mesh, CORPUS_AXIS)
    n, local_n = c.shape[0], c.block_rows
    k = min(k, n)  # can't return more neighbours than corpus rows
    k_local = min(k, local_n)
    dists, idxs = [], []
    for s in range(mesh.shape[CORPUS_AXIS]):
        qq, cc = q.block(0, s), c.block(0, s)
        mask = None if ok is None else ok.block(0, s)
        if k_local == 1 and qq.shape[0]:
            d, i = _shard_nearest(qq, cc, mask, s * local_n)
        else:
            d, i = _shard_topk(qq, cc, mask, s * local_n, k_local)
        dists.append(d)
        idxs.append(i)
    return _smallest(_gather(dists, mesh, 1), _gather(idxs, mesh, 1), k)


def _shard_topk(qq, cc, mask, base: int, k: int):
    """One shard's ``k`` nearest rows (global indices from ``base``) by
    blocks of the distance matrix, masked rows at ``_TOPK_INVALID``."""
    step = max(1, _TOPK_PAIRS // max(qq.shape[0], 1))
    cand_d, cand_i = [], []
    for r in range(0, cc.shape[0], step):
        d = hamming_matrix(qq, cc[r:r + step])
        if mask is not None:
            d = torch.where(mask[r:r + step][None, :], d, _TOPK_INVALID)
        i = torch.arange(base + r, base + r + d.shape[1], dtype=torch.int32,
                         device=d.device)
        top = _smallest(d, i.expand_as(d), k)
        cand_d.append(top[0])
        cand_i.append(top[1])
    return _smallest(torch.cat(cand_d, 1), torch.cat(cand_i, 1), k)


def _shard_nearest(qq, cc, mask, base: int):
    """One shard's nearest row per query, as ``_shard_topk(..., 1)``: K4
    ``query_nearest`` gives the least distance and the first row at it.
    Where that row is valid it is also the first valid row at the least
    valid distance; queries whose row is masked take ``_shard_topk``."""
    d, arg = corpus_query_nearest(qq, cc)
    d, i = d[:, None], (arg + base)[:, None]
    if mask is not None:
        redo = (~mask[arg.long()]).nonzero()[:, 0]
        if redo.numel():
            d[redo], i[redo] = _shard_topk(qq[redo], cc, mask, base, 1)
    return d, i


def sharded_frame_min(
    q,                          # (M, W) int32 — replicated
    corpus_fp,                  # (N, W) int32 row-major — sharded over N
    mesh: Mesh,
) -> torch.Tensor:
    """(N,) int32: per corpus fingerprint, the min Hamming distance over
    the queries — K4 ``frame_min`` (``ops/hamming.corpus_frame_min``) on
    each shard, gathered in shard order."""
    qs = as_sharded(q, mesh, None)
    c = as_sharded(corpus_fp, mesh, CORPUS_AXIS)
    return _gather([corpus_frame_min(qs.block(0, s), c.block(0, s))
                    for s in range(mesh.shape[CORPUS_AXIS])], mesh)


# The reference's row-major variant (it serves ShardedCorpus's (N, W)
# layout beside MeshCorpus's word-major one). The port's corpus is
# row-major everywhere, so the two are one function.
sharded_frame_min_rows = sharded_frame_min


def sharded_nearest(
    q,                          # (M, W) int32 — replicated
    corpus_fp,                  # (N, W) int32 row-major — sharded over N
    mesh: Mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query row: (global min distance (M,), global argmin index (M,)),
    int32 — K4 ``query_nearest`` on each shard (the mode
    ``DeviceCorpus.nearest_video_counts`` runs), merged on the first
    device. Each shard's argmin is its first row attaining the min, and the
    merge takes the FIRST minimal shard, so a tie resolves to the lowest
    global index, as on one card."""
    qs = as_sharded(q, mesh, None)
    c = as_sharded(corpus_fp, mesh, CORPUS_AXIS)
    n_shards = mesh.shape[CORPUS_AXIS]
    per_shard = [corpus_query_nearest(qs.block(0, s), c.block(0, s))
                 for s in range(n_shards)]
    all_min = _gather([m[None] for m, _ in per_shard], mesh)         # (S, M)
    all_arg = _gather([(a + s * c.block_rows)[None]
                       for s, (_, a) in enumerate(per_shard)], mesh)
    best = all_min.min(dim=0).values
    shard = torch.arange(n_shards, device=all_min.device)[:, None]
    first = torch.where(all_min == best, shard, n_shards).min(dim=0).values
    return best, all_arg.gather(0, first[None])[0]


def sharded_fragment_search(
    q_fp,                       # (Tq_pad, W) int32 — replicated
    q_len,                      # REAL query rows (int or 0-d tensor)
    corpus_fp,                  # (V, Tc, W) alignment index — sharded over V
    corpus_len,                 # (V,) int32 — sharded over V
    mesh: Mesh,
    hamming_threshold: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fragment localization across a video-sharded alignment index: K3
    (``ops/align.fragment_search``) on each shard's videos, the (V,)
    best-offset and best-score vectors gathered in shard order."""
    q = as_sharded(q_fp, mesh, None)
    fp = as_sharded(corpus_fp, mesh, CORPUS_AXIS)
    ln = as_sharded(corpus_len, mesh, CORPUS_AXIS)
    outs = [fragment_search(q.block(0, s), q_len, fp.block(0, s), ln.block(0, s),
                            hamming_threshold)
            for s in range(mesh.shape[CORPUS_AXIS])]
    return (_gather([o for o, _ in outs], mesh),
            _gather([sc for _, sc in outs], mesh))


def sharded_fragment_search_batch(
    q_fp,                       # (Q, Tq_pad, W) int32 — sharded over Q (data)
    q_len,                      # (Q,) int32 — sharded over Q (data)
    corpus_fp,                  # (V, Tc, W) alignment index — sharded over V
    corpus_len,                 # (V,) int32 — sharded over V
    mesh: Mesh,
    hamming_threshold: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch fragment localization over both mesh axes: queries over
    ``data``, videos over ``corpus``, one K3 launch
    (``ops/align.fragment_search_batch``) per (Q/data, V/corpus) tile on
    its cell. Returns (Q, V) offsets and (Q, V) scores on the first
    device. Q must divide by the data axis, V by the corpus axis."""
    q = as_sharded(q_fp, mesh, DATA_AXIS)
    ql = as_sharded(q_len, mesh, DATA_AXIS)
    fp = as_sharded(corpus_fp, mesh, CORPUS_AXIS)
    ln = as_sharded(corpus_len, mesh, CORPUS_AXIS)
    tiles = [[fragment_search_batch(q.block(d, c), ql.block(d, c),
                                    fp.block(d, c), ln.block(d, c),
                                    hamming_threshold)
              for c in range(mesh.shape[CORPUS_AXIS])]
             for d in range(mesh.shape[DATA_AXIS])]
    return tuple(_gather([_gather([t[j] for t in row], mesh, 1) for row in tiles],
                         mesh)
                 for j in (0, 1))


def build_fragment_query_batch(
    query_fps_list, words: int, data_n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side batch-query packing shared by MeshCorpus.locate_fragments
    and MultiHostShardedCorpus.fragment_search_batch (one implementation so
    the single-host and multi-host result contracts can't diverge).

    Returns a sentinel-padded (Q_pad, Tq_pad, W) uint32 buffer and (Q_pad,)
    int32 lengths: Tq padded to a multiple of 64 (>=64), Q padded to a
    multiple of the data axis; empty queries keep length 0 (their validity
    mask empties, so they rank to [])."""
    qn = len(query_fps_list)
    tq_max = max((int(np.asarray(q).shape[0]) for q in query_fps_list),
                 default=0)
    tq_pad = max(64, -(-max(tq_max, 1) // 64) * 64)
    q_pad = -(-max(qn, 1) // data_n) * data_n
    qbuf = np.full((q_pad, tq_pad, words), 0xFFFFFFFF, np.uint32)
    qlens = np.zeros(q_pad, np.int32)
    for i, q in enumerate(query_fps_list):
        q = np.asarray(q, np.uint32)
        qbuf[i, : q.shape[0]] = q
        qlens[i] = q.shape[0]
    return qbuf, qlens


def rank_fragment_hits(all_vids, all_offs, all_scores,
                       exclude_video_ids, top_k: int):
    """Vectorized (Q, V) -> per-query [(video_id, offset, score)] lists,
    shared by the single-host and multi-host batch paths. Disqualifies
    tombstoned rows (vid < 0), per-query exclusions and zero scores
    (padding-artifact rows are not matches); one (Q, V) mask + top-k
    instead of a Python double loop so the host share doesn't scale with
    Q x V (VERDICT r2 #5)."""
    all_scores = np.asarray(all_scores)
    all_offs = np.asarray(all_offs)
    vids = np.asarray(all_vids, np.int64)
    qn = all_scores.shape[0]
    vtot = vids.shape[0]
    if vtot == 0:
        return [[] for _ in range(qn)]
    excl = exclude_video_ids or [None] * qn
    excl_arr = np.asarray(
        [x if x is not None else -(1 << 31) for x in excl], np.int64)
    ranked = np.where(
        (vids[None, :] >= 0)
        & (vids[None, :] != excl_arr[:, None])
        & (all_scores > 0),
        all_scores, -1,
    )
    k = min(top_k, vtot)
    if vtot > 4096 and k < vtot:
        # argpartition bounds the sort to O(V + k log k) per query. The
        # partition key is the COMPOSITE (-score, index) rank — score
        # scaled past the index range — so equal-score ties at the
        # partition boundary admit exactly the members the stable order
        # below would (otherwise /search/fragments could name a different
        # equal-score video than /search/fragment at large corpora).
        key = ranked * np.int64(vtot + 1) - np.arange(vtot, dtype=np.int64)
        cand = np.argpartition(-key, k - 1, axis=1)[:, :k]
    else:
        cand = np.argsort(-ranked, axis=1, kind="stable")[:, :k]
    rows = np.arange(qn)[:, None]
    cand_scores = ranked[rows, cand]
    # Stable (-score, index) order within the candidate set — matches the
    # single-query path's tie-breaking.
    order = np.lexsort((cand, -cand_scores), axis=1)
    cand = np.take_along_axis(cand, order, axis=1)
    cand_scores = np.take_along_axis(cand_scores, order, axis=1)
    out = []
    for i in range(qn):
        row = []
        for j in range(k):
            if cand_scores[i, j] <= 0:
                break
            c = cand[i, j]
            row.append((int(vids[c]), int(all_offs[i, c]),
                        int(cand_scores[i, j])))
        out.append(row)
    return out


class ShardedCorpus:
    """Host-side wrapper placing corpus arrays sharded over the corpus axis
    and issuing sharded queries. The multi-card sibling of DeviceCorpus
    (same padded layout; rows padded to a multiple of the corpus axis)."""

    def __init__(self, mesh: Mesh, max_cuts: int = 128, words: int = 2):
        self.mesh = mesh
        self.max_cuts = max_cuts
        self.words = words
        self.n_shards = mesh.shape[CORPUS_AXIS]
        self.corpus_ts: Optional[Sharded] = None
        self.corpus_len: Optional[Sharded] = None
        self.video_ids = None
        self.corpus_fp: Optional[Sharded] = None
        self.corpus_fp_valid: Optional[Sharded] = None
        self.fp_video_ids = None

    def _pad_rows(self, n: int, multiple: int) -> int:
        m = multiple * self.n_shards
        return -(-n // m) * m

    def ts_layout(self, rows, video_ids, min_rows: int = 0):
        """Padded global timestamp layout (NaN fill, FIRST-max_cuts
        truncation, -1 vid padding). ``min_rows`` reserves slack capacity
        for collective appends."""
        n = max(len(rows), 1, min_rows)
        n_pad = self._pad_rows(n, 8)
        ts = np.full((n_pad, self.max_cuts), np.nan, np.float32)
        lens = np.zeros(n_pad, np.int32)
        vids = np.full(n_pad, -1, np.int32)
        for i, (row, vid) in enumerate(zip(rows, video_ids)):
            row = list(row)[: self.max_cuts]
            ts[i, : len(row)] = row
            lens[i] = len(row)
            vids[i] = vid
        return ts, lens, vids

    def fp_layout(self, fp: np.ndarray, fp_video_ids: np.ndarray,
                  min_rows: int = 0):
        """Padded global fingerprint layout (sentinel fill, rows a multiple
        of 128 per shard, as the reference's) — shared like ts_layout."""
        n = fp.shape[0]
        n_pad = self._pad_rows(max(n, 1, min_rows), 128)
        buf = np.full((n_pad, self.words), 0xFFFFFFFF, np.uint32)
        buf[:n] = fp
        vids = np.full(n_pad, -1, np.int32)
        vids[:n] = fp_video_ids
        return buf, vids

    def load_timestamps(self, rows, video_ids) -> None:
        """rows: list of float lists; video_ids: parallel list of ints."""
        ts, lens, vids = self.ts_layout(rows, video_ids)
        self.corpus_ts = place(ts, self.mesh, CORPUS_AXIS)
        self.corpus_len = place(lens, self.mesh, CORPUS_AXIS)
        self.video_ids = vids

    def load_fingerprints(self, fp: np.ndarray, fp_video_ids: np.ndarray) -> None:
        buf, vids = self.fp_layout(fp, fp_video_ids)
        self.corpus_fp = place(buf.view(np.int32), self.mesh, CORPUS_AXIS)
        self.corpus_fp_valid = place(vids >= 0, self.mesh, CORPUS_AXIS)
        self.fp_video_ids = vids

    def match_timestamps(
        self, query_ts, min_match: int = 2, tolerance: float = 0.0,
        exclude_video_id: Optional[int] = None,
    ):
        if self.corpus_ts is None:
            return []
        q = np.full(self.max_cuts, np.nan, np.float32)
        # Keep the FIRST max_cuts — the store/DeviceCorpus truncation.
        take = list(query_ts)[: self.max_cuts]
        q[: len(take)] = take
        counts = sharded_timestamp_match(
            torch.from_numpy(q), self.corpus_ts, self.corpus_len, self.mesh,
            tolerance).cpu().numpy()
        return self.timestamp_hits(counts, min_match, exclude_video_id)

    def timestamp_hits(self, counts: np.ndarray, min_match: int,
                       exclude_video_id: Optional[int]):
        """[(video_id, count)] of the rows' match counts, count >= min_match,
        count descending (stable in row order)."""
        vids = self.video_ids
        keep = (counts >= min_match) & (vids >= 0)
        if exclude_video_id is not None:
            keep &= vids != exclude_video_id
        idx = np.nonzero(keep)[0]
        out = [(int(vids[i]), int(counts[i])) for i in idx]
        out.sort(key=lambda vc: -vc[1])
        return out

    def nearest_fingerprints(self, query_fp: np.ndarray, k: int = 16):
        """[(distance, global_index, video_id)] x <=k per query row.
        Sentinel padding rows (video_id -1) are dropped from the top-k."""
        assert self.corpus_fp is not None
        q = torch.from_numpy(np.ascontiguousarray(query_fp, np.uint32).view(np.int32))
        d, idx = sharded_hamming_topk(q, self.corpus_fp, self.mesh, k=k,
                                      valid=self.corpus_fp_valid)
        return self.nearest_rows(d.cpu().numpy(), idx.cpu().numpy())

    def nearest_rows(self, d: np.ndarray, idx: np.ndarray):
        """The top-k's (M, k) distances and global indices as
        [(distance, global_index, video_id)] lists, padding rows and
        tombstones dropped."""
        return [
            [(int(d[m, j]), int(idx[m, j]), int(self.fp_video_ids[idx[m, j]]))
             for j in range(d.shape[1])
             if d[m, j] < _TOPK_INVALID
             and self.fp_video_ids[idx[m, j]] >= 0]
            for m in range(d.shape[0])
        ]
