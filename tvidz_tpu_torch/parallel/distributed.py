"""Multi-host serving on ``torch.distributed``: the corpus sharded across
processes, each possibly on its own host.

Port of ``tvidz_tpu/parallel/distributed.py``. Where the reference joins
``jax.distributed`` and runs one SPMD program over a global mesh, every
process here is one rank of a ``torch.distributed`` group, and the global
(data, corpus) mesh is laid out HOST-MAJOR: rank r's local block is a
``parallel.mesh.Mesh`` over its own devices, and its corpus column c is
global shard ``r * local_corpus + c``.

    rank 0                  rank 1
    [d0 d1 | d2 d3]   ++    [d0 d1 | d2 d3]      (data 2, local corpus 2)
     corpus shards 0,1       corpus shards 2,3    -> global corpus axis 4

Each rank holds only its own row range of every index, and runs the port's
kernels on it through PR 8's single-process sharded searches over its
local mesh (K4 per local shard for ``search_fingerprints``, K3 per local
shard or tile for fragment search). Only the small per-shard evidence
crosses ranks, and only through ``broadcast``, ``all_reduce`` and
``barrier`` (gloo takes nothing else on CUDA tensors):

- a gather is the reference's psum of zeros: each rank writes its block
  into a zeroed global buffer and the buffer is summed over the ranks;
- an append's payload is broadcast from its source rank.

Every rank derives the same global padded layout (PR 8's ``ts_layout`` /
``fp_layout`` / ``_pad_rows`` over the global shard count), so global row
indices, first-index ties and fragment ranks are the reference's row for
row. Every method that touches a device is a collective: all ranks call it
with the same arguments in the same order (``parallel.collective`` does
that for a service).

The backend follows the device: ``nccl`` for CUDA ranks, ``gloo`` for CPU
ranks; ``TVIDZ_DIST_BACKEND=gloo`` lets CUDA ranks share one card, which
NCCL refuses. An NCCL error is raised, never retried on gloo.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.parallel.mesh import CORPUS_AXIS, DATA_AXIS, Mesh
from tvidz_tpu_torch.parallel.sharded_search import (
    Sharded,
    ShardedCorpus,
    _smallest,
    build_fragment_query_batch,
    place,
    rank_fragment_hits,
    sharded_fragment_search,
    sharded_fragment_search_batch,
    sharded_frame_min_rows,
    sharded_hamming_topk,
    sharded_timestamp_match,
)
from tvidz_tpu_torch.utils import log

ENV_BACKEND = "TVIDZ_DIST_BACKEND"
# A collective op's default wait (MultiHostCorpusClient) and the least
# timeout of the process group: a fenced member's peers then fail loudly
# instead of waiting forever in a collective it will never join.
DEFAULT_OP_TIMEOUT_S = 300.0
_SENTINEL = -1          # 0xFFFFFFFF as the int32 bit-view


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This rank (``jax.process_index()``): 0 without a group."""
    return dist.get_rank() if _group() else 0


def process_count() -> int:
    """The world size (``jax.process_count()``): 1 without a group."""
    return dist.get_world_size() if _group() else 1


def all_reduce(t: torch.Tensor, op=None) -> torch.Tensor:
    """``t`` reduced in place over the ranks (SUM unless ``op``)."""
    if _group():
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op)
    return t


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` overwritten in place by rank ``src``'s."""
    if _group():
        dist.broadcast(t, src=src)
    return t


def barrier() -> None:
    if not _group():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = DEFAULT_OP_TIMEOUT_S,
) -> bool:
    """Join the process group from the arguments or ``TVIDZ_COORDINATOR``
    (``host:port``, served by rank 0), ``TVIDZ_NUM_PROCESSES`` and
    ``TVIDZ_PROCESS_ID``. Returns False when no coordinator is set.

    ``device`` (``backend.resolve_device``'s argument) picks the backend:
    ``nccl`` on CUDA, ``gloo`` on the CPU, or ``$TVIDZ_DIST_BACKEND``."""
    coordinator_address = coordinator_address or os.environ.get(
        "TVIDZ_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("TVIDZ_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid_env = os.environ.get("TVIDZ_PROCESS_ID")
        process_id = int(pid_env) if pid_env is not None else None
    if not coordinator_address:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("TVIDZ_COORDINATOR needs TVIDZ_NUM_PROCESSES and "
                         "TVIDZ_PROCESS_ID")
    dev = backend.resolve_device(device)
    name = os.environ.get(ENV_BACKEND) or ("nccl" if dev.type == "cuda" else "gloo")
    if name not in ("nccl", "gloo") or (name == "nccl" and dev.type != "cuda"):
        raise ValueError(f"{ENV_BACKEND}={name!r} on {dev}: use nccl on CUDA "
                         "ranks or gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=name, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    log("distributed",
        f"process {process_index()}/{process_count()} up on {dev} ({name})")
    return True


class MultiHostMesh(Mesh):
    """The global (data, corpus) mesh as this rank sees it: ``devices`` and
    ``local`` are its own block, ``shape`` the global one (the corpus axis
    spans every rank's columns, host-major)."""

    def __init__(self, local: Mesh, rank: int, world: int):
        super().__init__(local.devices)
        self.local, self.rank, self.world = local, rank, world
        self.shape = {DATA_AXIS: local.shape[DATA_AXIS],
                      CORPUS_AXIS: world * local.shape[CORPUS_AXIS]}


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def make_multihost_mesh(local_data: Optional[int] = None,
                        local_corpus: Optional[int] = None,
                        local_devices: Optional[Sequence] = None
                        ) -> MultiHostMesh:
    """The global mesh with the corpus axis host-major across ranks. This
    rank's ``local_devices`` (default: every visible CUDA card; a device
    may repeat, as ``[cpu] * 4`` in the tests) form a (local_data,
    local_corpus) block, favouring the corpus axis. Collective: every rank
    calls it; uneven local device counts raise on every rank."""
    if local_devices is None:
        backend.resolve_device("cuda")
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    local_devices = [backend.resolve_device(d) for d in local_devices]
    n_local = len(local_devices)
    counts = all_reduce(torch.tensor([n_local, -n_local], dtype=torch.int32,
                                     device=local_devices[0]), dist.ReduceOp.MAX)
    if int(counts[0]) != -int(counts[1]):
        raise ValueError("uneven local device counts across hosts")
    if local_data is None or local_corpus is None:
        if local_corpus is not None and n_local % local_corpus:
            raise ValueError(
                f"local_corpus={local_corpus} does not divide the "
                f"{n_local} local devices")
        # Favor the corpus axis (the search dimension); data gets the rest.
        local_corpus = local_corpus or _largest_pow2_leq(n_local)
        while local_corpus > 1 and n_local % local_corpus:
            local_corpus //= 2
        local_data = local_data or n_local // local_corpus
    if local_data * local_corpus != n_local:
        raise ValueError(
            f"local mesh {local_data}x{local_corpus} != {n_local} local devices")
    local = Mesh([local_devices[d * local_corpus:(d + 1) * local_corpus]
                  for d in range(local_data)])
    return MultiHostMesh(local, process_index(), process_count())


class MultiHostShardedCorpus:
    """Corpus search sharded across ranks.

    Every rank derives the same global padded layout (deterministic given
    the shared store's rows) and places only its own row range; queries are
    replicated, each rank scans its rows with the port's kernels, and the
    per-shard evidence is summed into replicated results — the only
    cross-rank traffic. Host mirrors (video ids, lengths) are global and
    identical on every rank.

    Streaming ingest (``append_video``) broadcasts the new rows from the
    analyzing rank and every rank writes the ones it holds in place: per
    ingest only the payload crosses ranks, with no store round trip and no
    O(corpus) reload (contrast ``refresh_from_store``).
    """

    def __init__(self, mesh: MultiHostMesh, max_cuts: int = 128, words: int = 2,
                 hamming_threshold: int = 10, al_tcap: int = 2048):
        self.mesh = mesh
        self._inner = ShardedCorpus(mesh, max_cuts=max_cuts, words=words)
        self.hamming_threshold = hamming_threshold
        self._process_index = process_index()
        self._ts_rows = 0      # used rows (capacity = inner.corpus_ts.shape[0])
        self._fp_count = 0     # used fingerprint rows
        self.fp_compactions = 0     # hygiene counter (tests/metrics)
        # Alignment (fragment-search) index: one (al_tcap, words) row per
        # video, row-sharded host-major like the fingerprint index. Videos
        # longer than al_tcap frames are clamped (a log line marks it).
        self.al_tcap = al_tcap
        self.corpus_al: Optional[Sharded] = None      # (Vcap, al_tcap, W)
        self.corpus_al_len: Optional[Sharded] = None  # (Vcap,)
        self.al_video_ids = None     # (Vcap,) host mirror, identical per rank
        self.al_len_host = None      # (Vcap,) host mirror of valid lengths
        self._al_rows = 0

    # -- this rank's rows -------------------------------------------------------

    def _local_range(self, n_pad: int) -> Tuple[int, int]:
        """Rows held by this rank: the corpus axis is host-major, so each
        rank holds a contiguous block of shards."""
        per_host = n_pad // self.mesh.world
        lo = self.mesh.rank * per_host
        return lo, lo + per_host

    def _place(self, rows, n_global: int) -> Sharded:
        """This rank's ``rows`` (numpy or a tensor) of a global
        (n_global, ...) table, one block per local corpus column."""
        s = place(rows, self.mesh.local, CORPUS_AXIS)
        return Sharded(self.mesh, CORPUS_AXIS, s.local,
                       (n_global,) + tuple(rows.shape[1:]))

    def _local(self, s: Sharded) -> Sharded:
        """``s``'s blocks as a table over the local mesh alone."""
        return Sharded(self.mesh.local, CORPUS_AXIS, s.local,
                       (s.shape[0] // self.mesh.world,) + tuple(s.shape[1:]))

    def _gather(self, local: torch.Tensor, n_global: int, dim: int = 0
                ) -> torch.Tensor:
        """The global tensor whose ``dim`` holds every rank's ``local``
        block at its row range: the psum of zeros, on this rank's first
        device."""
        shape = list(local.shape)
        shape[dim] = n_global
        buf = torch.zeros(shape, dtype=local.dtype, device=self.mesh.home)
        lo, _ = self._local_range(n_global)
        buf.narrow(dim, lo, local.shape[dim]).copy_(local)
        return all_reduce(buf)

    def _gather_all(self, s: Sharded) -> torch.Tensor:
        """The whole global table ``s`` on every rank (growth, compaction)."""
        home = self.mesh.home
        local = torch.cat([s.local[0][c].to(home)
                           for c in range(self.mesh.local.shape[CORPUS_AXIS])])
        if local.dtype == torch.bool:
            return self._gather(local.to(torch.uint8), s.shape[0]).bool()
        return self._gather(local, s.shape[0])

    def _write(self, s: Sharded, start: int, values: torch.Tensor,
               col: Optional[int] = None) -> None:
        """Global rows [start, start + len(values)) of ``s`` := ``values``
        (starting at column ``col`` of each row where given), in the blocks
        this rank holds; a no-op elsewhere."""
        per = s.block_rows
        lo, _ = self._local_range(s.shape[0])
        n = values.shape[0]
        seen = set()
        for row in s.local:
            for c, block in enumerate(row):
                if id(block) in seen:
                    continue
                seen.add(id(block))
                b0 = lo + c * per
                a, e = max(start, b0), min(start + n, b0 + per)
                if a >= e:
                    continue
                v = values[a - start:e - start].to(block.device)
                if col is None:
                    block[a - b0:e - b0] = v
                else:
                    block[a - b0:e - b0, col:col + v.shape[1]] = v

    def _clear(self, s: Sharded, hit: np.ndarray) -> None:
        """Where the global mask ``hit`` is set on this rank's rows, the
        (boolean) table ``s`` := False."""
        per = s.block_rows
        lo, _ = self._local_range(s.shape[0])
        seen = set()
        for row in s.local:
            for c, block in enumerate(row):
                if id(block) in seen:
                    continue
                seen.add(id(block))
                m = hit[lo + c * per:lo + (c + 1) * per]
                if m.any():
                    block[torch.from_numpy(m).to(block.device)] = False

    def _payload(self, rows: Optional[np.ndarray], shape, dtype: torch.dtype,
                 src: int) -> torch.Tensor:
        """``rows`` from the source rank, broadcast to every rank."""
        buf = torch.zeros(shape, dtype=dtype, device=self.mesh.home)
        if rows is not None:
            buf.copy_(torch.from_numpy(np.ascontiguousarray(rows)))
        return broadcast(buf, src)

    # -- placement (this rank's row range) --------------------------------------

    def load_timestamps(self, rows, video_ids, min_rows: int = 0) -> None:
        inner = self._inner
        # The ONE layout definition lives on ShardedCorpus; only the
        # placement differs here (each rank places its row range).
        ts, lens, vids = inner.ts_layout(rows, video_ids, min_rows=min_rows)
        lo, hi = self._local_range(ts.shape[0])
        inner.corpus_ts = self._place(ts[lo:hi], ts.shape[0])
        inner.corpus_len = self._place(lens[lo:hi], ts.shape[0])
        inner.video_ids = vids
        self._ts_rows = len(rows)

    def load_fingerprints(self, fp: np.ndarray, fp_video_ids: np.ndarray,
                          min_rows: int = 0) -> None:
        inner = self._inner
        buf, vids = inner.fp_layout(fp, fp_video_ids, min_rows=min_rows)
        lo, hi = self._local_range(buf.shape[0])
        inner.corpus_fp = self._place(buf.view(np.int32)[lo:hi], buf.shape[0])
        inner.corpus_fp_valid = self._place((vids >= 0)[lo:hi], buf.shape[0])
        inner.fp_video_ids = vids
        self._fp_count = fp.shape[0]

    def load_alignment(self, per_video, min_rows: int = 0) -> None:
        """Place the fragment-search index: ``per_video`` is a list of
        (video_id, (T, W) fp array). One padded (al_tcap, W) row per video,
        sharded over the corpus axis host-major."""
        inner = self._inner
        n = max(len(per_video), 1, min_rows)
        v_pad = inner._pad_rows(n, 8)
        lo, hi = self._local_range(v_pad)
        buf = np.full((hi - lo, self.al_tcap, inner.words), 0xFFFFFFFF, np.uint32)
        lens = np.zeros(v_pad, np.int32)
        vids = np.full(v_pad, -1, np.int32)
        for i, (vid, fp) in enumerate(per_video):
            t = min(fp.shape[0], self.al_tcap)
            if t < fp.shape[0]:
                log("distributed",
                    f"alignment row for video {vid} clamped to "
                    f"{self.al_tcap} of {fp.shape[0]} frames")
            if lo <= i < hi:
                buf[i - lo, :t] = fp[:t]
            lens[i] = t
            vids[i] = vid
        self.corpus_al = self._place(buf.view(np.int32), v_pad)
        self.corpus_al_len = self._place(lens[lo:hi].copy(), v_pad)
        self.al_video_ids = vids
        self.al_len_host = lens
        self._al_rows = len(per_video)

    def refresh_from_store(self, store, min_ts_rows: int = 0,
                           min_fp_rows: int = 0) -> None:
        """Warm this rank's rows from the shared durable store (ranks share
        it; each serves its shard). min_*_rows pre-size the padded layouts
        so streaming ingest (append_video) has headroom."""
        rows = store.all_timestamps()
        self.load_timestamps([ts for _, ts in rows], [v for v, _ in rows],
                             min_rows=min_ts_rows)
        fps = store.all_fingerprints()
        words = self._inner.words
        if fps:
            flat = np.concatenate([f for _, f in fps])
            vids = np.concatenate(
                [np.full(f.shape[0], v, np.int32) for v, f in fps])
        else:
            flat = np.zeros((0, words), np.uint32)
            vids = np.zeros((0,), np.int32)
        self.load_fingerprints(flat, vids, min_rows=min_fp_rows)
        self.load_alignment(fps, min_rows=min_ts_rows)

    def remove_video(self, video_id: int) -> None:
        """Tombstone (every rank calls it with the same id): the host video
        id mirrors go to -1 (filtering every query's output) and the
        removed fingerprint rows' valid bits clear on the ranks holding
        them, so distance-0 tombstones cannot absorb top-k slots. Timestamp
        and alignment slots are reused by the next claim; fingerprint rows
        are reclaimed by the compaction _append_fingerprints triggers when
        the tail hits capacity. No rank needs another's data: no
        collective runs."""
        inner = self._inner
        if inner.video_ids is not None:
            inner.video_ids = np.where(
                inner.video_ids == video_id, -1, inner.video_ids)
        if self.al_video_ids is not None:
            # The host length is zeroed so a reusing claim restarts the row
            # at [0, n); the stale device row is masked by its vid.
            hit_al = self.al_video_ids == video_id
            self.al_len_host[hit_al] = 0
            self.al_video_ids[hit_al] = -1
        if inner.fp_video_ids is None or inner.corpus_fp_valid is None:
            return
        hit = inner.fp_video_ids == video_id
        if not hit.any():
            return
        # A video's rows need not be one range (several appends, another
        # rank's ingest between them): clear by the full mask.
        inner.fp_video_ids = np.where(hit, -1, inner.fp_video_ids)
        self._clear(inner.corpus_fp_valid, hit)

    # -- streaming ingest ---------------------------------------------------------

    def append_video(self, video_id: int, ts=None, fps=None, *,
                     src_process: int = 0, n_ts: Optional[int] = None,
                     n_fp: Optional[int] = None,
                     upsert_empty_ts: bool = False) -> None:
        """Ingest of one analyzed video — every rank calls this with the
        same (video_id, n_ts, n_fp, src_process); only the analyzing rank
        passes the payload (ts / fps), everyone else None.

        The counts are what the ingest event carries, so every rank knows
        the payload's shape; the rows are broadcast from ``src_process``
        and each rank writes the ones it holds in place. Timestamps upsert
        by video_id; fingerprints append at the tail (compacting or growing
        the index when it is full).

        n_ts is the video's FULL cut count; every rank clamps it to
        max_cuts identically, keeping the FIRST max_cuts."""
        is_src = self._process_index == src_process
        if not is_src and (ts is not None or fps is not None):
            raise ValueError(
                f"process {self._process_index} passed a payload but "
                f"src_process={src_process}; only the analyzing process "
                "may supply ts/fps (others pass the counts only)")
        if is_src:
            if ts is not None:
                full = list(ts)
                if n_ts is None:
                    n_ts = len(full)
                if n_ts != len(full):
                    raise ValueError(f"n_ts={n_ts} != len(ts)={len(full)}")
                ts = full[: self._inner.max_cuts]
            if fps is not None:
                fps = np.asarray(fps, np.uint32)
                if n_fp is None:
                    n_fp = fps.shape[0]
                if n_fp != fps.shape[0]:
                    raise ValueError(f"n_fp={n_fp} != fps rows {fps.shape[0]}")
            # A zero payload would commit all-zero rows with a valid
            # video_id — corruption, not an error. Refuse.
            if n_ts and ts is None:
                raise ValueError("source process must supply ts when n_ts > 0")
            if n_fp and fps is None:
                raise ValueError("source process must supply fps when n_fp > 0")
        n_ts = min(int(n_ts or 0), self._inner.max_cuts)
        n_fp = int(n_fp or 0)
        if n_ts or upsert_empty_ts:
            # upsert_empty_ts: a zero-cut re-analysis still overwrites the
            # video's row to length 0 (DeviceCorpus parity).
            payload = None
            if n_ts:
                payload = self._payload(
                    np.asarray(ts[:n_ts], np.float32) if is_src else None,
                    (n_ts,), torch.float32, src_process)
            self._append_timestamps(video_id, payload, n_ts)
        if n_fp:
            rows = self._payload(
                np.ascontiguousarray(fps).view(np.int32) if is_src else None,
                (n_fp, self._inner.words), torch.int32, src_process)
            self._append_fingerprints(video_id, rows)
            self._append_alignment(video_id, rows)

    def _append_timestamps(self, video_id: int, payload, n_ts: int) -> None:
        inner = self._inner
        if inner.corpus_ts is None:
            raise RuntimeError("load_timestamps(min_rows=...) first")
        # Upsert: the video's existing row, else a tombstoned slot, else
        # the tail. The mirrors are identical on every rank, so the choice is.
        existing = np.nonzero(inner.video_ids[: self._ts_rows] == video_id)[0]
        if existing.size:
            row = int(existing[0])
        else:
            freed = np.nonzero(inner.video_ids[: self._ts_rows] == -1)[0]
            row = int(freed[0]) if freed.size else self._ts_rows
        if row >= inner.corpus_ts.shape[0]:
            # Online growth: every rank grows at this op.
            self._grow_ts(row + 1)
        new_row = torch.full((1, inner.max_cuts), float("nan"),
                             dtype=torch.float32, device=self.mesh.home)
        if n_ts:
            new_row[0, :n_ts] = payload
        self._write(inner.corpus_ts, row, new_row)
        self._write(inner.corpus_len, row, torch.tensor([n_ts], dtype=torch.int32))
        inner.video_ids[row] = video_id
        if row == self._ts_rows:
            self._ts_rows += 1

    def _append_fingerprints(self, video_id: int, rows: torch.Tensor) -> None:
        inner = self._inner
        if inner.corpus_fp is None:
            raise RuntimeError("load_fingerprints(min_rows=...) first")
        n_fp = rows.shape[0]
        cap = inner.corpus_fp.shape[0]
        start = self._fp_count
        if start + n_fp > cap:
            # Tail full but tombstoned slots exist: compact (every rank
            # at this op, from identical mirrors).
            live = int((inner.fp_video_ids[:start] >= 0).sum())
            if live + n_fp <= cap:
                self._compact_fingerprints()
                start = self._fp_count
        if start + n_fp > cap:
            # The corpus genuinely grew: online growth.
            self._grow_fp(start + n_fp)
        self._write(inner.corpus_fp, start, rows)
        self._write(inner.corpus_fp_valid, start,
                    torch.ones(n_fp, dtype=torch.bool))
        inner.fp_video_ids[start:start + n_fp] = video_id
        self._fp_count += n_fp

    def _compact_fingerprints(self) -> None:
        """In-place compaction of the fingerprint index: every valid row
        slides down to close tombstone gaps, in order (query results name
        rows afresh per query). Every rank runs this at the same op with
        identical mirrors: one gather of the whole table, then each rank
        takes its new row range through the permutation."""
        inner = self._inner
        cap = inner.corpus_fp.shape[0]
        keep = np.nonzero(inner.fp_video_ids[: self._fp_count] >= 0)[0]
        k = keep.size
        perm = np.zeros(cap, np.int64)     # NEW slot -> OLD row to read
        perm[:k] = keep
        full = self._gather_all(inner.corpus_fp)
        lo, hi = self._local_range(cap)
        inner.corpus_fp = self._place(
            full[torch.from_numpy(perm[lo:hi]).to(full.device)], cap)
        inner.corpus_fp_valid = self._place(np.arange(lo, hi) < k, cap)
        new_vids = np.full(cap, -1, inner.fp_video_ids.dtype)
        new_vids[:k] = inner.fp_video_ids[keep]
        inner.fp_video_ids = new_vids
        reclaimed = self._fp_count - k
        self._fp_count = k
        self.fp_compactions += 1
        log("distributed",
            f"fingerprint index compacted: {reclaimed} tombstoned rows "
            f"reclaimed, {k} live rows (compaction #{self.fp_compactions})")

    # -- online capacity growth ---------------------------------------------------
    # Growth runs inside the append ops, so in the op-log world every rank
    # reallocates at the same seq. Growing moves which global rows each
    # rank holds: one gather of the old table (O(cap), amortized by
    # doubling), then every rank slices its new row range.

    @staticmethod
    def _doubled(old: int, min_cap: int) -> int:
        new = old * 2
        while new < min_cap:
            new *= 2
        return new

    def _regrow(self, s: Sharded, new: int, fill) -> Sharded:
        """``s`` at capacity ``new``: old rows kept, new rows ``fill``."""
        full = self._gather_all(s)
        old = s.shape[0]
        lo, hi = self._local_range(new)
        out = torch.full((hi - lo,) + tuple(s.shape[1:]), fill, dtype=full.dtype,
                         device=full.device)
        if lo < old:
            out[:min(hi, old) - lo] = full[lo:min(hi, old)]
        return self._place(out, new)

    def _grow_ts(self, min_cap: int) -> None:
        inner = self._inner
        old = inner.corpus_ts.shape[0]
        new = self._doubled(old, min_cap)
        inner.corpus_ts = self._regrow(inner.corpus_ts, new, float("nan"))
        inner.corpus_len = self._regrow(inner.corpus_len, new, 0)
        vids = np.full(new, -1, inner.video_ids.dtype)
        vids[:old] = inner.video_ids
        inner.video_ids = vids
        log("distributed", f"timestamp capacity grown {old} -> {new} "
            "(collective redistribution)")

    def _grow_fp(self, min_cap: int) -> None:
        inner = self._inner
        old = inner.corpus_fp.shape[0]
        new = self._doubled(old, min_cap)
        inner.corpus_fp = self._regrow(inner.corpus_fp, new, _SENTINEL)
        inner.corpus_fp_valid = self._regrow(inner.corpus_fp_valid, new, False)
        vids = np.full(new, -1, inner.fp_video_ids.dtype)
        vids[:old] = inner.fp_video_ids
        inner.fp_video_ids = vids
        log("distributed", f"fingerprint capacity grown {old} -> {new} "
            "(collective redistribution)")

    def _grow_al(self, min_vcap: int) -> None:
        old = self.corpus_al.shape[0]
        new = self._doubled(old, min_vcap)
        self.corpus_al = self._regrow(self.corpus_al, new, _SENTINEL)
        self.corpus_al_len = self._regrow(self.corpus_al_len, new, 0)
        vids = np.full(new, -1, self.al_video_ids.dtype)
        vids[:old] = self.al_video_ids
        self.al_video_ids = vids
        lens = np.zeros(new, self.al_len_host.dtype)
        lens[:old] = self.al_len_host
        self.al_len_host = lens
        log("distributed", f"alignment video capacity grown {old} -> {new} "
            "(collective redistribution)")

    def _append_alignment(self, video_id: int, rows: torch.Tensor) -> None:
        """Extension of the video's alignment row by the broadcast rows
        (streamed blocks extend the same row in time order). Rows at
        al_tcap clamp silently — identically on every rank."""
        inner = self._inner
        if self.corpus_al is None:
            # Callers that loaded ts/fp directly get an empty alignment
            # index sized to the timestamp capacity, on every rank alike.
            self.load_alignment(
                [], min_rows=(inner.corpus_ts.shape[0]
                              if inner.corpus_ts is not None else 64))
        existing = np.nonzero(
            self.al_video_ids[: self._al_rows] == video_id)[0]
        if existing.size:
            row = int(existing[0])
        else:
            # A tombstoned slot first (its host length is 0, so the row
            # restarts at [0, n); stale bits beyond are masked by the
            # length), else the tail.
            freed = np.nonzero(self.al_video_ids[: self._al_rows] == -1)[0]
            row = int(freed[0]) if freed.size else self._al_rows
            if row >= self.corpus_al.shape[0]:
                self._grow_al(row + 1)
        cur = int(self.al_len_host[row])
        n_eff = min(rows.shape[0], self.al_tcap - cur)
        if n_eff > 0:
            self._write(self.corpus_al, row, rows[None, :n_eff], col=cur)
            self._write(self.corpus_al_len, row,
                        torch.tensor([cur + n_eff], dtype=torch.int32))
            self.al_len_host[row] = cur + n_eff
        if not existing.size:
            # Claimed even when clamped to nothing: the video is indexed.
            self.al_video_ids[row] = video_id
            if row == self._al_rows:
                self._al_rows += 1

    # -- queries (collective; results replicated on every rank) -------------------

    def match_timestamps(self, query_ts, min_match: int = 2,
                         tolerance: float = 0.0, exclude_video_id=None):
        inner = self._inner
        if inner.corpus_ts is None:
            return []
        q = np.full(inner.max_cuts, np.nan, np.float32)
        # Keep the FIRST max_cuts — the store/DeviceCorpus truncation.
        take = list(query_ts)[: inner.max_cuts]
        q[: len(take)] = take
        local = sharded_timestamp_match(
            torch.from_numpy(q), self._local(inner.corpus_ts),
            self._local(inner.corpus_len), self.mesh.local, tolerance)
        counts = self._gather(local, inner.corpus_ts.shape[0]).cpu().numpy()
        return inner.timestamp_hits(counts, min_match, exclude_video_id)

    def nearest_fingerprints(self, query_fp: np.ndarray, k: int = 16):
        """[(distance, global_index, video_id)] x <=k per query row, equal
        distances in ascending global index: each rank's top-k candidates
        (sorted by distance, then index) are summed into a (world, M, k)
        buffer and merged identically on every rank. Padding rows never
        surface."""
        inner = self._inner
        assert inner.corpus_fp is not None
        n = inner.corpus_fp.shape[0]
        q = torch.from_numpy(
            np.ascontiguousarray(query_fp, np.uint32).view(np.int32))
        d, idx = sharded_hamming_topk(q, self._local(inner.corpus_fp),
                                      self.mesh.local, k=k,
                                      valid=self._local(inner.corpus_fp_valid))
        lo, _ = self._local_range(n)
        world, (m, kr) = self.mesh.world, d.shape
        cand = self._gather(torch.stack([d, idx + lo])[:, None], world, dim=1)
        merged = cand.permute(0, 2, 1, 3).reshape(2, m, world * kr)
        d, idx = _smallest(merged[0], merged[1], min(k, n))
        return inner.nearest_rows(d.cpu().numpy(), idx.cpu().numpy())

    def search_fingerprints(self, query: np.ndarray, min_match: int = 2,
                            exclude_video_id=None):
        """Per-video fingerprint evidence — DeviceCorpus.search_fingerprints
        semantics on the spanning corpus: a CORPUS frame matches when its
        min Hamming distance to any query frame (K4 ``frame_min`` on each
        local shard) is <= hamming_threshold; count >= min_match, sorted
        descending."""
        inner = self._inner
        q = np.ascontiguousarray(query, np.uint32)
        if inner.corpus_fp is None or self._fp_count == 0 or q.shape[0] == 0:
            return []
        m_pad = -q.shape[0] % 8
        if m_pad:
            # Copies of a real row never change a corpus frame's minimum.
            q = np.concatenate([q, np.repeat(q[:1], m_pad, axis=0)])
        local = sharded_frame_min_rows(torch.from_numpy(q.view(np.int32)),
                                       self._local(inner.corpus_fp),
                                       self.mesh.local)
        fm = self._gather(local, inner.corpus_fp.shape[0]).cpu().numpy()
        count_n = self._fp_count
        matched = fm[:count_n] <= self.hamming_threshold
        vids = inner.fp_video_ids[:count_n][matched]
        vids = vids[vids >= 0]            # tombstones never surface
        if vids.size == 0:
            return []
        uniq, cnt = np.unique(vids, return_counts=True)
        out = [
            (int(v), int(c))
            for v, c in zip(uniq, cnt)
            if c >= min_match and v != exclude_video_id
        ]
        out.sort(key=lambda vc: -vc[1])
        return out

    def _thr(self, hamming_threshold: Optional[int]) -> int:
        return (self.hamming_threshold if hamming_threshold is None
                else hamming_threshold)

    def fragment_search(self, query_fps: np.ndarray, top_k: int = 5,
                        hamming_threshold: Optional[int] = None,
                        exclude_video_id: Optional[int] = None):
        """Fragment localization over the spanning alignment index:
        [(video_id, best_offset, match_count)] by match_count descending,
        top_k entries (DeviceCorpus.locate_fragment's contract). K3 runs on
        each local shard; the (offset, score) per video is summed across
        ranks. A K3 failure raises on every rank: no plain fallback."""
        inner = self._inner
        query_fps = np.asarray(query_fps, np.uint32)
        if self.corpus_al is None or query_fps.shape[0] == 0:
            return []
        tq = query_fps.shape[0]
        tq_pad = max(64, -(-tq // 64) * 64)
        q = np.full((tq_pad, inner.words), 0xFFFFFFFF, np.uint32)
        q[:tq] = query_fps
        vcap = self.corpus_al.shape[0]
        offs, scores = sharded_fragment_search(
            torch.from_numpy(q.view(np.int32)), tq, self._local(self.corpus_al),
            self._local(self.corpus_al_len), self.mesh.local,
            hamming_threshold=self._thr(hamming_threshold))
        both = self._gather(torch.stack([offs, scores]), vcap, dim=1).cpu().numpy()
        offs, scores = both
        vids = self.al_video_ids
        keep = (vids[:vcap] >= 0) & (scores[:vcap] > 0)
        if exclude_video_id is not None:
            keep &= vids[:vcap] != exclude_video_id
        idx = np.nonzero(keep)[0]
        hits = [(int(vids[i]), int(offs[i]), int(scores[i])) for i in idx]
        hits.sort(key=lambda h: -h[2])
        return hits[:top_k]

    def fragment_search_batch(self, query_fps_list, top_k: int = 5,
                              hamming_threshold: Optional[int] = None,
                              exclude_video_ids=None):
        """Batched fragment localization in one collective: queries over
        the local data axis, videos over the corpus axis, one K3 launch
        per local (Q/data, V/corpus) tile; one hit list per query."""
        inner = self._inner
        qn = len(query_fps_list)
        if qn == 0:
            return []
        if self.corpus_al is None:
            return [[] for _ in range(qn)]
        excl = exclude_video_ids or [None] * qn
        qbuf, qlens = build_fragment_query_batch(
            query_fps_list, inner.words, self.mesh.shape[DATA_AXIS])
        vcap = self.corpus_al.shape[0]
        offs, scores = sharded_fragment_search_batch(
            torch.from_numpy(qbuf.view(np.int32)), torch.from_numpy(qlens),
            self._local(self.corpus_al), self._local(self.corpus_al_len),
            self.mesh.local, hamming_threshold=self._thr(hamming_threshold))
        offs, scores = self._gather(torch.stack([offs, scores]), vcap,
                                    dim=2).cpu().numpy()
        vids = np.asarray(self.al_video_ids[:vcap], np.int64)
        return rank_fragment_hits(vids, offs[:qn], scores[:qn], excl, top_k)
