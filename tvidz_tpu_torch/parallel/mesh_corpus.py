"""MeshCorpus — the corpus sharded over a device mesh, behind the exact
DeviceCorpus interface the analyzer and the service use.

Port of ``tvidz_tpu/parallel/mesh_corpus.py``. The fingerprint, timestamp
and alignment indices shard row-wise over the mesh's ``corpus`` axis
(replicated over ``data``); queries are replicated; each shard's evidence
comes from the port's kernels on its own device (K4 for the two verdict
scans, K3 for fragment search) and only the small per-shard vectors travel
to the mesh's first device. Host mirrors, growth and verdict resolution
are DeviceCorpus's unchanged: this class overrides only the placement
(``_sync_*``) and the query hooks, plus ``locate_fragments``, which runs
one 2-D (data x corpus) batch per alignment bucket.

Capacities round up to shard multiples as in the reference (timestamps to
the shard count, fingerprints to block x shards, alignment videos to the
shard count), so the rows every scan reads — and so its argmins — are the
ones a single-card DeviceCorpus of the same capacities reads.
"""

from __future__ import annotations

import numpy as np
import torch

from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.parallel.mesh import CORPUS_AXIS, DATA_AXIS, Mesh
from tvidz_tpu_torch.parallel.sharded_search import (
    Sharded,
    build_fragment_query_batch,
    place,
    rank_fragment_hits,
    sharded_fragment_search_batch,
    sharded_frame_min,
    sharded_nearest,
    sharded_timestamp_match,
)


class MeshCorpus(DeviceCorpus):
    def __init__(self, mesh: Mesh, **kwargs):
        self.mesh = mesh
        self.n_shards = mesh.shape[CORPUS_AXIS]
        # Row counts must divide evenly across the corpus axis; round the
        # initial capacities up (growth doubles, so divisibility persists).
        ts_cap = kwargs.pop("ts_initial_capacity", 256)
        kwargs["ts_initial_capacity"] = -(-ts_cap // self.n_shards) * self.n_shards
        fp_cap = kwargs.pop("fp_initial_capacity", 4096)
        # Same 128-row rounding DeviceCorpus applies to the block size.
        blk = max(128, -(-kwargs.get("fp_block_n", 2048) // 128) * 128)
        unit = blk * self.n_shards
        kwargs["fp_initial_capacity"] = -(-fp_cap // unit) * unit
        # Alignment index rows shard over the corpus axis too.
        self._al_initial_vcap = -(-64 // self.n_shards) * self.n_shards
        super().__init__(device=mesh.home, **kwargs)

    @property
    def sync_bytes_transferred(self) -> int:
        """Host-to-device bytes of every index (device-to-device copies to a
        shard's replicas are not counted)."""
        return sum(self.sync_bytes.values())

    # -- sharded placement ----------------------------------------------------
    # Incremental sync: dirty rows and appended rows touch only their own
    # shards, so only those are placed anew; each crosses host->device once
    # and its replicas along ``data`` get a device-to-device copy of it.

    def _place_rows(self, host: np.ndarray, index: str, keep=None,
                    dirty=()) -> Sharded:
        return place(host, self.mesh, CORPUS_AXIS, keep=keep, dirty=dirty,
                     put=lambda block, dev: self._put(block, index, dev))

    def _sync_row_sharded(self, rows_dev, len_dev, rows_host, len_host,
                          dirty_rows, full_resync, index: str):
        """Shared sync for a row-sharded (cap, ...) table and its (cap,)
        lengths: full placement after growth, else the dirty shards."""
        if full_resync or rows_dev is None:
            return self._place_rows(rows_host, index), self._place_rows(len_host, index)
        if dirty_rows:
            rows_per_shard = rows_host.shape[0] // self.n_shards
            dirty = {r // rows_per_shard for r in dirty_rows}
            rows_dev = self._place_rows(rows_host, index, rows_dev, dirty)
            len_dev = self._place_rows(len_host, index, len_dev, dirty)
        return rows_dev, len_dev

    def _sync_ts(self) -> None:
        self._ts_dev, self._ts_len_dev = self._sync_row_sharded(
            self._ts_dev, self._ts_len_dev, self._ts, self._ts_len,
            self._ts_dirty_rows, self._ts_full_resync, "ts")
        self._ts_full_resync = False
        self._ts_dirty_rows.clear()

    def _sync_fp(self) -> None:
        fp = self._fp.view(np.int32)
        if self._fp_full_resync or self._fp_dev is None:
            self._fp_dev = self._place_rows(fp, "fp")
            self._fp_full_resync = False
        else:
            # Appended rows [synced, count) live in the trailing shards;
            # in-place tombstone sentinels can land in any shard.
            rows_per_shard = self._fp_cap // self.n_shards
            dirty = {c // rows_per_shard for c in self._fp_dirty_cols}
            if self._fp_synced_count < self._fp_count:
                dirty.update(range(self._fp_synced_count // rows_per_shard,
                                   (self._fp_count - 1) // rows_per_shard + 1))
            if dirty:
                self._fp_dev = self._place_rows(fp, "fp", self._fp_dev, dirty)
        self._fp_synced_count = self._fp_count
        self._fp_dirty_cols.clear()

    def _sync_al_bucket(self, bu) -> None:
        bu.dev, bu.len_dev = self._sync_row_sharded(
            bu.dev, bu.len_dev, bu.buf.view(np.int32), bu.len, bu.dirty,
            bu.full_resync, "al")
        bu.full_resync = False
        bu.dirty.clear()

    # -- sharded query hooks ----------------------------------------------------

    def _ts_counts(self, q, ts_dev, len_dev, tolerance: float):
        return sharded_timestamp_match(torch.from_numpy(q), ts_dev, len_dev,
                                       self.mesh, tolerance)

    def _frame_min(self, q, fp_dev):
        return sharded_frame_min(torch.from_numpy(q), fp_dev, self.mesh)

    def _query_nearest(self, q, fp_dev):
        return sharded_nearest(torch.from_numpy(q), fp_dev, self.mesh)

    def _place_fragment_query(self, q: np.ndarray) -> Sharded:
        """A batch's queries (or their lengths), split over ``data``."""
        return place(q, self.mesh, DATA_AXIS)

    def _fragment_query(self, q, q_lens, al_dev, len_dev, thr):
        return sharded_fragment_search_batch(q, q_lens, al_dev, len_dev,
                                             self.mesh, hamming_threshold=thr)

    def locate_fragments(self, query_fps_list, top_k=5,
                         hamming_threshold=None, exclude_video_ids=None):
        """Batch fragment localization, one 2-D dispatch per occupied
        alignment bucket: the queries (padded to a multiple of ``data``)
        split over ``data`` while the bucket's videos split over
        ``corpus``, one K3 launch per (Q/data, V/corpus) tile. Each result
        list equals the query's own ``locate_fragment``."""
        qn = len(query_fps_list)
        if qn == 0:
            return []
        thr = (self.hamming_threshold if hamming_threshold is None
               else hamming_threshold)
        excl = exclude_video_ids or [None] * qn
        qbuf, qlens = build_fragment_query_batch(
            query_fps_list, self.words, self.mesh.shape[DATA_AXIS])
        with self._lock:
            if not self._al_row:
                return [[] for _ in range(qn)]
            q_dev = self._place_fragment_query(qbuf.view(np.int32))
            ql_dev = self._place_fragment_query(qlens)
            # Launched under the lock, before any result is pulled (as in
            # DeviceCorpus.locate_fragments).
            pending = []
            for bu in self._al_buckets:
                if bu is None or bu.count == 0:
                    continue
                self._sync_al_bucket(bu)
                pending.append((
                    self._fragment_query(q_dev, ql_dev, bu.dev, bu.len_dev, thr),
                    bu.vid[: bu.count].copy(), bu.count))
        all_vids = np.concatenate([vids for _, vids, _ in pending])
        all_offs = np.concatenate(
            [offs[:qn, :count].cpu().numpy() for (offs, _), _, count in pending],
            axis=1)
        all_scores = np.concatenate(
            [scores[:qn, :count].cpu().numpy() for (_, scores), _, count in pending],
            axis=1)
        return rank_fragment_hits(all_vids, all_offs, all_scores, excl, top_k)
