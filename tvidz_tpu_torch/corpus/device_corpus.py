"""On-device fingerprint and timestamp corpus, on PyTorch.

Port of ``tvidz_tpu/corpus/device_corpus.py``. The host mirrors are the
source of truth and are kept exactly as in the reference (same arrays,
capacities, tombstones, free lists and compaction), so both packages hold
identical state after the same updates. Device tensors sync lazily before
each query — incrementally (dirty rows, appended rows) while the capacity
is unchanged, in full after growth or compaction:

- timestamps: (cap, MAX_CUTS) float32 NaN-padded + (cap,) int32 lengths,
  queried with ops/timestamps.timestamp_match_counts;
- fingerprints: (cap, W) int32 bit-views of the host's uint32 rows,
  sentinel-padded, queried with the corpus scan (kernel K2 on CUDA). The
  reference's word-major (W, N) layout served TPU lanes; K2 reads rows.

- alignment buckets: per length tier (time capacity 256 << b), a
  (vcap, tcap, W) int32 bit-view of the host bucket + (vcap,) int32 lengths,
  synced by dirty rows, queried with ops/align.fragment_search_batch (kernel
  K3 on CUDA). The reference's per-shape kernel->XLA fallback
  (``pallas_fragment_dispatch``) has no counterpart: on CUDA a K3 build or
  launch failure raises.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.utils import log
from tvidz_tpu_torch.ops.align import fragment_search_batch
from tvidz_tpu_torch.ops.hamming import corpus_frame_min, corpus_query_nearest
from tvidz_tpu_torch.ops.timestamps import timestamp_match_counts

_FP_SENTINEL = np.uint32(0xFFFFFFFF)

_AL_T0 = 256  # frame capacity of alignment bucket 0; bucket b holds T0<<b


class _AlignBucket:
    """One (vcap, tcap, words) tier of the bucketed alignment index
    (tvidz_tpu/corpus/device_corpus.py:120): videos grouped by sequence
    length, so a fragment query costs the corpus's footage, not every video
    paying the longest one's capacity."""

    def __init__(self, tcap: int, vcap: int, words: int):
        self.tcap = tcap
        self.vcap = vcap
        self.buf = np.full((vcap, tcap, words), _FP_SENTINEL, np.uint32)
        self.len = np.zeros(vcap, np.int32)
        self.vid = np.full(vcap, -1, np.int32)
        self.count = 0              # rows ever claimed (incl. tombstones)
        self.dev: Optional[torch.Tensor] = None       # (vcap, tcap, W) int32
        self.len_dev: Optional[torch.Tensor] = None   # (vcap,) int32
        self.dirty: set = set()
        self.full_resync = True
        self.free: List[int] = []   # tombstoned rows for reuse

    def grow(self, min_vcap: Optional[int] = None) -> None:
        """Double vcap until >= min_vcap (one doubling when None) in ONE
        allocation."""
        new_vcap = self.vcap * 2
        while min_vcap is not None and new_vcap < min_vcap:
            new_vcap *= 2
        buf = np.full((new_vcap, self.tcap, self.buf.shape[2]), _FP_SENTINEL,
                      np.uint32)
        buf[: self.vcap] = self.buf
        ln = np.zeros(new_vcap, np.int32)
        ln[: self.vcap] = self.len
        vid = np.full(new_vcap, -1, np.int32)
        vid[: self.vcap] = self.vid
        self.buf, self.len, self.vid = buf, ln, vid
        self.vcap = new_vcap
        self.full_resync = True


class DeviceCorpus:
    """Single-GPU device corpus. ``parallel.mesh_corpus.MeshCorpus`` shards
    it over a device mesh by overriding its placement (``_sync_*``) and its
    query hooks (``_ts_counts``, ``_frame_min``, ``_query_nearest``,
    ``_place_fragment_query``, ``_fragment_query``)."""

    # Video rows of a new alignment bucket (MeshCorpus: a shard multiple).
    _al_initial_vcap = 64

    def __init__(
        self,
        max_cuts: int = 128,
        words: int = 2,
        hamming_threshold: int = 10,
        ts_initial_capacity: int = 256,
        fp_initial_capacity: int = 4096,
        fp_block_n: int = 2048,
        device=None,
    ):
        self.device = backend.resolve_device(device)
        self.max_cuts = max_cuts
        self.words = words
        self.hamming_threshold = hamming_threshold
        # Capacities follow the reference's block multiple, so the scanned
        # row count (the whole capacity, sentinels included) is the same.
        self._fp_block_n = max(128, -(-fp_block_n // 128) * 128)
        self._ts_initial_capacity = ts_initial_capacity
        self._fp_initial_capacity = (
            -(-fp_initial_capacity // self._fp_block_n) * self._fp_block_n
        )
        self._lock = threading.RLock()
        self._init_state()

    def _init_state(self) -> None:
        """(Re)initialize all corpus content. Callers hold self._lock (or
        are __init__)."""
        self._ts_cap = self._ts_initial_capacity
        self._ts = np.full((self._ts_cap, self.max_cuts), np.nan, np.float32)
        self._ts_len = np.zeros(self._ts_cap, np.int32)
        self._ts_vid = np.full(self._ts_cap, -1, np.int32)
        self._vid_to_row: Dict[int, int] = {}
        self._ts_count = 0          # rows ever claimed (high-water mark)
        self._ts_free: List[int] = []
        self._ts_dev: Optional[torch.Tensor] = None
        self._ts_len_dev: Optional[torch.Tensor] = None
        self._ts_dirty_rows: List[int] = []
        self._ts_full_resync = True

        self._fp_cap = self._fp_initial_capacity
        self._fp = np.full((self._fp_cap, self.words), _FP_SENTINEL, np.uint32)
        self._fp_vid = np.full(self._fp_cap, -1, np.int32)
        self._fp_count = 0
        self._fp_dev: Optional[torch.Tensor] = None
        self._fp_synced_count = 0
        self._fp_full_resync = True
        self._fp_dirty_cols: List[int] = []
        self._fp_tombstones = 0
        self.sync_bytes = {"ts": 0, "fp": 0, "al": 0}

        self._al_buckets: List[Optional[_AlignBucket]] = []
        self._al_row: Dict[int, Tuple[int, int]] = {}  # vid -> (bucket, row)

    def reset(self) -> None:
        """Drop all corpus content, keeping configuration and the lock."""
        with self._lock:
            self._init_state()

    # -- properties -----------------------------------------------------------

    @property
    def num_videos(self) -> int:
        """Live videos (tombstoned rows excluded)."""
        return len(self._vid_to_row)

    @property
    def num_fingerprints(self) -> int:
        return self._fp_count

    @property
    def device_footprint(self) -> dict:
        """Allocated capacities and row accounting per index (the churn
        observable: every *_capacity stays bounded by the live high-water
        mark under upload/re-upload/remove cycles)."""
        with self._lock:
            buckets = [bu for bu in self._al_buckets if bu is not None]
            return {
                "ts_capacity_rows": self._ts_cap,
                "ts_rows": self._ts_count,
                "ts_free_rows": len(self._ts_free),
                "fp_capacity_rows": self._fp_cap,
                "fp_rows": self._fp_count,
                "fp_tombstones": self._fp_tombstones,
                "al_capacity_bytes": sum(
                    bu.buf.nbytes + bu.len.nbytes for bu in buckets),
                "al_claimed_rows": sum(bu.count for bu in buckets),
                "al_free_rows": sum(len(bu.free) for bu in buckets),
                "sync_bytes": dict(self.sync_bytes),
            }

    # -- load / update ----------------------------------------------------------

    def load(self, store) -> None:
        """Bulk-load timestamps + fingerprints from a corpus Store, presizing
        every index once. Fingerprint rows of another word width are skipped
        with a warning (they stay in the store)."""
        with self._lock:
            ts_rows = store.all_timestamps()
            fp_rows = store.all_fingerprints()
            good = [(v, f) for v, f in fp_rows
                    if f.ndim == 2 and f.shape[1] == self.words]
            skipped = len(fp_rows) - len(good)
            if ts_rows and self._ts_count + len(ts_rows) > self._ts_cap:
                self._grow_ts(min_cap=self._ts_count + len(ts_rows))
            total_fp = sum(f.shape[0] for _, f in good)
            if total_fp and self._fp_count + total_fp > self._fp_cap:
                self._grow_fp(min_cap=self._fp_count + total_fp)
            per_bucket: Dict[int, int] = {}
            for _, f in good:
                b = self._al_bucket_for(f.shape[0])
                per_bucket[b] = per_bucket.get(b, 0) + 1
            for b, n in per_bucket.items():
                bu = self._al_ensure_bucket(b)
                need = bu.count + max(0, n - len(bu.free))
                if need > bu.vcap:
                    bu.grow(min_vcap=need)
            for video_id, ts in ts_rows:
                self._upsert_ts_locked(video_id, ts)
            for video_id, fps in good:
                self._append_fp_locked(video_id, fps)
            if skipped:
                log("corpus",
                    f"skipped {skipped} stored fingerprint rows with word "
                    f"width != {self.words} (hash algorithm changed?)")

    def remove_video(self, video_id: int) -> None:
        """Tombstone every trace of a video: timestamp row (len 0, vid -1),
        fingerprint rows (sentinel bits + vid -1) and its alignment row.
        The sentinel overwrite matters: the scan's argmin is taken before
        the vid >= 0 filter, so a tombstoned row left at distance 0 would
        absorb the argmin and shadow an equally near live duplicate."""
        with self._lock:
            row = self._vid_to_row.pop(video_id, None)
            if row is not None:
                self._ts[row, :] = np.nan
                self._ts_len[row] = 0
                self._ts_vid[row] = -1
                self._ts_dirty_rows.append(row)
                self._ts_free.append(row)
            frames = np.nonzero(
                self._fp_vid[: self._fp_count] == video_id)[0]
            if frames.size:
                self._fp_vid[frames] = -1
                self._fp[frames] = _FP_SENTINEL
                self._fp_dirty_cols.extend(int(f) for f in frames)
                self._fp_tombstones += int(frames.size)
                self._maybe_compact_fp_locked()
            loc = self._al_row.pop(video_id, None)
            if loc is not None:
                b, r = loc
                bu = self._al_buckets[b]
                bu.buf[r] = _FP_SENTINEL
                bu.len[r] = 0
                bu.vid[r] = -1
                bu.dirty.add(r)
                bu.free.append(r)

    def upsert_timestamps(self, video_id: int, timestamps: Sequence[float]) -> None:
        with self._lock:
            self._upsert_ts_locked(video_id, timestamps)

    def _upsert_ts_locked(self, video_id: int, timestamps: Sequence[float]) -> None:
        row = self._vid_to_row.get(video_id)
        if row is None:
            if self._ts_free:
                row = self._ts_free.pop()
            else:
                if self._ts_count == self._ts_cap:
                    self._grow_ts()
                row = self._ts_count
                self._ts_count += 1
            self._vid_to_row[video_id] = row
            self._ts_vid[row] = video_id
        ts = np.asarray(list(timestamps)[: self.max_cuts], np.float32)
        self._ts[row, :] = np.nan
        self._ts[row, : len(ts)] = ts
        self._ts_len[row] = len(ts)
        self._ts_dirty_rows.append(row)

    def _grow_ts(self, min_cap: Optional[int] = None) -> None:
        new_cap = self._ts_cap * 2
        while min_cap is not None and new_cap < min_cap:
            new_cap *= 2
        ts = np.full((new_cap, self.max_cuts), np.nan, np.float32)
        ts[: self._ts_count] = self._ts[: self._ts_count]
        ln = np.zeros(new_cap, np.int32)
        ln[: self._ts_count] = self._ts_len[: self._ts_count]
        vid = np.full(new_cap, -1, np.int32)
        vid[: self._ts_count] = self._ts_vid[: self._ts_count]
        self._ts, self._ts_len, self._ts_vid = ts, ln, vid
        self._ts_cap = new_cap
        self._ts_full_resync = True

    def append_fingerprints(self, video_id: int, fingerprints: np.ndarray) -> None:
        with self._lock:
            self._append_fp_locked(video_id, fingerprints)

    def _append_fp_locked(self, video_id: int, fingerprints: np.ndarray) -> None:
        fp = np.ascontiguousarray(fingerprints, np.uint32)
        if fp.ndim != 2 or fp.shape[1] != self.words:
            raise ValueError(
                f"fingerprint width {fp.shape} incompatible with corpus "
                f"words={self.words} (hash algorithm mismatch?)"
            )
        t = fp.shape[0]
        if self._fp_count + t > self._fp_cap:
            self._grow_fp(min_cap=self._fp_count + t)
        self._fp[self._fp_count : self._fp_count + t] = fp
        self._fp_vid[self._fp_count : self._fp_count + t] = video_id
        self._fp_count += t
        self._append_al_locked(video_id, fp)

    def _al_bucket_for(self, need: int) -> int:
        b = 0
        while (_AL_T0 << b) < need:
            b += 1
        return b

    def _al_ensure_bucket(self, b: int) -> _AlignBucket:
        while len(self._al_buckets) <= b:
            self._al_buckets.append(None)
        if self._al_buckets[b] is None:
            self._al_buckets[b] = _AlignBucket(_AL_T0 << b, self._al_initial_vcap,
                                               self.words)
        return self._al_buckets[b]

    def _append_al_locked(self, video_id: int, fp: np.ndarray) -> None:
        """Extend the video's row in the alignment index; a row that
        outgrows its bucket migrates to the next one and the old row is
        tombstoned onto the bucket's free list."""
        loc = self._al_row.get(video_id)
        if loc is not None:
            b0, r0 = loc
            bu = self._al_buckets[b0]
            cur = int(bu.len[r0])
            need = cur + fp.shape[0]
            if need <= bu.tcap:
                bu.buf[r0, cur:need] = fp
                bu.len[r0] = need
                bu.dirty.add(r0)
                return
            seq = np.concatenate([bu.buf[r0, :cur], fp])
            bu.buf[r0] = _FP_SENTINEL
            bu.len[r0] = 0
            bu.vid[r0] = -1
            bu.dirty.add(r0)
            bu.free.append(r0)
        else:
            seq = np.ascontiguousarray(fp)
        need = seq.shape[0]
        b = self._al_bucket_for(need)
        bu = self._al_ensure_bucket(b)
        if bu.free:
            row = bu.free.pop()
        else:
            if bu.count == bu.vcap:
                bu.grow()
            row = bu.count
            bu.count += 1
        bu.buf[row, :need] = seq
        bu.len[row] = need
        bu.vid[row] = video_id
        bu.dirty.add(row)
        self._al_row[video_id] = (b, row)

    def _maybe_compact_fp_locked(self) -> None:
        """Reclaim tombstoned fingerprint rows once they exceed half the
        used range (and at least 1024): host-side compaction, then a full
        device resync — amortized O(1) per removed row."""
        if (self._fp_tombstones < 1024
                or self._fp_tombstones * 2 < self._fp_count):
            return
        keep = np.nonzero(self._fp_vid[: self._fp_count] >= 0)[0]
        new_count = int(keep.size)
        self._fp[:new_count] = self._fp[keep]
        self._fp[new_count : self._fp_count] = _FP_SENTINEL
        self._fp_vid[:new_count] = self._fp_vid[keep]
        self._fp_vid[new_count : self._fp_count] = -1
        self._fp_count = new_count
        self._fp_tombstones = 0
        self._fp_dirty_cols.clear()
        self._fp_full_resync = True

    def _grow_fp(self, min_cap: Optional[int] = None) -> None:
        """Double capacity until >= min_cap in ONE allocation; capacity
        stays initial * 2^k, a multiple of the block size."""
        new_cap = self._fp_cap * 2
        while min_cap is not None and new_cap < min_cap:
            new_cap *= 2
        fp = np.full((new_cap, self.words), _FP_SENTINEL, np.uint32)
        fp[: self._fp_count] = self._fp[: self._fp_count]
        vid = np.full(new_cap, -1, np.int32)
        vid[: self._fp_count] = self._fp_vid[: self._fp_count]
        self._fp, self._fp_vid = fp, vid
        self._fp_cap = new_cap
        self._fp_full_resync = True

    # -- device sync ---------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _put(self, host: np.ndarray, index: str, device=None) -> torch.Tensor:
        """A host array of corpus content on ``device`` (default: the
        corpus's): the one placement that counts ``sync_bytes[index]``, the
        host-to-device bytes of each index."""
        self.sync_bytes[index] += host.nbytes
        return torch.from_numpy(np.ascontiguousarray(host)).to(device or self.device)

    def _sync_ts(self) -> None:
        if self._ts_full_resync or self._ts_dev is None:
            self._ts_dev = self._put(self._ts, "ts")
            self._ts_len_dev = self._put(self._ts_len, "ts")
            self._ts_full_resync = False
        elif self._ts_dirty_rows:
            rows = sorted(set(self._ts_dirty_rows))
            idx = self._to_device(np.asarray(rows, np.int64))
            self._ts_dev[idx] = self._put(self._ts[rows], "ts")
            self._ts_len_dev[idx] = self._put(self._ts_len[rows], "ts")
        self._ts_dirty_rows.clear()

    def _sync_fp(self) -> None:
        """The (cap, W) int32 bit-view of the host's uint32 rows."""
        fp = self._fp.view(np.int32)
        if self._fp_full_resync or self._fp_dev is None:
            self._fp_dev = self._put(fp, "fp")
            self._fp_full_resync = False
        else:
            if self._fp_synced_count < self._fp_count:
                s, e = self._fp_synced_count, self._fp_count
                self._fp_dev[s:e] = self._put(fp[s:e], "fp")
            # In-place tombstone overwrites below the synced watermark.
            dirty = sorted(
                c for c in set(self._fp_dirty_cols)
                if c < self._fp_synced_count
            )
            if dirty:
                idx = self._to_device(np.asarray(dirty, np.int64))
                self._fp_dev[idx] = self._put(fp[dirty], "fp")
        self._fp_synced_count = self._fp_count
        self._fp_dirty_cols.clear()

    def _sync_al_bucket(self, bu: _AlignBucket) -> None:
        """Per-bucket device mirror: in full after growth (or the first
        query), else the dirty rows only."""
        if bu.full_resync or bu.dev is None:
            bu.dev = self._put(bu.buf.view(np.int32), "al")
            bu.len_dev = self._put(bu.len, "al")
        elif bu.dirty:
            rows = sorted(bu.dirty)
            idx = self._to_device(np.asarray(rows, np.int64))
            bu.dev[idx] = self._put(bu.buf[rows].view(np.int32), "al")
            bu.len_dev[idx] = self._put(bu.len[rows], "al")
        bu.full_resync = False
        bu.dirty.clear()

    @staticmethod
    def _padded_queries(query: np.ndarray) -> np.ndarray:
        """(M, W) queries rounded up to a multiple of 8 rows with copies of
        row 0 (a duplicate never changes a minimum; kept from the reference,
        whose kernel tiling needed it), as a host int32 bit-view."""
        q = np.asarray(query, np.uint32)
        m_pad = -q.shape[0] % 8
        if m_pad:
            q = np.concatenate([q, np.repeat(q[:1], m_pad, axis=0)])
        return np.ascontiguousarray(q).view(np.int32)

    # -- query hooks (MeshCorpus overrides them) -----------------------------------
    # Each takes its queries as a host array and the synced device mirrors,
    # and returns its result as tensors on ``self.device``.

    def _ts_counts(self, q: np.ndarray, ts_dev, len_dev,
                   tolerance: float) -> torch.Tensor:
        """(cap,) int32 match counts of the (max_cuts,) query."""
        return timestamp_match_counts(self._to_device(q), ts_dev, len_dev,
                                      tolerance=tolerance)

    def _frame_min(self, q: np.ndarray, fp_dev) -> torch.Tensor:
        """(cap,) int32: per corpus row, the min distance over the queries
        (K4 ``frame_min``)."""
        return corpus_frame_min(self._to_device(q), fp_dev)

    def _query_nearest(self, q: np.ndarray, fp_dev
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per query row (min distance, FIRST corpus row attaining it) (K4
        ``query_nearest``)."""
        return corpus_query_nearest(self._to_device(q), fp_dev)

    # -- queries ------------------------------------------------------------------

    def match_timestamps(
        self,
        query_ts: Sequence[float],
        min_match: int = 2,
        tolerance: float = 0.0,
        exclude_video_id: Optional[int] = None,
    ) -> List[Tuple[int, int]]:
        """[(video_id, match_count)] with count >= min_match, self-excluded."""
        # Keep the FIRST max_cuts, matching _upsert_ts_locked's truncation.
        q = np.full(self.max_cuts, np.nan, np.float32)
        take = list(query_ts)[: self.max_cuts]
        q[: len(take)] = np.asarray(take, np.float32)
        with self._lock:
            if self._ts_count == 0 or len(query_ts) == 0:
                return []
            self._sync_ts()
            vids = self._ts_vid[: self._ts_count].copy()
            count_n = self._ts_count
            # Launched under the lock (here and in the other queries): a
            # later dirty-row sync writes the device mirror in place, and
            # must come after this read, on the same stream.
            counts = self._ts_counts(q, self._ts_dev, self._ts_len_dev,
                                     tolerance)
        counts = counts[:count_n].cpu().numpy()
        keep = counts >= min_match
        if exclude_video_id is not None:
            keep &= vids != exclude_video_id
        idx = np.nonzero(keep)[0]
        return [(int(vids[i]), int(counts[i])) for i in idx]

    def search_fingerprints(
        self, query: np.ndarray, min_match: int = 2,
        exclude_video_id: Optional[int] = None,
    ) -> List[Tuple[int, int]]:
        """Per-video fingerprint match evidence: a corpus frame matches when
        its min Hamming distance to any query frame is <= hamming_threshold.
        Returns [(video_id, count)] with count >= min_match, count
        descending."""
        with self._lock:
            if self._fp_count == 0 or query.shape[0] == 0:
                return []
            self._sync_fp()
            fp_vid = self._fp_vid[: self._fp_count].copy()
            count_n = self._fp_count
            frame_min = self._frame_min(self._padded_queries(query),
                                        self._fp_dev)
        matched = frame_min[:count_n].cpu().numpy() <= self.hamming_threshold
        vids_matched = fp_vid[matched]
        if vids_matched.size == 0:
            return []
        uniq, cnt = np.unique(vids_matched, return_counts=True)
        out = [
            (int(v), int(c))
            for v, c in zip(uniq, cnt)
            # v >= 0 drops tombstoned rows (an all-ones sentinel can sit
            # within threshold of a dense query hash).
            if c >= min_match and v >= 0 and v != exclude_video_id
        ]
        out.sort(key=lambda vc: -vc[1])
        return out

    def nearest_video_counts(
        self, query: np.ndarray, exclude_video_id: Optional[int] = None,
    ) -> Dict[int, int]:
        """{video_id: #query frames whose nearest corpus fingerprint belongs
        to that video (within hamming_threshold)} — each QUERY frame
        contributes at most once."""
        with self._lock:
            if self._fp_count == 0 or query.shape[0] == 0:
                return {}
            self._sync_fp()
            fp_vid = self._fp_vid[: self._fp_count].copy()
            count_n = self._fp_count
            q_min, q_arg = self._query_nearest(self._padded_queries(query),
                                               self._fp_dev)
        m = query.shape[0]
        q_min = q_min[:m].cpu().numpy()
        q_arg = q_arg[:m].cpu().numpy()
        out: Dict[int, int] = {}
        for i in range(m):
            # q_arg may land on a sentinel row beyond count_n.
            if q_min[i] <= self.hamming_threshold and q_arg[i] < count_n:
                vid = int(fp_vid[q_arg[i]])
                if vid >= 0 and vid != exclude_video_id:
                    out[vid] = out.get(vid, 0) + 1
        return out

    def _place_fragment_query(self, q: np.ndarray) -> torch.Tensor:
        """The padded (Q, Tq_pad, W) uint32 queries on the device, placed
        once per call for every bucket's scan."""
        return self._to_device(np.ascontiguousarray(q).view(np.int32))

    def _fragment_query(self, q, q_lens, al_dev, len_dev, thr):
        """One bucket's alignment scan: ((Q, V) offsets, (Q, V) scores)."""
        return fragment_search_batch(q, q_lens, al_dev, len_dev, thr)

    def locate_fragment(
        self,
        query_fps: np.ndarray,
        top_k: int = 5,
        hamming_threshold: Optional[int] = None,
        exclude_video_id: Optional[int] = None,
    ) -> List[Tuple[int, int, int]]:
        """Partial-reuse localization: where a (Tq, W) uint32 fingerprint
        fragment best aligns inside each corpus video. Returns
        [(video_id, best_offset_frames, match_count)], match_count
        descending (stable), top_k entries; offsets are relative to the
        video's first fingerprinted frame. One scan per occupied length
        bucket."""
        return self.locate_fragments(
            [query_fps], top_k=top_k, hamming_threshold=hamming_threshold,
            exclude_video_ids=[exclude_video_id])[0]

    def locate_fragments(
        self,
        query_fps_list: Sequence[np.ndarray],
        top_k: int = 5,
        hamming_threshold: Optional[int] = None,
        exclude_video_ids: Optional[Sequence[Optional[int]]] = None,
    ) -> List[List[Tuple[int, int, int]]]:
        """One result list per query fragment, each equal to its own
        ``locate_fragment``. The queries share one K3 launch per bucket:
        each is padded to the batch's 64-frame width, which moves no
        non-zero score's offset (a row t >= q_len never counts), and
        zero-score rows are dropped."""
        thr = self.hamming_threshold if hamming_threshold is None else hamming_threshold
        excl = list(exclude_video_ids or [None] * len(query_fps_list))
        out: List[List[Tuple[int, int, int]]] = [[] for _ in query_fps_list]
        live = [i for i, q in enumerate(query_fps_list) if q.shape[0] > 0]
        if not live:
            return out
        # Pad the queries to a 64-frame multiple (the reference's query
        # bucket, tvidz_tpu/corpus/device_corpus.py:783); padded rows are
        # masked by q_len inside the scan.
        tq_pad = max(max(64, -(-query_fps_list[i].shape[0] // 64) * 64)
                     for i in live)
        q = np.full((len(live), tq_pad, self.words), _FP_SENTINEL, np.uint32)
        for j, i in enumerate(live):
            q[j, : query_fps_list[i].shape[0]] = np.asarray(
                query_fps_list[i], np.uint32)
        with self._lock:
            if not self._al_row:
                return out
            q_dev = self._place_fragment_query(q)
            q_lens = self._to_device(np.asarray(
                [query_fps_list[i].shape[0] for i in live], np.int32))
            # Every bucket's scan is launched before any result is pulled,
            # and under the lock: a later dirty-row sync writes the bucket
            # in place, after these reads on the same stream.
            pending = []
            for bu in self._al_buckets:
                if bu is None or bu.count == 0:
                    continue
                self._sync_al_bucket(bu)
                pending.append((
                    self._fragment_query(q_dev, q_lens, bu.dev, bu.len_dev, thr),
                    bu.vid[: bu.count].copy(), bu.count))
        pulled = [(offs[:, :count].cpu().numpy(),
                   scores[:, :count].cpu().numpy(), vids)
                  for (offs, scores), vids, count in pending]
        for j, i in enumerate(live):
            keep = [vids >= 0 if excl[i] is None
                    else (vids >= 0) & (vids != excl[i])
                    for _, _, vids in pulled]
            vids = np.concatenate([v[k] for (_, _, v), k in zip(pulled, keep)])
            offs = np.concatenate([o[j][k] for (o, _, _), k in zip(pulled, keep)])
            scores = np.concatenate(
                [s[j][k] for (_, s, _), k in zip(pulled, keep)])
            # Zero-score rows are not matches (their offset is an artifact
            # of the query padding width).
            real = scores > 0
            vids, offs, scores = vids[real], offs[real], scores[real]
            order = np.argsort(-scores, kind="stable")[:top_k]
            out[i] = [(int(vids[k]), int(offs[k]), int(scores[k]))
                      for k in order]
        return out
