"""Multi-host collective serving — the production driver of
MultiHostShardedCorpus on ``torch.distributed``.

Port of ``tvidz_tpu/parallel/collective.py``. Every device operation on a
corpus that spans ranks is a collective: every rank must launch it, with
the same arguments, in the same order. An HTTP service is asynchronous —
rank 1's poller ingests an upload while rank 0 fields a /status poll — so
ad-hoc per-rank collective calls would deadlock or diverge. The bridge is
a totally-ordered op log in the shared durable store
(``Store.append_collective_op``; commit order = total order) plus one
executor thread per rank that applies ops strictly in sequence, and is the
only thread of the rank that calls a collective:

    HTTP/poller thread                    executor thread (per rank)
    ------------------                    --------------------------
    submit(op) -> log row seq=N           poll log, apply seq=N on the
    wait on Future                        spanning corpus (same calls on
                                          every rank), resolve local
                                          Futures for ops this rank
                                          submitted

Per-op cross-rank traffic stays O(payload): ingest rows are broadcast from
the analyzing rank (distributed.append_video), query payloads travel in
the op row itself (KBs), and query RESULTS are replicated by the summed
per-shard evidence, so every rank computes them and only the submitting
rank reads them out.

The op kinds double as the multi-host wire protocol, byte for byte the
reference's, so one store's op log reads the same to either package:
  append    {video_id, n_ts, n_fp, src, ts/fp} payload inline (src broadcasts)
  ts_query  {ts, min_match, tolerance, exclude} payload inline (floats)
  fp_query  {fp(b64), rows, k, threshold, exclude} payload inline
  fp_evidence {fp(b64), rows, min_match, exclude}  corpus-frame evidence
            (DeviceCorpus.search_fingerprints parity)
  fragment  {fp(b64), rows, top_k, threshold, exclude} single query
  fragments {fp(b64), rows[], top_k, threshold, excludes[]} whole batch in
            one op row / one batched device dispatch
  remove    {video_id}                          tombstone
  reset     {}                                  drop all corpus content

Capacity is pre-sized at warm (TVIDZ_MH_TS_CAPACITY / TVIDZ_MH_FP_CAPACITY)
and GROWS ONLINE when an append exceeds it: the growth decision is
deterministic (identical mirrors), so every rank runs the same
redistribution at the same op seq — a log-ordered grow with no separate
op kind (distributed._grow_ts/_grow_fp/_grow_al).

Log hygiene: per-member watermarks bound the log (pruned to the minimum);
a stalled member pins pruning and raises the /metrics lag alarm; the
operator evicts it (POST /admin/evict-host or ``evict-host`` -> watermark
sentinel), after which it fences itself — refuses to serve rather than
diverge — and pruning resumes. Re-admission is a cluster restart.
"""

from __future__ import annotations

import base64
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tvidz_tpu_torch.parallel.distributed import (
    DEFAULT_OP_TIMEOUT_S,
    barrier as _dist_barrier,
    process_count,
    process_index,
)
from tvidz_tpu_torch.utils import log
from tvidz_tpu_torch.utils.futures import Future as _BaseFuture


class _Future(_BaseFuture):
    """Collective-op future (shared utils.futures.Future with the op
    timeout message), stamped with its submit time."""

    def __init__(self) -> None:
        super().__init__(timeout_msg="collective op timed out")
        self.submitted = time.monotonic()


class CollectiveRunner:
    """One per rank. Owns ALL device work (and every collective) on the
    spanning corpus; other threads interact only through submit()."""

    def __init__(self, store, mh_corpus, *, hamming_threshold: int = 10,
                 poll_s: float = 0.05, ts_capacity: int = 4096,
                 fp_capacity: int = 1 << 18, warm_barrier=None,
                 wm_interval_s: float = 5.0, prune_interval_s: float = 60.0,
                 lag_alarm_ops: int = 1024):
        self.store = store
        self.corpus = mh_corpus
        self.hamming_threshold = hamming_threshold
        self.poll_s = poll_s
        self.ts_capacity = ts_capacity
        self.fp_capacity = fp_capacity
        self.process_index = process_index()
        # Op-log hygiene: every applied op's row (ingest payloads included)
        # would otherwise live in the store forever. Each host records its
        # applied watermark (at most every wm_interval_s, only when it
        # advanced); every prune_interval_s it deletes rows at or below the
        # minimum watermark of ALL members. No liveness cutoff: query and
        # append ops are collectives that keep watermarks in lockstep, but
        # remove/reset are host-local, so a stalled member could silently
        # fall behind on a run of them — it must PIN pruning (bounded-log
        # sacrificed) rather than be outrun and later gap-skip rows it
        # never read (silent mirror divergence). Members depart only via
        # cluster restart, where start() clears rows outside the new
        # membership so a shrunk cluster doesn't pin on ghosts.
        self.wm_interval_s = wm_interval_s
        self.prune_interval_s = prune_interval_s
        self.oplog_pruned_total = 0
        # Alarm threshold: when the log tail past the minimum member
        # watermark exceeds this many ops, oplog_status() raises the
        # lag_alarm flag — the operator signal that a member is stalled
        # and pinning pruning (runbook: docs/multihost.md, eviction).
        self.lag_alarm_ops = lag_alarm_ops
        # Fenced = this member was EVICTED by an operator
        # (Store.evict_collective_member): the executor stops applying
        # ops and every submit fails — serving a pruned-past log would
        # silently diverge. Re-admission is a cluster restart.
        self.evicted = threading.Event()
        self.fence_reason: Optional[str] = None
        # Host-local op-apply failures (device/transport — NOT data errors,
        # which raise identically on every host): single-process clusters
        # retry up to this many times; multi-process members fence at once
        # (re-issuing a collective the peers moved past would pair with
        # their NEXT op's collective). See _apply.
        self.apply_retry_attempts = 4
        self._wm_written_seq = -1
        self._wm_last = 0.0
        self._prune_last = time.monotonic()
        # Cross-host rendezvous run between warm and ready (see start()).
        # Injectable for tests; None = torch.distributed.barrier() when
        # the cluster has >1 process, no-op single-process.
        self._warm_barrier = warm_barrier
        self._ready = threading.Event()
        self._applied_seq = 0
        self._pending: Dict[str, _Future] = {}
        self._pending_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Sequence-gap handling: a burned seq (a Postgres SERIAL whose
        # insert rolled back) would otherwise wedge every host's executor
        # forever. After gap_timeout_s waiting on the SAME missing seq we
        # declare it burned and skip it — deterministic across hosts
        # (every host waits on the same number and sees the same absence),
        # at the cost of divergence if an insert ever commits later than
        # the timeout (pathological for autocommit log appends; logged
        # loudly either way).
        self.gap_timeout_s = 120.0
        self._gap_seq: Optional[int] = None
        self._gap_since = 0.0
        # Host-side video-id mirror, maintained from applied ops so every
        # host answers num_videos identically without a store round-trip
        # (num_fingerprints delegates to the corpus row count, which
        # remove/compaction keep honest).
        self._video_ids: set = set()
        # Wall seconds from submit to this rank's apply, per op kind, of
        # the ops this rank submitted: {kind: [ops, seconds]} (/metrics).
        self._op_wall: Dict[str, List[float]] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Warm this host's shard from the store, snapshot the log
        watermark, rendezvous with the other hosts, and start the executor.

        Warm exactness: under ``torch.distributed`` cluster membership is
        fixed at ``init_process_group()`` (which itself blocks until every
        process joins), so a "rolling join" is really a cluster restart — all
        hosts pass through start() together. The one remaining race is a
        host that finishes warming early and submits an ingest op while
        another host is still reading the store: the slow host's warm read
        could then include rows the op also carries (double-apply, burning
        fingerprint capacity). The warm barrier closes exactly that
        window: no host's submit() unblocks until EVERY host has finished
        its watermark + warm reads, so any op with seq > watermark was
        persisted (analyzer persists store-first) and logged strictly
        after every warm read. Restarts are therefore exact with no
        ingest drain (docs/multihost.md)."""
        self._applied_seq = self.store.max_collective_seq()
        self.corpus.refresh_from_store(
            self.store, min_ts_rows=self.ts_capacity,
            min_fp_rows=self.fp_capacity)
        for vid, ts in self.store.all_timestamps():
            if ts:
                self._video_ids.add(int(vid))
        # Watermark registration BEFORE the barrier: every member has a
        # row in collective_watermarks before any post-barrier op can be
        # logged, so pruning can never outrun a member that simply hasn't
        # heartbeated yet. Process 0 also clears rows of departed members
        # (cluster restarts can shrink the host count).
        if self.process_index == 0:
            self.store.prune_collective_watermarks(
                [f"host-{i}" for i in range(process_count())])
        # force=True clears a leftover EVICTED sentinel: start() implies a
        # full cluster restart (every process passes init_process_group()
        # + this warm barrier together), where every rank re-warms from the
        # durable store — the one sanctioned re-admission path for an
        # evicted member. A lone evicted process cannot sneak back
        # mid-flight: init_process_group() blocks without the whole cluster.
        self.store.set_collective_watermark(
            f"host-{self.process_index}", self._applied_seq, time.time(),
            force=True)
        self._wm_written_seq = self._applied_seq
        barrier = self._warm_barrier
        if barrier is None:
            if process_count() > 1:
                barrier = _dist_barrier
        if barrier is not None:
            barrier()
        self._ready.set()
        self._thread = threading.Thread(
            target=self._run, name="collective-runner", daemon=True)
        self._thread.start()
        log("collective",
            f"host {self.process_index} runner up at seq {self._applied_seq} "
            f"({len(self._video_ids)} videos, "
            f"{self.num_fingerprints} fingerprints)")

    def stop(self) -> None:
        # Clear readiness FIRST so post-stop submits fail fast instead of
        # logging a real op (which live hosts would execute) and then
        # hanging on a Future the dead executor never resolves.
        self._ready.clear()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # -- submit side (any thread) --------------------------------------------

    def submit(self, kind: str, meta: dict) -> _Future:
        """Append an op to the shared log and return a Future resolved when
        THIS host's executor applies it. meta is written to the log and
        must be everything any host needs to apply the op — ingest
        payloads ride the op row itself (see _execute's append branch), so
        every op is reconstructible from the log alone; the in-process
        pending dict only maps op ids to local Futures.

        Blocked until start()'s warm barrier passes: an op logged before
        every host finished warming could double-apply on a slow host
        (see start())."""
        if not self._ready.is_set():
            raise RuntimeError(
                "CollectiveRunner is not ready: either start() (warm + "
                "cross-host barrier) has not completed or stop() was "
                "called; ops cannot be submitted")
        op_id = uuid.uuid4().hex
        meta = dict(meta, op=op_id, src=self.process_index)
        fut = _Future()
        with self._pending_lock:
            self._pending[op_id] = fut
        try:
            self.store.append_collective_op(kind, meta)
        except Exception:
            with self._pending_lock:
                self._pending.pop(op_id, None)
            raise
        if self._stop.is_set():
            # stop() raced the append (check-then-act above is lock-free):
            # the op is in the log — other live hosts will apply it, which
            # is semantically fine in an at-least-once world — but THIS
            # host's executor is dead, so fail the caller fast instead of
            # letting it hang the full op timeout.
            with self._pending_lock:
                self._pending.pop(op_id, None)
            raise RuntimeError(
                "CollectiveRunner stopped while submitting; op logged but "
                "no local executor will resolve it")
        return fut

    # -- executor ------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            self._hygiene()
            try:
                ops = self.store.collective_ops_after(self._applied_seq)
            except Exception as e:  # noqa: BLE001 — transient store errors
                log("collective", f"log poll failed: {e}")
                time.sleep(self.poll_s)
                continue
            if not ops:
                self._stop.wait(self.poll_s)
                continue
            for seq, kind, meta in ops:
                if self._stop.is_set():
                    return
                if seq != self._applied_seq + 1:
                    # Sequence gap: a concurrent insert committed later
                    # than a higher seq (possible with Postgres serials).
                    # Wait for contiguity — applying out of order would
                    # diverge this host from the others — but only up to
                    # gap_timeout_s: a permanently burned seq (rolled-back
                    # insert) must not wedge the cluster.
                    missing = self._applied_seq + 1
                    now = time.monotonic()
                    if self._gap_seq != missing:
                        self._gap_seq = missing
                        self._gap_since = now
                        log("collective",
                            f"waiting for seq {missing} (saw {seq})")
                    elif now - self._gap_since > self.gap_timeout_s:
                        log("collective",
                            f"seq {missing} still absent after "
                            f"{self.gap_timeout_s:.0f}s; declaring it "
                            "burned and skipping")
                        self._applied_seq = missing
                        self._gap_seq = None
                    break
                self._gap_seq = None
                # _apply advances _applied_seq itself (before resolving
                # the submitter's Future — restart warm reads rely on
                # that ordering) and returns False when this host fenced.
                if not self._apply(seq, kind, meta):
                    return
            else:
                continue
            time.sleep(self.poll_s)

    def _hygiene(self) -> None:
        """Throttled watermark heartbeat + fence check + op-log pruning
        (see __init__). Runs on the executor thread so a written watermark
        always reflects truly-applied ops; failures are logged and retried
        next loop — hygiene must never stall op application."""
        now = time.monotonic()
        if now - self._wm_last >= self.wm_interval_s:
            prev_wm_last = self._wm_last
            self._wm_last = now
            try:
                # Fence check FIRST (even when the seq hasn't advanced —
                # an idle member must still discover its eviction): an
                # operator-set EVICTED sentinel means the log may already
                # be pruned past this host. Stop rather than diverge.
                wm = self.store.collective_watermark(
                    f"host-{self.process_index}")
                if wm is not None and wm < 0:
                    self._fence()
                    return
                if self._applied_seq != self._wm_written_seq:
                    self.store.set_collective_watermark(
                        f"host-{self.process_index}", self._applied_seq,
                        time.time())
                    self._wm_written_seq = self._applied_seq
            except Exception as e:  # noqa: BLE001
                # Retry NEXT LOOP, not next interval (docstring contract):
                # a transiently-down store must not stretch the stale-
                # watermark window to wm_interval_s — peers' pruning pins
                # on it and lag_ops inflates toward a false alarm.
                self._wm_last = prev_wm_last
                log("collective", f"watermark heartbeat failed: {e}")
        if now - self._prune_last >= self.prune_interval_s:
            self._prune_last = now
            try:
                m = self.store.min_collective_watermark()
                if m is not None and m > 0:
                    n = self.store.prune_collective_ops(m)
                    if n:
                        self.oplog_pruned_total += n
                        log("collective",
                            f"pruned {n} applied op rows (<= seq {m}); "
                            f"{self.oplog_pruned_total} total")
            except Exception as e:  # noqa: BLE001
                log("collective", f"op-log prune failed: {e}")

    def _fence(self, reason: str = "operator eviction") -> None:
        """This member must refuse to serve (operator eviction, or a
        host-LOCAL op-apply failure its peers did not share). Readiness is
        cleared (every future submit raises), pending futures fail fast,
        and the executor loop exits — applying further ops could read a
        log whose earlier rows were pruned away (eviction) or a mirror
        missing an op its peers applied (local failure): either way,
        silent divergence. Re-admission is a full cluster restart."""
        self.fence_reason = reason
        log("collective",
            f"host {self.process_index} FENCED from the collective "
            f"cluster ({reason}); refusing to serve — restart the "
            "cluster to re-admit (docs/multihost.md)")
        self.evicted.set()
        self._ready.clear()
        self._stop.set()
        with self._pending_lock:
            pending, self._pending = dict(self._pending), {}
        err = RuntimeError(
            f"this host was fenced from the collective cluster ({reason})")
        for fut in pending.values():
            fut.fail(err)

    def oplog_status(self) -> dict:
        """Operator-facing log hygiene snapshot (served at /metrics):
        per-member watermarks, the prune point, the unpruned tail length
        past it, and the stalled-member alarm."""
        max_seq = self.store.max_collective_seq()
        marks = self.store.collective_watermarks()
        m = self.store.min_collective_watermark()
        lag = (max_seq - m) if m is not None else 0
        return {
            "rows": self.store.collective_op_count(),
            "applied_seq": self._applied_seq,
            "pruned_total": self.oplog_pruned_total,
            "max_seq": max_seq,
            "min_watermark": m,
            "lag_ops": lag,
            "lag_alarm": bool(lag > self.lag_alarm_ops),
            "members": {
                h: {"seq": s, "evicted": s < 0, "updated_at": u}
                for h, s, u in marks
            },
            "evicted_self": self.evicted.is_set(),
            "fence_reason": self.fence_reason,
            "op_wall_ms": {
                k: {"ops": int(n), "mean_ms": s / n * 1e3}
                for k, (n, s) in sorted(self._op_wall.items())
            },
        }

    def _take_pending(self, meta) -> Optional[_Future]:
        with self._pending_lock:
            return self._pending.pop(meta.get("op", ""), None)

    def _apply(self, seq: int, kind: str, meta: dict) -> bool:
        """Apply one op; returns False when this host fenced itself (the
        executor must exit). Advances _applied_seq BEFORE resolving the
        submitter's Future (a submitter whose wait() returned must observe
        the watermark past its op — restart warm reads rely on it).

        Failure policy (review r4): ops are deterministic functions of the
        identical host mirrors, so a DATA error ((Value/Type/Key/Index)
        Error) raises identically on every host — the log stays aligned,
        fail the future and move on. Anything else (device/transport) is
        HOST-LOCAL: peers applied the op, this mirror did not, and silently
        skipping it would diverge every later query. Single-process
        clusters retry it (no peer collectives to desynchronize); a
        multi-process member must NOT re-issue a collective its peers have
        moved past (the retried collective would pair with their NEXT op's
        collective), so it fences itself instead — peers' pruning then
        pins on its watermark, the lag alarm fires, and the operator
        evicts it (docs/multihost.md runbook)."""
        fut = self._take_pending(meta)
        mine = fut is not None
        attempt = 0
        while True:
            try:
                result = self._execute(kind, meta)
                break
            except (ValueError, TypeError, KeyError, IndexError) as e:
                # Deterministic given identical mirrors: aligned on every
                # host; the op is consumed.
                log("collective", f"op {seq} ({kind}) failed: {e}")
                self._applied_seq = seq
                if mine:
                    fut.fail(e)
                return True
            except Exception as e:  # noqa: BLE001 — host-local failure
                attempt += 1
                # Retries are safe only for PURE QUERY ops: a mutating op
                # can partially apply before raising (fp rows landed,
                # alignment append failed), so re-running it would
                # double-append. Mutations fence on first failure.
                retryable = (process_count() == 1
                             and kind in ("ts_query", "fp_query",
                                          "fp_evidence", "fragment",
                                          "fragments"))
                if retryable and attempt < self.apply_retry_attempts \
                        and not self._stop.is_set():
                    log("collective",
                        f"op {seq} ({kind}) failed locally (attempt "
                        f"{attempt}/{self.apply_retry_attempts}): {e}; "
                        "retrying")
                    time.sleep(min(0.1 * (2 ** attempt), 2.0))
                    continue
                log("collective",
                    f"op {seq} ({kind}) failed on this host after "
                    f"{attempt} attempt(s): {e}")
                if mine:
                    fut.fail(e)
                self._fence(
                    f"op {seq} ({kind}) failed host-locally: {e}")
                return False
        self._applied_seq = seq
        if mine:
            stat = self._op_wall.setdefault(kind, [0, 0.0])
            stat[0] += 1
            stat[1] += time.monotonic() - fut.submitted
            fut.resolve(result)
        return True

    def _execute(self, kind: str, meta: dict):
        c = self.corpus
        if kind == "append":
            vid = int(meta["video_id"])
            n_ts = int(meta["n_ts"])
            n_fp = int(meta["n_fp"])
            src = int(meta["src"])
            ts = fps = None
            if self.process_index == src:
                # Payload comes from the LOG ROW, not the in-process
                # pending dict: if a submit's insert committed but the
                # reply was lost, the op still applies with its real rows
                # on every host instead of the source broadcasting
                # zeros (review r3 #4).
                if "ts" in meta and meta["ts"] is not None:
                    ts = [float(t) for t in meta["ts"]]
                if "fp" in meta and meta["fp"] is not None:
                    fps = np.frombuffer(
                        base64.b64decode(meta["fp"]), np.uint32
                    ).reshape(n_fp, -1).copy()
            # "ts" key present (even as []) marks a TIMESTAMP UPSERT op:
            # a zero-cut re-analysis must overwrite the row to length 0
            # (DeviceCorpus parity), while fp-only appends (no "ts" key)
            # must not claim a ts row. Every host reads the flag from the
            # log row itself.
            ts_upsert = meta.get("ts") is not None
            c.append_video(vid, ts=ts, fps=fps, src_process=src,
                           n_ts=n_ts, n_fp=n_fp,
                           upsert_empty_ts=ts_upsert and n_ts == 0)
            if n_ts or ts_upsert:
                self._video_ids.add(vid)
            return None
        if kind == "ts_query":
            if c._inner.corpus_ts is None:
                return []
            return c.match_timestamps(
                list(meta["ts"]), min_match=int(meta["min_match"]),
                tolerance=float(meta.get("tolerance", 0.0)),
                exclude_video_id=meta.get("exclude"),
            )
        if kind == "fp_query":
            if c._inner.corpus_fp is None:
                return [[] for _ in range(int(meta["rows"]))]
            q = np.frombuffer(
                base64.b64decode(meta["fp"]), np.uint32
            ).reshape(int(meta["rows"]), -1).copy()
            nn = c.nearest_fingerprints(q, k=int(meta.get("k", 1)))
            return nn
        if kind == "fp_evidence":
            # DeviceCorpus.search_fingerprints semantics (corpus-frame
            # evidence) on the host-spanning corpus — a collective like
            # every query, so each host computes the replicated result.
            q = np.frombuffer(
                base64.b64decode(meta["fp"]), np.uint32
            ).reshape(int(meta["rows"]), -1).copy()
            return c.search_fingerprints(
                q, min_match=int(meta.get("min_match", 2)),
                exclude_video_id=meta.get("exclude"),
            )
        if kind == "fragment":
            q = np.frombuffer(
                base64.b64decode(meta["fp"]), np.uint32
            ).reshape(int(meta["rows"]), -1).copy()
            return c.fragment_search(
                q, top_k=int(meta.get("top_k", 5)),
                hamming_threshold=meta.get("threshold"),
                exclude_video_id=meta.get("exclude"),
            )
        if kind == "fragments":
            # Batched: queries concatenated row-major in one payload, one
            # collective dispatch for the whole batch (queries ride the
            # data axis; one K3 launch per local tile).
            rows = [int(r) for r in meta["rows"]]
            flat = np.frombuffer(
                base64.b64decode(meta["fp"]), np.uint32)
            total = sum(rows)
            words = flat.size // total if total else c._inner.words
            flat = flat.reshape(total, words)
            qlist, at = [], 0
            for r in rows:
                qlist.append(flat[at:at + r].copy())
                at += r
            return c.fragment_search_batch(
                qlist, top_k=int(meta.get("top_k", 5)),
                hamming_threshold=meta.get("threshold"),
                exclude_video_ids=meta.get("excludes"),
            )
        if kind == "remove":
            vid = int(meta["video_id"])
            c.remove_video(vid)
            self._video_ids.discard(vid)
            return None
        if kind == "reset":
            c.refresh_from_store(
                _EmptyStore(), min_ts_rows=self.ts_capacity,
                min_fp_rows=self.fp_capacity)
            self._video_ids.clear()
            return None
        raise ValueError(f"unknown collective op kind: {kind}")

    # -- state mirrors ---------------------------------------------------------

    @property
    def num_videos(self) -> int:
        return len(self._video_ids)

    @property
    def num_fingerprints(self) -> int:
        # Rows in the device index (DeviceCorpus._fp_count parity):
        # includes tombstones until compaction reclaims them, shrinks when
        # it does — the mirror this replaced only ever grew (review r3).
        return int(self.corpus._fp_count)


class _EmptyStore:
    """Stand-in store for the reset op (refresh to empty without touching
    the real store, whose rows the admin route deletes separately)."""

    def all_timestamps(self):
        return []

    def all_fingerprints(self):
        return []


class MultiHostCorpusClient:
    """DeviceCorpus-shaped facade over the collective op log, so the
    analyzer and the service routes run unchanged on a host-spanning
    corpus. Every method is thread-safe: it appends an op and blocks on
    this rank's executor applying it (default timeout covers a cold
    cluster's first kernel builds, and is the process group's too)."""

    def __init__(self, runner: CollectiveRunner, *,
                 max_cuts: int = 128,
                 op_timeout_s: float = DEFAULT_OP_TIMEOUT_S):
        self.runner = runner
        self.max_cuts = max_cuts
        self.op_timeout_s = op_timeout_s
        self.hamming_threshold = runner.hamming_threshold
        self.words = runner.corpus._inner.words

    @property
    def device(self):
        """Where the analyzer of this rank runs K1: its mesh's first
        device."""
        return self.runner.corpus.mesh.home

    # -- ingest ---------------------------------------------------------------

    def upsert_timestamps(self, video_id: int, timestamps) -> None:
        ts = [float(t) for t in timestamps][: self.max_cuts]
        # Empty ts still submits: a zero-cut re-analysis OVERWRITES the
        # video's row to length 0 (DeviceCorpus parity — dropping it would
        # leave every host matching against the stale cuts forever).
        # Ingest payloads travel IN the op row (KBs) so the op is fully
        # reconstructible from the log on the source too — see the append
        # branch of CollectiveRunner._execute.
        self.runner.submit(
            "append",
            {"video_id": int(video_id), "n_ts": len(ts), "n_fp": 0,
             "ts": ts},
        ).wait(self.op_timeout_s)

    def append_fingerprints(self, video_id: int, fingerprints) -> None:
        fps = np.ascontiguousarray(fingerprints, np.uint32)
        if fps.shape[0] == 0:
            return
        self.runner.submit(
            "append",
            {"video_id": int(video_id), "n_ts": 0, "n_fp": int(fps.shape[0]),
             "fp": base64.b64encode(fps.tobytes()).decode("ascii")},
        ).wait(self.op_timeout_s)

    def remove_video(self, video_id: int) -> None:
        self.runner.submit(
            "remove", {"video_id": int(video_id)}).wait(self.op_timeout_s)

    def reset(self) -> None:
        self.runner.submit("reset", {}).wait(self.op_timeout_s)

    def load(self, store) -> None:
        """No-op: the runner warms the shard in start() — before serving —
        because placement must happen on every host at the same point in
        the op order."""

    # -- queries --------------------------------------------------------------

    def match_timestamps(self, query_ts, min_match: int = 2,
                         tolerance: float = 0.0,
                         exclude_video_id: Optional[int] = None
                         ) -> List[Tuple[int, int]]:
        ts = [float(t) for t in query_ts][: self.max_cuts]
        # Empty-QUERY fast path only: corpus emptiness must be decided by
        # the executor at the op's position in the total order — the local
        # num_videos/num_fingerprints mirrors lag the log (review r3: a
        # query racing a peer's un-applied append wrongly returned []).
        if not ts:
            return []
        res = self.runner.submit(
            "ts_query",
            {"ts": ts, "min_match": int(min_match),
             "tolerance": float(tolerance),
             "exclude": (int(exclude_video_id)
                         if exclude_video_id is not None else None)},
        ).wait(self.op_timeout_s)
        return [(int(v), int(c)) for v, c in res]

    def nearest_video_counts(self, query: np.ndarray,
                             exclude_video_id: Optional[int] = None
                             ) -> Dict[int, int]:
        q = np.ascontiguousarray(query, np.uint32)
        if q.shape[0] == 0:
            return {}
        nn = self.runner.submit(
            "fp_query",
            {"fp": base64.b64encode(q.tobytes()).decode("ascii"),
             "rows": int(q.shape[0]), "k": 1,
             "threshold": self.runner.hamming_threshold},
        ).wait(self.op_timeout_s)
        out: Dict[int, int] = {}
        # DeviceCorpus.nearest_video_counts parity: each query frame
        # contributes at most once, via its single nearest row; an excluded
        # nearest contributes nothing (not the next-nearest).
        for per_query in nn:
            if not per_query:
                continue
            d, _idx, vid = per_query[0]
            if (d <= self.runner.hamming_threshold and vid >= 0
                    and vid != exclude_video_id):
                out[vid] = out.get(vid, 0) + 1
        return out

    def search_fingerprints(self, query: np.ndarray, min_match: int = 2,
                            exclude_video_id: Optional[int] = None
                            ) -> List[Tuple[int, int]]:
        """DeviceCorpus.search_fingerprints parity (review r4): evidence
        counts CORPUS frames within threshold of any query frame (not
        query frames' nearest rows), default min_match 2 — a deployment
        moving single-host -> multi-host must get identical verdicts."""
        q = np.ascontiguousarray(query, np.uint32)
        if q.shape[0] == 0:
            return []
        res = self.runner.submit(
            "fp_evidence",
            {"fp": base64.b64encode(q.tobytes()).decode("ascii"),
             "rows": int(q.shape[0]), "min_match": int(min_match),
             "exclude": (int(exclude_video_id)
                         if exclude_video_id is not None else None)},
        ).wait(self.op_timeout_s)
        return [(int(v), int(c)) for v, c in res]

    def locate_fragment(self, query_fps: np.ndarray, top_k: int = 5,
                        hamming_threshold: Optional[int] = None,
                        exclude_video_id: Optional[int] = None
                        ) -> List[Tuple[int, int, int]]:
        q = np.ascontiguousarray(query_fps, np.uint32)
        if q.shape[0] == 0:
            return []
        res = self.runner.submit(
            "fragment",
            {"fp": base64.b64encode(q.tobytes()).decode("ascii"),
             "rows": int(q.shape[0]), "top_k": int(top_k),
             "threshold": hamming_threshold,
             "exclude": (int(exclude_video_id)
                         if exclude_video_id is not None else None)},
        ).wait(self.op_timeout_s)
        return [(int(v), int(o), int(s)) for v, o, s in res]

    def locate_fragments(self, query_fps_list, top_k: int = 5,
                         hamming_threshold: Optional[int] = None,
                         exclude_video_ids=None
                         ) -> List[List[Tuple[int, int, int]]]:
        """Batch localization through ONE collective op: the whole batch
        rides one log row and one device dispatch (one K3 launch per local
        tile) instead of an op per query."""
        qn = len(query_fps_list)
        if qn == 0:
            return []
        excl = list(exclude_video_ids or [None] * qn)
        qs = [np.ascontiguousarray(q, np.uint32) for q in query_fps_list]
        if sum(int(q.shape[0]) for q in qs) == 0:
            return [[] for _ in range(qn)]
        flat = np.concatenate([q for q in qs if q.shape[0]])
        res = self.runner.submit(
            "fragments",
            {"fp": base64.b64encode(flat.tobytes()).decode("ascii"),
             "rows": [int(q.shape[0]) for q in qs],
             "top_k": int(top_k), "threshold": hamming_threshold,
             "excludes": [int(e) if e is not None else None for e in excl]},
        ).wait(self.op_timeout_s)
        return [[(int(v), int(o), int(s)) for v, o, s in per] for per in res]

    # -- properties ------------------------------------------------------------

    @property
    def num_videos(self) -> int:
        return self.runner.num_videos

    @property
    def num_fingerprints(self) -> int:
        return self.runner.num_fingerprints
