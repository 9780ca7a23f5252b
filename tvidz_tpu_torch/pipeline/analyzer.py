"""The streaming per-video analyzer, on PyTorch.

Port of ``tvidz_tpu/pipeline/analyzer.py``, whose module cannot be imported
without jax (it hard-codes the JAX model and carry). Its host logic is
carried over as it is — keys, fetch retry, store-outage policy, early exit,
checkpoint/resume, prefetch, the timestamp verdict and the
fingerprint-evidence verdict. Only the device seams change; each is marked
``# device seam`` with the reference line it replaces.

The reference's notes on ``analyze_file`` (reference app.py:117-322) hold:

What changes vs the reference (SURVEY.md §7):
- The FFmpeg subprocess + stderr text parse (app.py:197-257) becomes: host
  decode to fixed-size luma blocks -> one fused op per block (scene score
  + packed pHash, ops/fused.py, kernel K1 on the GPU) -> host-side
  thresholding.
- The per-cut full-corpus Python rescan (app.py:234-237, db.py:76-94)
  becomes one device query per block against the on-device corpus
  (corpus/device_corpus.py), plus fingerprint evidence the reference
  never had.

What is preserved bit-for-bit (behavioral contract):
- filename extraction incl. epoch-prefix stripping (app.py:121-132)
- race-proof analysis keys ``{epoch}_{uuid8}_{filename}`` (app.py:133-147)
- download retry x5 with probe validation (app.py:163-196)
- incremental duplicate search with min_match=2, self-exclusion, early
  process termination on first hit (app.py:233-255)
- the progress model incl. the 1-cut-per-10s fallback heuristic and the
  0.3 s write throttle (app.py:258-291)
- final 'done' / 'error' (duplicates preserved) / finally-cleanup states
  (app.py:292-322)
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import uuid
from typing import Callable, List, Optional, Tuple

import numpy as np

from tvidz_tpu_torch._reference import (
    AnalysisRegistry,
    BlockPrefetcher,
    Config,
    DecodeError,
    StageTimer,
    Store,
    get_decoder,
    is_transient_store_error,
    log,
)
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.ops.fused import initial_fingerprint_carry
from tvidz_tpu_torch.ops.scene import NativeSceneScorer
from tvidz_tpu_torch.pipeline.checkpoint import (
    AnalysisCheckpoint,
    content_signature,
)

# fetch(bucket, key, local_path) -> None; raises on failure.
Fetcher = Callable[[str, str, str], None]

# Distinguishes "store unavailable" from a legitimate None/empty result in
# _store_soft call sites (e.g. get_video_by_id of a vanished row).
_OUTAGE = object()


@dataclasses.dataclass
class _DeferredStoreWrites:
    """Store writes skipped during a transient store outage, re-applied at
    finalization (pipeline store-outage policy). The duplicate VERDICT
    itself never depends on the store — it comes from the device corpus —
    only its durable mirror (videos.duplicates) and the duplicate FILENAME
    resolution do."""

    # Latest update_duplicates payload not yet persisted (None = persisted).
    dup_ids: Optional[List[int]] = None
    # Duplicate video ids whose filenames could not be resolved mid-stream.
    unresolved: List[int] = dataclasses.field(default_factory=list)
    # Superseded crashed-attempt rows whose store delete failed during an
    # outage (they ARE already removed from the device corpus, which is what
    # the verdict reads — only the durable row is pending).
    delete_vids: List[int] = dataclasses.field(default_factory=list)


class StoreOutageError(ConnectionError):
    """A CRITICAL store op exhausted the analyzer's in-analysis retry window
    on a TRANSIENT error class (store down for the whole window). Subclasses
    ConnectionError so ``is_transient_store_error`` keeps classifying it.
    Raised only by ``Analyzer._store_retry`` — the precise marker the
    whole-analysis service retry keys on (a transient-class error from any
    OTHER subsystem, e.g. an OSError inside decode, must NOT trigger a
    service-level re-run)."""


class TransientAnalysisError(ConnectionError):
    """Raised by ``Analyzer.analyze`` when the analysis failed because the
    durable store was down for its entire retry window. Carries the context
    the service's whole-analysis retry (service/app._run_analysis) needs to
    re-run cleanly:

    - ``analysis_key``: the failed attempt's registry entry, so the retry
      removes exactly ITS shadowing entry (never a concurrent same-name
      analysis's verdict).
    - ``video_id``: the attempt's videos row if one landed (the re-run
      supersedes it — its partial state would otherwise self-match), else
      None.
    - ``upload_ts``: the attempt's pinned upload_time identity; when no row
      id is known the re-run probes ``find_video_by_upload`` with it first,
      adopting a row whose INSERT landed but whose ack was lost.
    """

    def __init__(self, msg: str, *, analysis_key: str,
                 video_id: Optional[int], upload_ts) -> None:
        super().__init__(msg)
        self.analysis_key = analysis_key
        self.video_id = video_id
        self.upload_ts = upload_ts


@dataclasses.dataclass
class AnalysisRetryContext:
    """Threaded by the service's whole-analysis retry into each re-run
    attempt (``Analyzer.analyze(..., retry_ctx=...)``)."""

    # A lost-ack attempt's pinned upload_time: probe find_video_by_upload
    # BEFORE inserting so a row whose INSERT landed server-side is adopted,
    # not leaked as a dead duplicate row.
    reuse_upload_ts: Optional[object] = None
    # Failed attempts' orphan rows: removed from the device corpus at raise
    # time; this run deletes the durable rows (the store is presumably back).
    supersede_vids: List[int] = dataclasses.field(default_factory=list)
    # True while the service still has retry attempts left: a transient
    # failure records the NON-terminal 'retrying' status instead of a
    # terminal 'error', so SSE watchers stay connected through the re-run
    # instead of acting on a false permanent failure.
    more_attempts: bool = False


@dataclasses.dataclass
class AnalysisResult:
    analysis_key: str
    video_id: int
    status: str
    scene_cuts: List[float]
    duplicates: List[str]
    error: Optional[str] = None


def extract_filenames(key: str) -> Tuple[str, str]:
    """(filename, original_filename) from an S3 key — app.py:121-132.

    The frontend uploads as ``{epoch_ms}-{name}`` (App.js:95); the all-digit
    prefix is stripped to recover the logical name used for dedup.
    """
    filename = key.split("/")[-1] if key and "/" in key else key or "unknown_file"
    if not filename:
        filename = "unknown_file"
    original = filename
    if "-" in filename and filename.split("-")[0].isdigit():
        original = "-".join(filename.split("-")[1:])
    return filename, original


class Analyzer:
    """One instance per process; ``analyze`` may be called from many threads
    (one per upload, like the reference's thread-per-event, app.py:43,472)."""

    def __init__(
        self,
        store: Store,
        corpus: DeviceCorpus,
        registry: AnalysisRegistry,
        fetcher: Fetcher,
        config: Optional[Config] = None,
    ):
        self.store = store
        self.corpus = corpus
        self.registry = registry
        self.fetcher = fetcher
        self.config = config or Config()
        self.timer = StageTimer()
        # Video ids with an analysis currently in flight in this process —
        # checkpoint resume must never supersede (delete_video/remove_video)
        # a LIVE attempt's row (ADVICE r2: two concurrent same-name
        # same-content uploads share ckpt_key).
        self._active_lock = threading.Lock()
        self._active_vids: set = set()
        # The ONE per-block implementation (process_block) shared with
        # CLI/search/multistream lives on the model.
        # device seam (tvidz_tpu/pipeline/analyzer.py:176-178): the port's
        # model, on the corpus's device.
        self._model = FingerprintModel(self.config, device=corpus.device)

    # -- public ----------------------------------------------------------------

    def analyze(self, bucket: str, key: str,
                retry_ctx: Optional[AnalysisRetryContext] = None,
                ) -> AnalysisResult:
        cfg = self.config
        filename, original_filename = extract_filenames(key)
        log("filename-extraction",
            f"S3 key: {key}, filename: {filename}, original: {original_filename}")

        unique_id = f"{int(time.time())}_{uuid.uuid4().hex[:8]}"
        local_path = os.path.join(cfg.pipeline.tmp_dir, f"{unique_id}_{filename}")
        analysis_key = f"{unique_id}_{filename}"

        self.registry.remove(analysis_key)
        if os.path.exists(local_path):
            try:
                os.remove(local_path)
                log("cleanup", f"Removed stale file: {local_path}")
            except OSError as e:
                log("cleanup", f"Failed to remove stale file: {local_path} ({e})")

        log("analysis-triggered", f"Starting analysis for {filename}")
        try:
            # add_video is a plain INSERT (every upload is a new row), so a
            # blind retry after a transport failure that raced a commit that
            # actually LANDED would double-insert. Pin the row's identity
            # (filename, upload_time) up front; retries first look for a row
            # the lost first attempt may have created and adopt it.
            # A service-level re-run of a lost-ack attempt reuses ITS pinned
            # upload_ts so the probe below can adopt a row whose INSERT
            # landed server-side during the outage (else that row is leaked
            # as a dead duplicate: no in-analysis lookup ever saw it).
            reuse = retry_ctx.reuse_upload_ts if retry_ctx else None
            upload_ts = reuse if reuse is not None else self.store.utcnow()
            attempted = [reuse is not None]

            def _add_video_once():
                if attempted[0]:
                    existing = self.store.find_video_by_upload(
                        original_filename, upload_ts)
                    if existing is not None:
                        log("store-outage",
                            f"adopting video row {existing.id}: the INSERT "
                            "landed before the transport failure")
                        return existing
                attempted[0] = True
                return self.store.add_video(
                    original_filename, upload_time=upload_ts)

            video = self._store_retry("add_video", _add_video_once)
        except Exception as e:  # noqa: BLE001
            # Store down for the WHOLE retry window before a row even
            # exists: record a verdict so /status and SSE watchers see a
            # state instead of 'pending' until timeout. While the service
            # still has re-run attempts left the state is the NON-terminal
            # 'retrying' (SSE stays open through the re-run); only the
            # final attempt is terminal 'error'.
            transient = isinstance(e, StoreOutageError)
            retrying = transient and retry_ctx is not None \
                and retry_ctx.more_attempts
            self.registry.seed(analysis_key, original_filename=filename,
                               clean_filename=original_filename)
            self.registry.finish(
                analysis_key, status="retrying" if retrying else "error",
                error=str(e), progress=0.0,
                total_cuts=0, duplicates=[], original_filename=filename,
                clean_filename=original_filename,
            )
            if transient:
                raise TransientAnalysisError(
                    str(e), analysis_key=analysis_key, video_id=None,
                    upload_ts=upload_ts) from e
            raise
        video_id = video.id
        # Supersede failed prior attempts' orphan rows (service retry): the
        # device-side removal already happened at raise time; the durable
        # delete runs now against the recovered store. A still-failing
        # delete is deferred to this run's finalization re-apply.
        pending_deletes: List[int] = []
        if retry_ctx:
            for sv in list(retry_ctx.supersede_vids):
                if sv == video_id:
                    continue
                try:
                    self.corpus.remove_video(sv)
                except Exception as e:  # noqa: BLE001
                    # Multi-host: the remove is a collective op against
                    # the same (possibly still-down) store. Analyzing
                    # with sv's rows live would self-match, so surface
                    # this as ANOTHER transient attempt — video_id rides
                    # along so the next attempt supersedes this one's
                    # landed row too (the service re-appends the old
                    # supersede_vids from its retry context). Record a
                    # verdict FIRST: without it this attempt has no
                    # registry entry at all and a final-attempt failure
                    # here would leave /status 'pending' forever.
                    log("analysis-retry",
                        f"supersede removal of row {sv} failed "
                        f"transiently: {e}; deferring to the next attempt")
                    retrying = retry_ctx.more_attempts
                    self.registry.seed(
                        analysis_key, original_filename=filename,
                        clean_filename=original_filename)
                    self.registry.finish(
                        analysis_key,
                        status="retrying" if retrying else "error",
                        error=f"supersede removal failed: {e}",
                        progress=0.0, total_cuts=0, duplicates=[],
                        original_filename=filename,
                        clean_filename=original_filename,
                    )
                    raise TransientAnalysisError(
                        f"supersede removal failed: {e}",
                        analysis_key=analysis_key, video_id=video_id,
                        upload_ts=upload_ts) from e
                deleted = self._store_soft(
                    "delete_video(retry-supersede)",
                    lambda s=sv: (self.store.delete_video(s), True)[1],
                    default=False)
                if deleted:
                    log("analysis-retry",
                        f"superseded failed attempt row {sv}")
                    # Fully superseded (device remove + durable delete):
                    # drop it from the retry context so a later attempt
                    # doesn't re-issue the remove as a fresh collective
                    # op — and can't spuriously fail on a row that's
                    # already gone. A soft-failed durable delete stays
                    # carried (pending_deletes covers THIS run; the next
                    # attempt must still retry it if this one dies).
                    retry_ctx.supersede_vids.remove(sv)
                else:
                    pending_deletes.append(sv)
        with self._active_lock:
            self._active_vids.add(video_id)
        self.registry.seed(analysis_key, original_filename=filename,
                           clean_filename=original_filename)
        log("analysis-start",
            f"Created analysis key: {analysis_key} for original filename: {filename}")

        scene_cuts: List[float] = []
        dups_to_report: List[str] = []
        status = "error"
        error_msg: Optional[str] = None
        try:
            info = self._download_with_retry(bucket, key, local_path)
            total_frames = info.nb_frames
            log("frame-count", f"Total frames detected: {total_frames}")
            scene_cuts, dups_to_report = self._stream_analyze(
                local_path, analysis_key, filename, video_id, total_frames,
                clean_filename=original_filename,
                pending_deletes=pending_deletes,
            )
            status = "done"
            final_state = dict(
                status="done",
                scene_cuts=scene_cuts,
                progress=1.0,
                total_cuts=len(scene_cuts),
                duplicates=sorted(set(dups_to_report)) if dups_to_report else [],
                original_filename=filename,
                clean_filename=original_filename,
            )
            self.registry.finish(analysis_key, **final_state)
            self._persist_final_state(original_filename, video_id, final_state)
        except Exception as e:  # noqa: BLE001 — mirrors app.py:303's blanket handler
            error_msg = str(e)
            # Store down through FINALIZATION too (add_timestamps /
            # add_fingerprints final persist exhausted, StoreOutageError):
            # propagate to the service's whole-analysis retry after
            # recording the verdict. The attempt's fingerprints are
            # resident on device and its row may be durable — remove the
            # device side NOW (a re-run would verdict the video a
            # duplicate OF ITSELF); the durable row is the re-run's
            # supersede_vids job, the store being down here.
            transient = isinstance(e, StoreOutageError)
            retrying = transient and retry_ctx is not None \
                and retry_ctx.more_attempts
            if transient:
                try:
                    self.corpus.remove_video(video_id)
                except Exception as rm_err:  # noqa: BLE001
                    # Multi-host: the device removal is itself a
                    # collective op against the down store. It must not
                    # destroy THIS recovery path (verdict + re-raise to
                    # the service retry loop) — the re-run supersedes
                    # video_id first thing, removing these rows once the
                    # store is back; until then the orphan rows are inert
                    # to other uploads (different video id).
                    log("analysis",
                        f"device-side removal of {video_id} deferred to "
                        f"the retry's supersede step: {rm_err}")
            existing_duplicates = self.registry.get_existing_duplicates(analysis_key)
            final_state = dict(
                status="retrying" if retrying else "error",
                error=error_msg,
                progress=0.0,
                total_cuts=0,
                duplicates=existing_duplicates,
                original_filename=filename,
                clean_filename=original_filename,
            )
            self.registry.finish(analysis_key, **final_state)
            if not retrying:
                # (When retrying, the store is down and a successful re-run
                # overwrites this state anyway — skip the doomed persist.)
                self._persist_final_state(
                    original_filename, video_id, final_state)
            if transient:
                # (the finally below still discards _active_vids and
                # removes the local file on this raise path)
                raise TransientAnalysisError(
                    error_msg, analysis_key=analysis_key,
                    video_id=video_id, upload_ts=upload_ts) from e
            dups_to_report = existing_duplicates
        finally:
            with self._active_lock:
                self._active_vids.discard(video_id)
            if os.path.exists(local_path):
                try:
                    os.remove(local_path)
                    log("cleanup", f"Removed file: {local_path}")
                except OSError as e:
                    log("cleanup", f"Failed to remove file: {local_path} ({e})")

        return AnalysisResult(
            analysis_key=analysis_key,
            video_id=video_id,
            status=status,
            scene_cuts=scene_cuts,
            duplicates=sorted(set(dups_to_report)),
            error=error_msg,
        )

    def _persist_final_state(self, clean_filename: str, video_id: int,
                             state: dict) -> None:
        """Durable mirror of the registry's FINAL state (written only at
        finalize). Lets any host of a multi-host deployment — or this host
        after an eviction/restart — serve the exact done/error payload
        from /status (service/app._lookup_state). Never fatal: the
        in-memory state is already correct."""
        try:
            # Retry transient outages (store-outage policy below) — this is
            # the payload a restarted/multi-host /status serves — but stay
            # non-fatal on exhaustion: in-memory state is already correct.
            self._store_retry(
                "save_analysis_state",
                lambda: self.store.save_analysis_state(
                    clean_filename, video_id, state))
        except Exception as e:  # noqa: BLE001
            log("analysis-state", f"failed to persist final state: {e}")

    # -- store-outage policy -----------------------------------------------------
    #
    # The reference fails the whole analysis on any DB error (app.py:303).
    # Here an analysis rides out a transient store outage (server restart,
    # failover, connection blip) because every mid-stream store write is
    # re-upserted at finalization anyway: add_timestamps writes the FULL
    # cut array each time (db.py:43-64 upsert semantics), checkpoints are
    # whole-state blobs, and the duplicate verdict comes from the device
    # corpus, not the store. Policy:
    #   - CRITICAL ops (add_video, finalization persist) retry transient
    #     errors store_retry_attempts times, riding Store's lazy reconnect;
    #     exhausted retries surface as the analysis error (reference parity).
    #   - SKIPPABLE mid-stream ops log + skip on transient errors; anything
    #     the final state needs (duplicates column, duplicate filenames) is
    #     recorded in _DeferredStoreWrites and re-applied at finalization.
    # Non-transient errors (SQL/programming bugs) always propagate.

    def _store_retry(self, what: str, fn):
        cfg = self.config.pipeline
        attempts = max(1, cfg.store_retry_attempts)
        for attempt in range(attempts):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — filtered below
                if not is_transient_store_error(e):
                    raise
                if attempt == attempts - 1:
                    # Marker the service's whole-analysis retry keys on:
                    # transient class + CRITICAL store op + window exhausted.
                    raise StoreOutageError(
                        f"{what} failed after {attempts} attempts: {e}"
                    ) from e
                log("store-outage",
                    f"{what} failed transiently (attempt {attempt + 1}/"
                    f"{attempts}): {e}; retrying in {cfg.store_retry_wait_s}s")
                time.sleep(cfg.store_retry_wait_s)

    def _store_soft(self, what: str, fn, default=None):
        """One attempt; a transient failure is logged and swallowed
        (returns ``default``) because finalization re-applies the state."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — filtered below
            if not is_transient_store_error(e):
                raise
            log("store-outage", f"{what} skipped during store outage: {e}")
            return default

    # -- internals -----------------------------------------------------------------

    def _download_with_retry(self, bucket: str, key: str, local_path: str):
        """Download + probe-validate, up to N attempts (app.py:163-196)."""
        cfg = self.config.pipeline
        last_exc: Optional[Exception] = None
        for attempt in range(cfg.download_retries):
            try:
                with self.timer.stage("download"):
                    self.fetcher(bucket, key, local_path)
                with self.timer.stage("probe"):
                    return get_decoder(local_path).probe(local_path)
            except Exception as e:  # noqa: BLE001
                last_exc = e
                if attempt < cfg.download_retries - 1:
                    time.sleep(cfg.download_retry_wait_s)
        raise DecodeError(
            f"File download incomplete or corrupt after "
            f"{cfg.download_retries} attempts: {last_exc}"
        )

    def _stream_analyze(
        self,
        local_path: str,
        analysis_key: str,
        filename: str,
        video_id: int,
        total_frames: int,
        clean_filename: Optional[str] = None,
        pending_deletes: Optional[List[int]] = None,
    ) -> Tuple[List[float], List[str]]:
        cfg = self.config
        block_t = cfg.pipeline.block_frames
        h, w = cfg.pipeline.scene_height, cfg.pipeline.scene_width

        decoder = get_decoder(local_path, lowres=cfg.pipeline.decode_lowres,
                              dct_dc=cfg.pipeline.decode_dct_dc)
        # device seam (tvidz_tpu/pipeline/analyzer.py:517)
        carry = initial_fingerprint_carry(h, w, self._model.device)

        scene_cuts: List[float] = []
        all_fps: List[np.ndarray] = []
        dups_to_report: List[str] = []
        deferred = _DeferredStoreWrites()
        if pending_deletes:
            # Orphan rows from superseded service-retry attempts whose
            # durable delete failed even against the supposedly-recovered
            # store: re-applied at this run's finalization like any other
            # outage-deferred delete.
            deferred.delete_vids.extend(pending_deletes)
        fp_evidence: dict = {}
        duplicate_found = False
        last_progress = 0.0
        last_update_time = time.time()
        current_frame = 0
        # Native-resolution scene scoring (reference-faithful path: FFmpeg
        # scores on full decoded frames, app.py:206) — shared policy object,
        # ops/scene.NativeSceneScorer.
        scene_scorer = NativeSceneScorer(
            cfg.scene.native_resolution,
            host_mafd_fallback=self._model.ship_coeffs)
        thumbnail_pending = bool(cfg.pipeline.thumbnail_dir)

        # Resume from a prior interrupted run of the same content, if any
        # (pipeline/checkpoint.py; the reference restarts from scratch).
        ckpt_key: Optional[str] = None
        resume_from = 0
        resume_catchup = False
        blocks_since_ckpt = 0
        if cfg.pipeline.checkpoint_every_blocks > 0:
            # Keyed by the CLEAN logical name + content: the name keeps
            # two concurrent different-named uploads of identical bytes
            # from splicing each other's progress, while staying stable
            # across a crash and its re-upload (epoch prefixes differ per
            # attempt, the clean name and content don't).
            logical = clean_filename or filename
            ckpt_key = f"{logical}:{content_signature(local_path)}"
            # A transient store outage degrades to a fresh analysis
            # (checkpointing is an optimization, never a dependency).
            blob = self._store_soft(
                "load_checkpoint", lambda: self.store.load_checkpoint(ckpt_key))
            if blob is not None:
                try:
                    ckpt = AnalysisCheckpoint.from_blob(blob)
                    # Only resume on exact content + block-aligned progress
                    # with matching geometry; otherwise restart cleanly.
                    if (
                        ckpt.content_sig == ckpt_key
                        and ckpt.frames_done % block_t == 0
                        and ckpt.carry_prev_frame.shape == (h, w)
                        and (
                            ckpt.fingerprints.size == 0
                            or ckpt.fingerprints.shape[1] == cfg.hash.words
                        )
                    ):
                        old_vid = ckpt.video_id
                        with self._active_lock:
                            old_vid_live = old_vid in self._active_vids
                        if old_vid_live:
                            # The checkpoint belongs to a CONCURRENT
                            # analysis still running in this process (two
                            # same-name same-content uploads share
                            # ckpt_key). Superseding would delete its live
                            # row mid-analysis and strand its store writes
                            # — restart cleanly instead (ADVICE r2).
                            log("checkpoint",
                                f"not resuming: attempt {old_vid} is live")
                        else:
                            # Supersede the crashed attempt's orphaned
                            # partial row FIRST: its timestamps are an exact
                            # copy of what this analysis will re-store, so
                            # leaving it would report the video as a
                            # duplicate OF ITSELF. The device-side removal
                            # is process-local and must happen even
                            # mid-outage (the verdict reads the corpus, not
                            # the store — a resident orphan self-matches
                            # whether we resume OR restart); only the
                            # durable delete can be deferred.
                            if old_vid is not None and old_vid != video_id:
                                self.corpus.remove_video(old_vid)
                                deleted = self._store_soft(
                                    "delete_video(supersede)",
                                    lambda: (self.store.delete_video(old_vid),
                                             True)[1],
                                    default=False)
                                if deleted:
                                    log("checkpoint",
                                        f"superseded crashed attempt row {old_vid}")
                                else:
                                    deferred.delete_vids.append(old_vid)
                                    log("store-outage",
                                        f"crashed attempt {old_vid} removed "
                                        "from corpus; store delete deferred "
                                        "to finalization")
                            resume_from = ckpt.frames_done
                            resume_catchup = True
                            scene_cuts = list(ckpt.scene_cuts)
                            if ckpt.fingerprints.shape[0]:
                                all_fps = [ckpt.fingerprints]
                            # device seam (tvidz_tpu/pipeline/analyzer.py:623)
                            carry = ckpt.restore_carry(self._model.device)
                            log("checkpoint",
                                f"resuming {filename} at frame {resume_from} "
                                f"({len(scene_cuts)} cuts so far)")
                except Exception as e:  # noqa: BLE001 — corrupt ckpt = restart
                    log("checkpoint", f"ignoring unreadable checkpoint: {e}")

        # A checkpoint-resumed analysis must re-evaluate duplicates for its
        # RESTORED cuts/fingerprints once, BEFORE the block loop: if the
        # crash happened after the final checkpoint (video length divisible
        # by block_frames), every block is skipped as already-fingerprinted,
        # so an in-loop catch-up would never execute and the analysis would
        # finish 'done' without a verdict.
        if resume_catchup:
            resume_catchup = False
            if scene_cuts:
                duplicate_found = self._apply_timestamp_duplicates(
                    video_id, scene_cuts, dups_to_report, deferred
                )
            if (
                cfg.match.use_fingerprint_evidence
                and self.corpus.num_fingerprints > 0
                and all_fps
            ):
                restored_fps = np.concatenate(all_fps)
                with self.timer.stage("fp-search"):
                    hits = self.corpus.nearest_video_counts(
                        restored_fps, exclude_video_id=video_id
                    )
                for vid, count in hits.items():
                    fp_evidence[vid] = fp_evidence.get(vid, 0) + count
                if not duplicate_found:
                    duplicate_found = self._apply_fp_duplicates(
                        video_id, fp_evidence, dups_to_report, deferred
                    )
            if duplicate_found:
                self.registry.update(
                    analysis_key,
                    scene_cuts=list(scene_cuts),
                    duplicates=sorted(set(dups_to_report)),
                )

        block_iter = decoder.blocks(local_path, block_t, h, w)
        prefetcher = None
        if cfg.pipeline.decode_prefetch_blocks > 0:
            prefetcher = BlockPrefetcher(
                block_iter, depth=cfg.pipeline.decode_prefetch_blocks
            )
            block_iter = iter(prefetcher)

        try:
            for block in block_iter:
                t = block.luma.shape[0]
                if thumbnail_pending:
                    # Before the resume-skip: a crash after the FINAL
                    # checkpoint replays every block, and the new video row
                    # would otherwise never get a thumbnail.
                    thumbnail_pending = False
                    self._write_thumbnail(video_id, block.luma[min(t - 1, t // 2)])
                if block.start_frame + t <= resume_from:
                    # Already fingerprinted in a previous run: replay decode
                    # only — keeping the native scene recurrence warm.
                    current_frame = block.start_frame + t
                    scene_scorer.replay(block)
                    continue
                with self.timer.stage("fingerprint"):
                    # THE shared per-block path (FingerprintModel.
                    # process_block): pad + valid_t carry + scorer policy +
                    # cut extraction (threshold, 6-decimal rounding,
                    # consecutive dedupe) — one implementation across
                    # analyzer/CLI/multistream so cut timestamps can't fork
                    # between surfaces.
                    fps, carry, new_cuts, t = self._model.process_block(
                        block, carry, scene_scorer,
                        last_cut=scene_cuts[-1] if scene_cuts else None,
                    )
                all_fps.append(fps)
                current_frame = block.start_frame + t
                scene_cuts.extend(new_cuts)
                new_cut = bool(new_cuts)

                if new_cut and not duplicate_found:
                    duplicate_found = self._apply_timestamp_duplicates(
                        video_id, scene_cuts, dups_to_report, deferred
                    )

                # Fingerprint evidence (north-star Hamming path): catches content
                # the exact-timestamp rule misses, e.g. re-encodes at a different
                # frame rate. Each QUERY frame credits its nearest corpus video
                # at most once (blocks partition the query frames, so per-block
                # accumulation never double-counts, and a corpus video full of
                # near-identical frames can't inflate evidence); verdict once any
                # video crosses fp_min_match.
                if (
                    cfg.match.use_fingerprint_evidence
                    and not duplicate_found
                    and self.corpus.num_fingerprints > 0
                ):
                    with self.timer.stage("fp-search"):
                        block_hits = self.corpus.nearest_video_counts(
                            fps, exclude_video_id=video_id
                        )
                    for vid, count in block_hits.items():
                        fp_evidence[vid] = fp_evidence.get(vid, 0) + count
                    duplicate_found = self._apply_fp_duplicates(
                        video_id, fp_evidence, dups_to_report, deferred
                    )

                progress = self._progress(current_frame, total_frames, scene_cuts)
                now = time.time()
                if (
                    progress > last_progress
                    or now - last_update_time > cfg.pipeline.update_throttle_s
                    or new_cut
                ):
                    last_progress = progress
                    last_update_time = now
                    log("progress-update",
                        f"{filename}: {progress*100:.2f}% "
                        f"({current_frame}/{total_frames}) scene_cuts={len(scene_cuts)}")
                    self.registry.update(
                        analysis_key,
                        progress=progress,
                        scene_cuts=list(scene_cuts),
                        **(
                            {"duplicates": sorted(set(dups_to_report))}
                            if dups_to_report
                            else {}
                        ),
                    )

                blocks_since_ckpt += 1
                if (
                    ckpt_key is not None
                    and t == block_t
                    and blocks_since_ckpt >= cfg.pipeline.checkpoint_every_blocks
                ):
                    blocks_since_ckpt = 0
                    blob_out = AnalysisCheckpoint.capture(
                        ckpt_key, current_frame, scene_cuts, all_fps,
                        carry, video_id=video_id,
                    ).to_blob()
                    # Missing one checkpoint during an outage only widens
                    # the resume window — never worth failing the analysis.
                    self._store_soft(
                        "save_checkpoint",
                        lambda: self.store.save_checkpoint(ckpt_key, blob_out))

                if duplicate_found and cfg.pipeline.early_exit:
                    # Early termination — the analog of process.terminate()
                    # (app.py:249-255): stop decoding, keep what we have.
                    log("duplicate",
                        "decode loop terminated early due to duplicate detection.")
                    self.registry.update(
                        analysis_key,
                        progress=progress,
                        scene_cuts=list(scene_cuts),
                        **(
                            {"duplicates": sorted(set(dups_to_report))}
                            if dups_to_report
                            else {}
                        ),
                    )
                    break

        finally:
            if prefetcher is not None:
                # Stop the decode-ahead worker promptly on every exit
                # path (early-exit break, device/store exceptions).
                prefetcher.close()

        # Persist artifacts: timestamps (final) + packed fingerprints — makes
        # re-analysis idempotent (checkpoint/resume story, SURVEY.md §5).
        # These are the CRITICAL durable record: retry transient outages
        # with backoff; exhausted retries fail the analysis (ref parity).
        if scene_cuts:
            self._store_retry(
                "add_timestamps(final)",
                lambda: self.store.add_timestamps(video_id, scene_cuts))
            self.corpus.upsert_timestamps(video_id, scene_cuts)
        if all_fps:
            fps_full = np.concatenate(all_fps)
            self._store_retry(
                "add_fingerprints(final)",
                lambda: self.store.add_fingerprints(video_id, fps_full))
            self.corpus.append_fingerprints(video_id, fps_full)

        # Re-apply store writes skipped during a mid-stream outage: deferred
        # orphan-row deletes first (so nothing below can resolve against a
        # superseded row), then the latest duplicates payload, and duplicate
        # ids whose filenames the store couldn't resolve at verdict time.
        for dead_vid in deferred.delete_vids:
            try:
                self._store_retry(
                    "delete_video(deferred)",
                    lambda d=dead_vid: self.store.delete_video(d))
            except Exception as e:  # noqa: BLE001 — filtered below
                if not is_transient_store_error(e):
                    raise
                # The orphan is already gone from the device corpus (what
                # verdicts read); a still-durable row is cleanup debt the
                # next resume of this content retries — never worth failing
                # a finished analysis.
                log("store-outage",
                    f"orphan row {dead_vid} still durable (store outage): {e}")
        deferred.delete_vids = []
        if deferred.dup_ids is not None:
            self._store_retry(
                "update_duplicates(deferred)",
                lambda: self.store.update_duplicates(video_id, deferred.dup_ids))
            deferred.dup_ids = None
        for dup_id in deferred.unresolved:
            dup_video = self._store_retry(
                "get_video_by_id(deferred)",
                lambda d=dup_id: self.store.get_video_by_id(d))
            if dup_video and dup_video.filename not in dups_to_report:
                dups_to_report.append(dup_video.filename)
                log("duplicate",
                    f"Match found: {dup_video.filename} "
                    "(resolved after store outage)")

        if ckpt_key is not None:
            # A leftover checkpoint row is harmless (superseded on the next
            # run) — never worth failing a finished analysis over.
            self._store_soft(
                "delete_checkpoint",
                lambda: self.store.delete_checkpoint(ckpt_key))

        return scene_cuts, dups_to_report

    def _write_thumbnail(self, video_id: int, luma: np.ndarray) -> None:
        """Best-effort JPEG thumbnail from an early decoded luma frame —
        populates the reference's never-written videos.thumbnail_path."""
        try:
            import io

            from PIL import Image

            os.makedirs(self.config.pipeline.thumbnail_dir, exist_ok=True)
            path = os.path.join(
                self.config.pipeline.thumbnail_dir, f"{video_id}.jpg"
            )
            buf = io.BytesIO()
            Image.fromarray(np.asarray(luma, np.uint8), mode="L").save(
                buf, format="JPEG", quality=85
            )
            with open(path, "wb") as f:
                f.write(buf.getvalue())
            self.store.update_thumbnail(video_id, path)
        except Exception as e:  # noqa: BLE001 — thumbnails never fail analysis
            log("thumbnail", f"skipped for video {video_id}: {e}")

    def _apply_timestamp_duplicates(
        self, video_id: int, scene_cuts: List[float],
        dups_to_report: List[str], deferred: _DeferredStoreWrites,
    ) -> bool:
        """Persist the cuts, query the corpus, record any duplicates
        (app.py:233-255 semantics). Returns True on a verdict.

        Store writes here are SOFT (store-outage policy above): the verdict
        comes from the device corpus; the durable mirror (timestamps,
        duplicates column, duplicate filenames) is re-applied at
        finalization via ``deferred`` if the store is mid-outage."""
        cfg = self.config
        with self.timer.stage("dedup-search"):
            self._store_soft(
                "add_timestamps",
                lambda: self.store.add_timestamps(video_id, scene_cuts))
            self.corpus.upsert_timestamps(video_id, scene_cuts)
            dups = self.corpus.match_timestamps(
                scene_cuts,
                min_match=cfg.match.min_match,
                tolerance=cfg.match.timestamp_tolerance,
                exclude_video_id=video_id,
            )
        if not dups:
            return False
        self._record_duplicates(
            video_id, [d[0] for d in dups], deferred, replace=True,
            dups_to_report=dups_to_report,
            detail={d[0]: f"{d[1]} matching timestamps" for d in dups},
        )
        log("duplicate",
            f"Found {len(dups_to_report)} duplicates: {dups_to_report}")
        log("duplicate", f"Current scene cuts: {scene_cuts}")
        return True

    def _apply_fp_duplicates(
        self, video_id: int, fp_evidence: dict,
        dups_to_report: List[str], deferred: _DeferredStoreWrites,
    ) -> bool:
        """Verdict once any video's accumulated fingerprint evidence crosses
        fp_min_match. Returns True on a verdict. Store writes are SOFT —
        see _apply_timestamp_duplicates."""
        cfg = self.config
        strong = [
            (vid, total) for vid, total in fp_evidence.items()
            if total >= cfg.match.fp_min_match
        ]
        if not strong:
            return False
        strong.sort(key=lambda vc: -vc[1])
        self._record_duplicates(
            video_id, [v for v, _ in strong], deferred, replace=False,
            dups_to_report=dups_to_report,
            detail={v: f"{t} matching fingerprint frames" for v, t in strong},
        )
        log("duplicate",
            f"Found {len(dups_to_report)} duplicates via "
            f"fingerprints: {dups_to_report}")
        return True

    def _record_duplicates(
        self, video_id: int, dup_ids: List[int],
        deferred: _DeferredStoreWrites, *, replace: bool,
        dups_to_report: List[str], detail: dict,
    ) -> None:
        """Shared duplicate-recording path: persist the duplicates column
        (soft — latest payload is kept in ``deferred`` until a write lands)
        and resolve duplicate ids to filenames, deferring ids the store
        could not resolve mid-outage to finalization."""
        deferred.dup_ids = list(dup_ids)
        persisted = self._store_soft(
            "update_duplicates",
            lambda: (self.store.update_duplicates(video_id, dup_ids), True)[1],
            default=False,
        )
        if persisted:
            deferred.dup_ids = None
        if replace:
            del dups_to_report[:]
            del deferred.unresolved[:]
        for dup_id in dup_ids:
            dup_video = self._store_soft(
                "get_video_by_id",
                lambda d=dup_id: self.store.get_video_by_id(d),
                default=_OUTAGE,
            )
            if dup_video is _OUTAGE:
                if dup_id not in deferred.unresolved:
                    deferred.unresolved.append(dup_id)
                continue
            if dup_video and dup_video.filename not in dups_to_report:
                dups_to_report.append(dup_video.filename)
                log("duplicate",
                    f"Match found: {dup_video.filename} ({detail[dup_id]})")

    @staticmethod
    def _progress(current_frame: int, total_frames: int, cuts: List[float]) -> float:
        """Progress model incl. the reference's 1-cut-per-10s fallback
        heuristic (app.py:258-266)."""
        if total_frames > 0 and current_frame > 0:
            return min(current_frame / total_frames, 1.0)
        if cuts:
            estimated_duration = max(cuts) + 10
            return min(len(cuts) * 10 / estimated_duration, 1.0)
        return 0.0
