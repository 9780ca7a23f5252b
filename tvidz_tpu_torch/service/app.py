"""The inspector HTTP service, on the port.

Port of ``tvidz_tpu/service/app.py``: the same routes, JSON shapes and SSE
framing (the wire contract of the Flask app it rebuilds, whose line refs
are kept below), carried onto the port's ``DeviceCorpus``, ``Analyzer``,
``FingerprintModel``, ``SharedBlockDispatcher`` and registry, on an explicit
``device``. The HTTP layer (``wsgi``) is the port's copy of the reference's.
In a multi-host deployment (``parallel.collective``) the entrypoint sets
``collective_runner``: ``/metrics`` then carries the op log's hygiene,
``/admin/evict-host`` evicts a stalled member, and ``stop`` stops the
runner; elsewhere ``/admin/evict-host`` answers "not a multi-host
deployment".

Routes (reference line refs):
- POST /notify                     app.py:31-44
- GET  /status/<filename>          app.py:46-62
- GET  /status/stream/<filename>   app.py:64-115 (SSE) + OPTIONS app.py:23-25
- POST /admin/clear-db             app.py:325-333
- GET  /build-info                 app.py:335-345
- GET  /debug/videos               app.py:347-366
- POST /debug/create-test-video    app.py:368-384
- GET  /debug/analysis-results     app.py:386-393
- POST /debug/test-duplicate       app.py:395-415
plus the framework's extensions: GET /healthz, GET /metrics, GET /,
GET /thumbnails/<id>, POST /upload/<key>, GET /upload-url/<key>,
POST /search/fragment, POST /search/fragments, POST /search/video and
POST /admin/evict-host.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from typing import Optional

from tvidz_tpu_torch import __version__, backend
from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.corpus.store import Store
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.pipeline.analyzer import (
    Analyzer,
    AnalysisRetryContext,
    TransientAnalysisError,
    extract_filenames,
)
from tvidz_tpu_torch.pipeline.dispatcher import SharedBlockDispatcher
from tvidz_tpu_torch.pipeline.progress import AnalysisRegistry
from tvidz_tpu_torch.service import wsgi
from tvidz_tpu_torch.utils import log

App, Request, Response, jsonify = wsgi.App, wsgi.Request, wsgi.Response, wsgi.jsonify
_STATIC_INDEX = os.path.join(os.path.dirname(wsgi.__file__), "static",
                             "index.html")


def _cors(resp: Response) -> Response:
    """CORS * on every response (app.py:15-21)."""
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
    resp.headers["Access-Control-Allow-Headers"] = "Content-Type"
    return resp


class InspectorApp:
    def __init__(
        self,
        config: Optional[Config] = None,
        store: Optional[Store] = None,
        corpus: Optional[DeviceCorpus] = None,
        s3=None,
        sqs=None,
        build_env: Optional[dict] = None,
        device=None,
    ):
        self.config = config or Config()
        self.store = store or Store(self.config.store.url)
        self.corpus = corpus or DeviceCorpus(
            max_cuts=self.config.match.max_cuts,
            words=self.config.hash.words,
            hamming_threshold=self.config.match.hamming_threshold,
            device=device,
        )
        # One device for the whole app: the corpus's.
        self.device = self.corpus.device
        if device is not None and backend.resolve_device(device) != self.device:
            raise ValueError(f"device {device!r} differs from the corpus's "
                             f"{self.device}")
        self.registry = AnalysisRegistry(
            max_entries=self.config.service.max_analysis_results
        )
        self.s3 = s3
        self.sqs = sqs
        self.build_env = build_env or {}
        self._stop = threading.Event()
        self._poller_thread: Optional[threading.Thread] = None
        self._poller_stats = {"processed": 0, "malformed": 0,
                              "receive_errors": 0, "analysis_retries": 0}
        # Set by the entrypoint once the kernels are built and the device is
        # warm; in-process embedders (tests) are ready immediately. Analysis
        # threads and the /search routes wait for it.
        self._device_ready_evt = threading.Event()
        self._device_ready_evt.set()

        def fetcher(bucket: str, key: str, local_path: str) -> None:
            if self.s3 is None:
                raise RuntimeError("no S3 client configured")
            self.s3.download(bucket, key, local_path,
                             self.config.pipeline.download_chunk_bytes)

        self.analyzer = Analyzer(
            self.store, self.corpus, self.registry, fetcher, self.config
        )
        # Shared batched block dispatcher (pipeline/dispatcher.py):
        # concurrent uploads' blocks ride one pass instead of a private
        # forward each. Off => reference-shaped per-thread dispatch.
        self.block_dispatcher = None
        # Decoder admission (ServiceConfig.max_concurrent_analyses):
        # bounds how many upload analyses run their decode body at once;
        # excess queue FIFO on this semaphore with status 'pending'.
        n_slots = self.config.service.max_concurrent_analyses
        self._analysis_slots = (
            threading.BoundedSemaphore(n_slots) if n_slots > 0 else None)
        if self.config.pipeline.shared_dispatcher:
            self.block_dispatcher = SharedBlockDispatcher(
                self.analyzer._model,
                dispatcher_window_s=self.config.pipeline.dispatcher_window_s,
            ).start()
            self.analyzer._model.dispatcher = self.block_dispatcher
        # Warm the device corpus from durable storage — unlike the reference,
        # verdict capability survives restarts (SURVEY.md §5 checkpoint gap).
        self.corpus.load(self.store)
        # Rebuild 'done' analysis states for completed videos so /status and
        # SSE keep answering after a restart (the reference returns 'pending'
        # forever for pre-restart uploads, SURVEY.md §3.4 note).
        self._restore_done_states()

        self.wsgi = self._build_routes()

    def _restore_done_states(self, max_videos: int = 10_000) -> None:
        videos = self.store.all_videos()
        if len(videos) > max_videos:
            log("restore", f"{len(videos)} videos in store; restoring only "
                           f"the most recent {max_videos} states")
            videos = videos[-max_videos:]
        by_id = {v.id: v for v in videos}
        # One query for every timestamp row — a per-video get_timestamps
        # here was O(N) round-trips at every boot.
        ts_by_video = dict(self.store.all_timestamps())
        restored = 0
        for v in videos:
            cuts = ts_by_video.get(v.id)
            if not cuts:
                continue
            names = set()
            for d in v.duplicates:
                if d in by_id:
                    names.add(by_id[d].filename)
                else:
                    # Duplicate id outside the restored window (VERDICT r2
                    # weak #6): resolve with one store lookup instead of
                    # silently dropping the name from /status.
                    rec = self.store.get_video_by_id(d)
                    if rec is not None:
                        names.add(rec.filename)
            dup_names = sorted(names)
            self.registry.finish(
                f"restored_{v.id}_{v.filename}",
                status="done",
                scene_cuts=cuts,
                progress=1.0,
                total_cuts=len(cuts),
                duplicates=dup_names,
                original_filename=v.filename,
                clean_filename=v.filename,
            )
            restored += 1
        if restored:
            log("restore", f"restored {restored} completed analysis states "
                           "from the durable store")

    @property
    def device_ready(self) -> bool:
        return self._device_ready_evt.is_set()

    @device_ready.setter
    def device_ready(self, value: bool) -> None:
        if value:
            self._device_ready_evt.set()
        else:
            self._device_ready_evt.clear()

    # -- analysis dispatch -------------------------------------------------------

    @staticmethod
    def _decode_event_key(key: str) -> str:
        """Real S3 event notifications URL-encode object keys ('my video.mp4'
        arrives as 'my+video.mp4'); decode before use. The reference passes
        the raw key through and fails on such names (SURVEY quirk not kept)."""
        return urllib.parse.unquote_plus(key)

    def start_analysis_thread(self, bucket: str, key: str,
                              decode_key: bool = True) -> threading.Thread:
        """Thread-per-upload, like app.py:43,472.

        ``decode_key=False`` for keys that never crossed an S3 event wire
        (the direct-dispatch /upload path): those are already decoded by
        WSGI, and a second unquote_plus would corrupt names containing '+'
        or '%' sequences."""
        t = threading.Thread(
            target=self._run_analysis,
            args=(bucket,
                  self._decode_event_key(key) if decode_key else key),
            daemon=True,
        )
        t.start()
        return t

    def _run_analysis(self, bucket: str, key: str) -> None:
        try:
            # Wait until the entrypoint has built the kernels and warmed the
            # device; events accepted during warm-up start right after.
            while not self._device_ready_evt.wait(timeout=1.0):
                if self._stop.is_set():
                    return
            # Decoder admission: more concurrent decoders than cores only
            # thrash (see config). Queued analyses stay 'pending' — the
            # reference-compatible eventually-processed contract.
            if self._analysis_slots is not None:
                while not self._analysis_slots.acquire(timeout=1.0):
                    if self._stop.is_set():
                        return
            try:
                self._run_analysis_admitted(bucket, key)
            finally:
                if self._analysis_slots is not None:
                    self._analysis_slots.release()
        except Exception as e:  # noqa: BLE001 — worker threads never die loudly
            log("analysis", f"unhandled analysis error for {key}: {e}")

    def _run_analysis_admitted(self, bucket: str, key: str) -> None:
        try:
            # Whole-analysis retry (store-outage policy, second half): if a
            # CRITICAL store op exhausted the analyzer's in-analysis retry
            # window — the store was down for the whole analysis, from
            # add_video through finalization persist — re-run from the
            # still-present S3 object, bounded. Between attempts the failed
            # attempt's state is the NON-terminal 'retrying' (SSE watchers
            # stay connected through the re-run; sanctioned deviation, see
            # CLAUDE.md); only the final attempt records terminal 'error'.
            attempts = max(1, self.config.service.analysis_retry_attempts)
            retry_ctx = AnalysisRetryContext(more_attempts=attempts > 1)
            for attempt in range(attempts):
                try:
                    self.analyzer.analyze(bucket, key, retry_ctx=retry_ctx)
                    return
                except TransientAnalysisError as e:
                    if attempt == attempts - 1:
                        raise
                    self._poller_stats["analysis_retries"] += 1
                    wait_s = self.config.service.analysis_retry_wait_s
                    log("analysis-retry",
                        f"store was down for the whole analysis of {key} "
                        f"(attempt {attempt + 1}/{attempts}): {e}; "
                        f"re-running in {wait_s}s")
                    if self._stop.wait(wait_s):
                        # Shutting down mid-retry: the non-terminal
                        # 'retrying' state must not outlive the loop.
                        self.registry.update(e.analysis_key, status="error")
                        return
                    # Remove exactly the failed attempt's shadowing entry
                    # (scoped by ITS analysis_key — /status scans return
                    # the first insertion-order match, and a filename-wide
                    # sweep would delete a concurrent same-name analysis's
                    # legitimate verdict).
                    self.registry.remove(e.analysis_key)
                    nxt = AnalysisRetryContext(
                        more_attempts=attempt + 1 < attempts - 1,
                        supersede_vids=list(retry_ctx.supersede_vids),
                    )
                    if e.video_id is not None:
                        # The attempt's row landed: the re-run supersedes
                        # it (its partial state would self-match).
                        nxt.supersede_vids.append(e.video_id)
                    else:
                        # No row id ever reached us — but the INSERT may
                        # have landed server-side (lost ack). The re-run
                        # probes find_video_by_upload with the attempt's
                        # pinned upload_ts and adopts such a row.
                        nxt.reuse_upload_ts = e.upload_ts
                    retry_ctx = nxt
        except Exception as e:  # noqa: BLE001 — worker threads never die loudly
            log("analysis", f"unhandled analysis error for {key}: {e}")

    # -- routes ----------------------------------------------------------------------

    def _build_routes(self) -> App:
        app = App("inspector")
        app.after_request(_cors)
        cfg = self.config

        @app.route("/notify", methods=["POST"])
        def notify(request: Request):
            data = request.get_json(silent=True)
            try:
                record = data["Records"][0]
                bucket = record["s3"]["bucket"]["name"]
                key = record["s3"]["object"]["key"]
            except Exception as e:  # noqa: BLE001 — app.py:39
                return jsonify(
                    {"error": "Invalid event format", "details": str(e)}, 400
                )
            self.start_analysis_thread(bucket, key)
            return jsonify({"status": "Analysis started", "file": key})

        @app.route("/status/<filename>", methods=["GET"])
        def status(request: Request, filename: str):
            result = self._lookup_state(filename)
            if not result:
                log("status", f"No result in memory for {filename}")
                return jsonify({"status": "pending"})
            log("status", f"Serving result from memory for {filename}")
            return jsonify(result)

        @app.route("/status/stream/<filename>", methods=["OPTIONS"])
        def status_stream_options(request: Request, filename: str):
            return Response()

        @app.route("/status/stream/<filename>", methods=["GET"])
        def status_stream(request: Request, filename: str):
            return Response(
                self._event_stream(filename),
                mimetype="text/event-stream",
                headers={"Cache-Control": "no-cache"},
            )

        @app.route("/admin/clear-db", methods=["POST"])
        def clear_db(request: Request):
            self.store.clear()
            # Device corpus must drop with the durable corpus. (In-memory
            # analysis_results intentionally survive, like the reference.)
            self.corpus.reset()
            return jsonify({"status": "cleared"})

        @app.route("/build-info", methods=["GET"])
        def build_info(request: Request):
            env = self.build_env or os.environ
            return jsonify({
                "inspector": {
                    "build_date": env.get("BUILD_DATE", "unknown"),
                    "build_time": env.get("BUILD_TIME", "unknown"),
                    "git_commit": env.get("GIT_COMMIT", "unknown"),
                    "service": "inspector",
                }
            })

        @app.route("/debug/videos", methods=["GET"])
        def debug_videos(request: Request):
            result = []
            # One query for all timestamp rows (a per-video get_timestamps
            # was N+1 round-trips at 10k videos, like _restore_done_states).
            ts_by_video = dict(self.store.all_timestamps())
            for video in self.store.all_videos():
                result.append({
                    "id": video.id,
                    "filename": video.filename,
                    "upload_time": (
                        video.upload_time.isoformat() if video.upload_time else None
                    ),
                    "duplicates": video.duplicates,
                    "timestamps": ts_by_video.get(video.id, []),
                    # extension field (old clients ignore it)
                    "has_thumbnail": bool(
                        video.thumbnail_path
                        and os.path.exists(video.thumbnail_path)
                    ),
                })
            return jsonify({"videos": result, "count": len(result)})

        @app.route("/thumbnails/<video_id>", methods=["GET"])
        def thumbnail(request: Request, video_id: str):
            """Serve the per-video JPEG thumbnail the analyzer captures
            (populates the reference's never-written thumbnail_path)."""
            try:
                video = self.store.get_video_by_id(int(video_id))
            except ValueError:
                return jsonify({"error": "bad video id"}, 400)
            if (
                video is None
                or not video.thumbnail_path
                or not os.path.exists(video.thumbnail_path)
            ):
                return jsonify({"error": "no thumbnail"}, 404)
            with open(video.thumbnail_path, "rb") as f:
                return Response(f.read(), mimetype="image/jpeg",
                                headers={"Cache-Control": "max-age=3600"})

        @app.route("/debug/create-test-video", methods=["POST"])
        def create_test_video(request: Request):
            body = request.get_json(silent=True) or {}
            test_filename = body.get("filename", "test_video.mp4")
            test_timestamps = body.get("timestamps", [1.2, 5.7, 12.3, 18.9, 25.1])
            try:
                video = self.store.add_video(test_filename)
                self.store.add_timestamps(video.id, test_timestamps)
                self.corpus.upsert_timestamps(video.id, test_timestamps)
                return jsonify({
                    "status": "created",
                    "video_id": video.id,
                    "filename": test_filename,
                    "timestamps": test_timestamps,
                })
            except Exception as e:  # noqa: BLE001 — app.py:383
                return jsonify({"error": str(e)}, 500)

        @app.route("/debug/analysis-results", methods=["GET"])
        def debug_analysis_results(request: Request):
            snap = self.registry.snapshot()
            return jsonify({"analysis_results": snap, "count": len(snap)})

        @app.route("/debug/test-duplicate", methods=["POST"])
        def test_duplicate_scenario(request: Request):
            first_video = self.store.add_video("test.mp4")
            self.store.add_timestamps(first_video.id, [1.2, 5.7, 12.3, 18.9])
            self.corpus.upsert_timestamps(first_video.id, [1.2, 5.7, 12.3, 18.9])
            timestamp = int(time.time() * 1000)
            second_filename = f"{timestamp}-test.mp4"
            dups = self.corpus.match_timestamps(
                [1.2, 5.7, 12.3, 18.9], min_match=2
            )
            return jsonify({
                "first_video_id": first_video.id,
                "second_filename": second_filename,
                "duplicates_found": [[v, c] for v, c in dups],
                "message": (
                    "Created test video, then tested duplicate detection "
                    f"for {second_filename}"
                ),
            })

        # -- framework extensions (not in the reference) --------------------

        @app.route("/", methods=["GET"])
        @app.route("/index.html", methods=["GET"])
        def index(request: Request):
            """First-party frontend (the reference serves its React app from
            a separate container on :3000; ours is dependency-free and served
            in-process — same features, see the reference's
            service/static/index.html)."""
            with open(_STATIC_INDEX, "rb") as f:
                return Response(f.read(), mimetype="text/html; charset=utf-8")

        @app.route("/upload/<key>", methods=["POST"])
        def upload(request: Request, key: str):
            """Direct upload: store the object in S3 and let the configured
            event path (S3 notification -> SQS -> poller) trigger analysis;
            without a queue, dispatch directly. Replaces the reference
            frontend's browser-side presigned S3 PUT (App.js:201-249) with a
            same-origin route so the UI works without AWS credentials."""
            if self.s3 is None:
                return jsonify({"error": "no S3 client configured"}, 500)
            data = request.body
            if not data:
                return jsonify({"error": "empty upload"}, 400)
            bucket = cfg.service.s3_bucket
            self.s3.put_object(bucket, key, data)
            if self.sqs is None:
                # WSGI already decoded this path param; it never crossed an
                # S3 event wire, so don't decode it a second time.
                self.start_analysis_thread(bucket, key, decode_key=False)
            return jsonify({"status": "uploaded", "bucket": bucket, "key": key,
                            "bytes": len(data)})

        @app.route("/upload-url/<key>", methods=["GET"])
        def upload_url(request: Request, key: str):
            """Presigned S3 PUT URL for browser-direct uploads — the
            reference frontend's flow (App.js:201-207: getSignedUrl with
            expiresIn 300) served from the backend so the browser needs no
            AWS credentials. Requires bucket CORS (applied by bootstrap)."""
            if self.s3 is None or not hasattr(self.s3, "presign_put"):
                return jsonify(
                    {"error": "presigned uploads need a real S3 client"}, 501
                )
            try:
                expires = int(request.query.get("expires_in", "300"))
            except ValueError:
                return jsonify({"error": "expires_in must be an integer"}, 400)
            if not 1 <= expires <= 604800:  # real S3 caps presigns at 7 days
                return jsonify(
                    {"error": "expires_in must be in [1, 604800]"}, 400
                )
            url = self.s3.presign_put(cfg.service.s3_bucket, key,
                                      expires_in=expires)
            return jsonify({"url": url, "bucket": cfg.service.s3_bucket,
                            "key": key, "expires_in": expires})

        @app.route("/search/fragment", methods=["POST"])
        def search_fragment(request: Request):
            """Partial-reuse search: locate a span of an analyzed video
            inside the fingerprint corpus (BASELINE config #3). Body:
            {"filename": <analyzed video>, "start_frame": int,
             "num_frames": int, "top_k": int} — uses the stored fingerprint
            sequence of `filename` as the query fragment."""
            if not self.device_ready:
                return jsonify({"error": "service warming up"}, 503)
            body = request.get_json(silent=True) or {}
            filename = body.get("filename")
            if not filename:
                return jsonify({"error": "filename required"}, 400)
            video = self.store.get_video_by_filename(filename)
            if video is None:
                return jsonify({"error": f"unknown video {filename}"}, 404)
            fps = self.store.get_fingerprints(video.id)
            if fps is None or fps.shape[0] == 0:
                return jsonify({"error": f"no fingerprints for {filename}"}, 404)
            try:
                start = int(body.get("start_frame", 0))
                num = int(body.get("num_frames", min(64, fps.shape[0])))
                top_k_v = int(body.get("top_k", 5))
            except (TypeError, ValueError):
                return jsonify(
                    {"error": "start_frame/num_frames/top_k must be integers"},
                    400)
            if start < 0 or num <= 0:
                return jsonify(
                    {"error": "start_frame must be >= 0, num_frames > 0"}, 400)
            frag = fps[start : start + num]
            if frag.shape[0] == 0:
                return jsonify({"error": "empty fragment span"}, 400)
            hits = self.corpus.locate_fragment(
                frag,
                top_k=top_k_v,
                exclude_video_id=(
                    video.id if body.get("exclude_self", True) else None
                ),
            )
            resolved = []
            for vid, offset, score in hits:
                v = self.store.get_video_by_id(vid)
                resolved.append({
                    "video_id": vid,
                    "filename": v.filename if v else None,
                    "offset_frames": offset,
                    "match_count": score,
                    "fragment_frames": int(frag.shape[0]),
                })
            return jsonify({"query": {"filename": filename,
                                      "start_frame": start,
                                      "num_frames": int(frag.shape[0])},
                            "matches": resolved})

        @app.route("/search/fragments", methods=["POST"])
        def search_fragments(request: Request):
            """Batch partial-reuse search: locate several spans in one
            request. Body: {"queries": [{"filename": ..., "start_frame":
            int, "num_frames": int, "exclude_self": bool}, ...],
            "top_k": int}. On a mesh service this runs 2D-parallel
            (queries over the data axis x corpus videos over the corpus
            axis, MeshCorpus.locate_fragments)."""
            if not self.device_ready:
                return jsonify({"error": "service warming up"}, 503)
            body = request.get_json(silent=True) or {}
            queries = body.get("queries")
            if not isinstance(queries, list) or not queries:
                return jsonify({"error": "queries list required"}, 400)
            try:
                top_k = int(body.get("top_k", 5))
            except (TypeError, ValueError):
                return jsonify({"error": "top_k must be an integer"}, 400)
            frags, excls, metas = [], [], []
            for spec in queries:
                filename = (spec or {}).get("filename")
                if not filename:
                    return jsonify({"error": "filename required"}, 400)
                video = self.store.get_video_by_filename(filename)
                if video is None:
                    return jsonify(
                        {"error": f"unknown video {filename}"}, 404)
                fps = self.store.get_fingerprints(video.id)
                if fps is None or fps.shape[0] == 0:
                    return jsonify(
                        {"error": f"no fingerprints for {filename}"}, 404)
                try:
                    start = int(spec.get("start_frame", 0))
                    num = int(spec.get("num_frames", min(64, fps.shape[0])))
                except (TypeError, ValueError):
                    return jsonify(
                        {"error": "start_frame/num_frames must be integers"},
                        400)
                if start < 0 or num <= 0:
                    return jsonify(
                        {"error": "start_frame must be >= 0, num_frames > 0"},
                        400)
                frag = fps[start : start + num]
                if frag.shape[0] == 0:
                    return jsonify({"error": "empty fragment span"}, 400)
                frags.append(frag)
                excls.append(
                    video.id if spec.get("exclude_self", True) else None)
                metas.append((filename, start, int(frag.shape[0])))
            batch = self.corpus.locate_fragments(
                frags, top_k=top_k, exclude_video_ids=excls)
            out = []
            for (filename, start, nf), hits in zip(metas, batch):
                resolved = []
                for vid, offset, score in hits:
                    v = self.store.get_video_by_id(vid)
                    resolved.append({
                        "video_id": vid,
                        "filename": v.filename if v else None,
                        "offset_frames": offset,
                        "match_count": score,
                        "fragment_frames": nf,
                    })
                out.append({"query": {"filename": filename,
                                      "start_frame": start,
                                      "num_frames": nf},
                            "matches": resolved})
            return jsonify({"results": out})

        @app.route("/search/video", methods=["POST"])
        def search_video(request: Request):
            """Query-without-ingest: POST a raw video body, get verdicts
            against the corpus without adding the video to it (the service
            counterpart of `python -m tvidz_tpu_torch search`). Query params:
            ?filename=<name>&top_k=N."""
            if not self.device_ready:
                return jsonify({"error": "service warming up"}, 503)
            data = request.body
            if not data:
                return jsonify({"error": "empty body"}, 400)
            name = request.query.get("filename", "query.bin")
            try:
                top_k = int(request.query.get("top_k", "5"))
            except ValueError:
                return jsonify({"error": "top_k must be an integer"}, 400)
            import tempfile

            suffix = os.path.splitext(name)[1] or ".bin"
            with tempfile.NamedTemporaryFile(
                suffix=suffix, dir=cfg.pipeline.tmp_dir, delete=False
            ) as f:
                f.write(data)
                tmp_path = f.name
            try:
                model = FingerprintModel(cfg, device=self.device)
                cuts, fps = model.analyze_path(tmp_path)
                if fps.shape[0] == 0:
                    return jsonify({"error": "no decodable frames"}, 400)
            except Exception as e:  # noqa: BLE001 — undecodable upload
                return jsonify({"error": f"decode failed: {e}"}, 400)
            finally:
                try:
                    os.remove(tmp_path)
                except OSError:
                    pass

            ts_matches = self.corpus.match_timestamps(
                cuts, min_match=cfg.match.min_match,
                tolerance=cfg.match.timestamp_tolerance,
            )
            fp_counts = self.corpus.nearest_video_counts(fps)
            frag = self.corpus.locate_fragment(fps, top_k=top_k)

            def resolve(vid):
                v = self.store.get_video_by_id(vid)
                return v.filename if v else None

            # Same evidence floor the CLI/analyzer apply: single-frame hits
            # are random 64-bit collisions at corpus scale, not matches.
            fp_sorted = sorted(
                ((v, c) for v, c in fp_counts.items()
                 if c >= cfg.match.fp_min_match),
                key=lambda vc: -vc[1],
            )[:top_k]
            return jsonify({
                "filename": name,
                "frames": int(fps.shape[0]),
                "scene_cuts": cuts,
                "timestamp_matches": [
                    {"video_id": v, "filename": resolve(v),
                     "matching_timestamps": c} for v, c in ts_matches[:top_k]
                ],
                "fingerprint_matches": [
                    {"video_id": v, "filename": resolve(v),
                     "matching_frames": c} for v, c in fp_sorted
                ],
                "best_alignments": [
                    {"video_id": v, "filename": resolve(v),
                     "offset_frames": o, "match_count": s}
                    for v, o, s in frag
                ],
            })

        @app.route("/healthz", methods=["GET"])
        def healthz(request: Request):
            return jsonify({
                "status": "ok" if self.device_ready else "warming",
                "version": __version__,
                "poller_alive": bool(
                    self._poller_thread and self._poller_thread.is_alive()
                ),
                "corpus_videos": self.corpus.num_videos,
                "corpus_fingerprints": self.corpus.num_fingerprints,
            })

        @app.route("/metrics", methods=["GET"])
        def metrics(request: Request):
            out = {
                "stage_timings": self.analyzer.timer.summary(),
                "analyses_in_memory": len(self.registry),
                "corpus_videos": self.corpus.num_videos,
                "corpus_fingerprints": self.corpus.num_fingerprints,
                "ingestion": dict(self._poller_stats),
                # The port's hand-written kernels: launches since the
                # service became ready (the entrypoint zeroes them then).
                "kernel_launches": {k.name: k.launches
                                    for k in backend.KERNELS},
            }
            # Device-resident index footprint + sync accounting (churn
            # hygiene observable); absent on corpus variants without it.
            footprint = getattr(self.corpus, "device_footprint", None)
            if footprint is not None:
                out["corpus_footprint"] = footprint
            if self.block_dispatcher is not None:
                d = self.block_dispatcher
                out["block_dispatcher"] = {
                    "passes": d.passes,
                    "blocks": d.blocks,
                    "batching": round(d.blocks / d.passes, 2)
                    if d.passes else 0.0,
                    # Wedge signal: seconds the current device pass has
                    # been in flight (0 = idle); every queued analysis is
                    # blocked behind a stuck pass.
                    "pass_age_s": round(d.pass_age_s(), 1),
                }
            # Multi-host op-log hygiene (collective.py _hygiene): live row
            # count, per-member watermarks, prune point, and the
            # stalled-member lag alarm (runbook: docs/multihost.md). Read
            # from the store alone: no collective runs here.
            runner = getattr(self, "collective_runner", None)
            if runner is not None:
                out["collective_oplog"] = runner.oplog_status()
            return jsonify(out)

        @app.route("/admin/evict-host", methods=["POST"])
        def evict_host(request: Request):
            """Operator eviction of a stalled collective member: sets the
            EVICTED watermark sentinel so pruning stops pinning on it and
            the member fences itself at its next hygiene pass. Framework
            extension route (no reference counterpart); only meaningful in
            multi-host mode."""
            runner = getattr(self, "collective_runner", None)
            if runner is None:
                return jsonify(
                    {"error": "not a multi-host deployment"}, 400)
            data = request.get_json(silent=True) or {}
            member = data.get("host")
            if not member or not str(member).startswith("host-"):
                return jsonify(
                    {"error": "body must be {\"host\": \"host-N\"}"}, 400)
            if member == f"host-{runner.process_index}":
                return jsonify(
                    {"error": "cannot evict the serving host through "
                              "itself; call a peer"}, 400)
            try:
                self.store.evict_collective_member(str(member))
            except KeyError:
                # Unregistered member = operator typo; a 200 here would
                # read as "runbook step done" while the actually-stalled
                # member keeps pinning pruning.
                return jsonify(
                    {"error": f"{member} is not a registered collective "
                              "member",
                     "members": sorted(
                         h for h, _s, _u in
                         self.store.collective_watermarks())}, 400)
            log("admin", f"evicted collective member {member}")
            return jsonify({"status": "evicted", "host": member,
                            "oplog": runner.oplog_status()})

        return app

    # -- SSE --------------------------------------------------------------------------

    def _lookup_state(self, filename: str) -> Optional[dict]:
        """Registry lookup with a durable-store fallback for FINISHED
        analyses whose in-memory state this process never had (analyzed on
        ANOTHER HOST of a multi-host deployment) or no longer has (evicted
        from the finished-LRU).

        Gated on ``service.status_store_fallback`` (the entrypoint enables
        it in multi-host mode) because it softens the reference's exact
        resolution for live re-uploads: between /notify and the analyzer
        seeding the registry, a same-clean-name poll would answer with the
        PREVIOUS video's done state. The newest-row rule below closes that
        window once add_video has run (the new row has no timestamps yet ->
        pending); single-host deployments keep reference parity by
        default."""
        result = self.registry.lookup(filename)
        if result:
            return result
        if not self.config.service.status_store_fallback:
            return None
        _, clean = extract_filenames(filename)
        loaded = self.store.load_analysis_state(clean)
        if loaded is None:
            return None  # never finalized anywhere: pending
        state_vid, state = loaded
        # In-flight guard: the state row is written ONLY at finalize, so if
        # a NEWER video row exists for this clean name, a re-analysis is in
        # flight (add_video runs at analysis start) — stay pending rather
        # than serving the previous attempt's final state. (Timestamps are
        # NOT a finished marker: the analyzer upserts them per cut.)
        v = self.store.get_latest_video_by_filename(clean)
        if v is not None and v.id > state_vid:
            return None
        return dict(state)

    def _event_stream(self, filename: str):
        """Generator with the reference's exact change-detection + framing
        (app.py:66-110): emit on any status/progress/cuts/duplicates change,
        poll every sse_poll_s, terminate after 'done'/'error'."""
        poll = self.config.service.sse_poll_s
        pending_timeout = self.config.service.sse_pending_timeout_s
        # Store-fallback throttle: the registry polls at the reference's
        # exact 0.2 s, but the store leg (2 SQL queries against the SHARED
        # db, each able to stall behind a writer's busy_timeout) runs at
        # sse_store_poll_s — a stream for an analysis on another host
        # would otherwise hammer the store 10x/s for its whole life.
        store_poll = max(poll, self.config.service.sse_store_poll_s)
        last_store_check = 0.0
        last_store_result = None
        pending_since = time.time()
        last_status = last_progress = None
        last_cuts_len = last_dups_len = None
        while True:
            result = self.registry.lookup(filename)
            if not result and self.config.service.status_store_fallback:
                now_t = time.time()
                if now_t - last_store_check >= store_poll:
                    last_store_check = now_t
                    last_store_result = self._lookup_state(filename)
                result = last_store_result
            if not result:
                status, progress, cuts_len, dups_len = "pending", 0.0, 0, 0
                # A stream that never leaves 'pending' (unknown filename,
                # lost event) would otherwise hold a handler thread forever
                # — the reference leaks one Flask thread per abandoned
                # client (app.py:66-110). 0 disables (reference parity).
                if pending_timeout > 0 and time.time() - pending_since > pending_timeout:
                    yield (
                        "data: "
                        + json.dumps({
                            "status": "error",
                            "error": f"no analysis for {filename} after "
                                     f"{pending_timeout:.0f}s",
                        })
                        + "\n\n"
                    )
                    break
            else:
                pending_since = time.time()
                status = result.get("status")
                progress = result.get("progress", 0.0)
                cuts_len = len(result.get("scene_cuts", []))
                dups_len = len(result.get("duplicates", []))
            if (
                status != last_status
                or progress != last_progress
                or cuts_len != last_cuts_len
                or dups_len != last_dups_len
            ):
                last_status, last_progress = status, progress
                last_cuts_len, last_dups_len = cuts_len, dups_len
                data = result if result else {"status": "pending"}
                yield f"data: {json.dumps(data)}\n\n"
                if status in ("done", "error"):
                    break
            time.sleep(poll)

    # -- ingestion --------------------------------------------------------------------

    def start_poller(self) -> None:
        """Daemon SQS poller thread (app.py:483)."""
        self._poller_thread = threading.Thread(target=self.poll_sqs, daemon=True)
        self._poller_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self.block_dispatcher is not None:
            self.block_dispatcher.stop()
        # Multi-host mode: stop the collective executor too (set by the
        # entrypoint; None everywhere else).
        runner = getattr(self, "collective_runner", None)
        if runner is not None:
            runner.stop()

    def poll_sqs(self) -> None:
        """Long-poll loop with at-least-once semantics (app.py:417-480):
        double-encoded Message unwrap, thread per record, delete only on
        successful dispatch, idle sleep between polls."""
        if self.sqs is None:
            log("poll_sqs", "no SQS client configured; poller exiting")
            return
        cfg = self.config.service
        queue_url = self.sqs.get_or_create_queue(
            cfg.sqs_queue, retries=cfg.sqs_create_retries
        )
        if not queue_url:
            log("poll_sqs", "Failed to get SQS queue URL after multiple attempts.")
            return
        while not self._stop.is_set():
            try:
                messages = self.sqs.receive(
                    queue_url, wait_s=cfg.sqs_wait_s, max_messages=1
                )
            except Exception as e:  # noqa: BLE001
                log("poll_sqs", f"receive error: {e}")
                self._poller_stats["receive_errors"] += 1
                time.sleep(cfg.sqs_idle_sleep_s)
                continue
            for msg in messages:
                processed_successfully = False
                try:
                    body = json.loads(msg["Body"])
                    if "Message" in body:  # double-encoded (app.py:467)
                        body = json.loads(body["Message"])
                    record = body["Records"][0]
                    bucket = record["s3"]["bucket"]["name"]
                    key = record["s3"]["object"]["key"]
                    self.start_analysis_thread(bucket, key)
                    processed_successfully = True
                    self._poller_stats["processed"] += 1
                except Exception as e:  # noqa: BLE001
                    log("poll_sqs", f"Error processing SQS message: {e}")
                    self._poller_stats["malformed"] += 1
                finally:
                    if processed_successfully:
                        try:
                            self.sqs.delete(queue_url, msg["ReceiptHandle"])
                        except Exception as e:  # noqa: BLE001
                            # At-least-once: a failed delete redelivers the
                            # message later; it must NOT kill the poller.
                            log("poll_sqs", f"delete failed (will redeliver): {e}")
                            self._poller_stats["receive_errors"] += 1
            self._stop.wait(cfg.sqs_idle_sleep_s)


def create_app(
    config: Optional[Config] = None,
    store: Optional[Store] = None,
    corpus: Optional[DeviceCorpus] = None,
    s3=None,
    sqs=None,
    build_env: Optional[dict] = None,
    device=None,
) -> InspectorApp:
    return InspectorApp(
        config=config, store=store, corpus=corpus, s3=s3, sqs=sqs,
        build_env=build_env, device=device,
    )
