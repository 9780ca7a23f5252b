"""The service contract suite on the port.

The 20 tests of tests/test_service.py that take its ``app`` / ``client``
fixtures run here unchanged against the port: this module imports them and
overrides ``app`` with the port's ``create_app(..., device="cpu")`` over the
port's ``DeviceCorpus`` (shared block dispatcher on, as in production). The
one test that builds a second app (``test_status_survives_restart``) gets the
port's ``create_app`` and ``DeviceCorpus`` through the same override. The
two tests there that build their own app or registry from ``tvidz_tpu`` have
port versions below, and ``/search/video`` gets a case of its own.

The imported tests write their videos under fixed ``/tmp/tvidz_test_*``
names; the override moves those into the test's own directory, so this file
and tests/test_service.py can run at the same time.
"""

import functools
import importlib
import json
import os
import time

import pytest

from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.corpus.store import Store
from tvidz_tpu_torch.decode import write_synthetic_y4m
from tvidz_tpu_torch.pipeline.progress import AnalysisRegistry
from tvidz_tpu_torch.service import fakes
from tvidz_tpu_torch.service.app import create_app

ref = importlib.import_module("tests.test_service")

test_status_pending = ref.test_status_pending
test_status_stream_options = ref.test_status_stream_options
test_notify_bad_event = ref.test_notify_bad_event
test_notify_valid_event = ref.test_notify_valid_event
test_clear_db = ref.test_clear_db
test_build_info = ref.test_build_info
test_duplicate_detection_via_debug_routes = ref.test_duplicate_detection_via_debug_routes
test_debug_videos_and_analysis_results = ref.test_debug_videos_and_analysis_results
test_unknown_route_404 = ref.test_unknown_route_404
test_wrong_method_405 = ref.test_wrong_method_405
test_healthz_and_metrics = ref.test_healthz_and_metrics
test_full_ingest_path_with_duplicate = ref.test_full_ingest_path_with_duplicate
test_sse_stream_emits_and_terminates = ref.test_sse_stream_emits_and_terminates
test_sse_pending_then_done = ref.test_sse_pending_then_done
test_search_fragment_route = ref.test_search_fragment_route
test_search_fragments_batch_route = ref.test_search_fragments_batch_route
test_status_survives_restart = ref.test_status_survives_restart
test_options_preflight_on_every_route = ref.test_options_preflight_on_every_route
test_at_least_once_redelivery = ref.test_at_least_once_redelivery
test_warming_gates_device_work = ref.test_warming_gates_device_work

CPU_CORPUS = functools.partial(DeviceCorpus, device="cpu")


def _config(work: str) -> Config:
    """tests/test_service.py's fixture configuration."""
    cfg = Config()
    cfg.pipeline.block_frames = 64
    cfg.pipeline.scene_height = 72
    cfg.pipeline.scene_width = 96
    cfg.pipeline.tmp_dir = work
    cfg.pipeline.download_retry_wait_s = 0.01
    cfg.service.sse_poll_s = 0.02
    os.makedirs(work)
    return cfg


def _redirect_fixed_paths(monkeypatch, tmp_path):
    """The imported tests' /tmp/tvidz_test_* files, moved to tmp_path (in
    the reference module's names: its writer, its ``os`` and the fake S3)."""
    def moved(path):
        path = str(path)
        if path.startswith("/tmp/tvidz_test_"):
            return str(tmp_path / os.path.basename(path))
        return path

    class _Os:
        def __getattr__(self, name):
            return getattr(os, name)

        @staticmethod
        def remove(path):
            os.remove(moved(path))

    class _S3(fakes.FakeS3):
        def put_file(self, bucket, key, src_path):
            return super().put_file(bucket, key, moved(src_path))

    monkeypatch.setattr(ref, "os", _Os())
    monkeypatch.setattr(ref, "write_synthetic_y4m",
                        lambda path, **kw: write_synthetic_y4m(moved(path), **kw))
    return _S3


def make_app(tmp_path, monkeypatch, corpus):
    """The suite's app over ``corpus`` (the ``app`` fixture's; a MeshCorpus
    in tests/test_torch_mesh_corpus.py)."""
    s3_class = _redirect_fixed_paths(monkeypatch, tmp_path)
    monkeypatch.setattr(ref, "create_app",
                        functools.partial(create_app, device="cpu"))
    monkeypatch.setattr(ref, "DeviceCorpus", CPU_CORPUS)
    cfg = _config(str(tmp_path / "work"))
    sqs = fakes.FakeSQS()
    s3 = s3_class(str(tmp_path / "s3"))
    sqs.create_queue(cfg.service.sqs_queue)
    s3.create_bucket(cfg.service.s3_bucket)
    s3.configure_notification(sqs, cfg.service.sqs_queue)
    inspector = create_app(
        config=cfg,
        store=Store("sqlite:///:memory:"),
        corpus=corpus,
        s3=s3, sqs=sqs,
        build_env={"BUILD_DATE": "2026-08-16", "BUILD_TIME": "00:00",
                   "GIT_COMMIT": "deadbeef"},
        device="cpu",
    )
    assert inspector.block_dispatcher is not None
    return inspector


@pytest.fixture
def app(tmp_path, monkeypatch):
    inspector = make_app(tmp_path, monkeypatch, CPU_CORPUS(
        ts_initial_capacity=8, fp_initial_capacity=1024, fp_block_n=256))
    yield inspector
    inspector.stop()


@pytest.fixture
def client(app):
    return app.wsgi.test_client()


def test_sse_pending_timeout_terminates_stream(tmp_path):
    """A stream that never leaves 'pending' ends with an error frame after
    sse_pending_timeout_s."""
    cfg = Config()
    cfg.pipeline.tmp_dir = str(tmp_path / "w")
    cfg.service.sse_poll_s = 0.02
    cfg.service.sse_pending_timeout_s = 0.3
    os.makedirs(cfg.pipeline.tmp_dir)
    inspector = create_app(
        config=cfg, store=Store("sqlite:///:memory:"), s3=fakes.FakeS3(
            str(tmp_path / "s3")), sqs=None, device="cpu")
    try:
        assert inspector.corpus.device.type == "cpu"
        client = inspector.wsgi.test_client()
        t0 = time.time()
        frames = [
            json.loads(chunk.decode()[6:].strip())
            for chunk in client.stream("/status/stream/ghost.mp4")
            if chunk.startswith(b"data: ")
        ]
        assert frames[0] == {"status": "pending"}
        assert frames[-1]["status"] == "error"
        assert "ghost.mp4" in frames[-1]["error"]
        assert time.time() - t0 < 5
    finally:
        inspector.stop()


def test_registry_caps_finished_entries():
    reg = AnalysisRegistry(max_entries=3)
    for i in range(5):
        reg.seed(f"k{i}", original_filename=f"f{i}", clean_filename=f"f{i}")
        reg.finish(f"k{i}", status="done", original_filename=f"f{i}")
    assert len(reg) == 3
    assert reg.lookup("f4") is not None
    assert reg.lookup("f0") is None
    reg2 = AnalysisRegistry(max_entries=2)
    for i in range(4):
        reg2.seed(f"k{i}", original_filename=f"f{i}", clean_filename=f"f{i}")
    assert len(reg2) == 4
    # Restored entries answer by clean name, after live ones.
    reg.finish("restored_9_g.mp4", status="done", clean_filename="g.mp4")
    assert reg.lookup("1723456789-g.mp4")["status"] == "done"


def test_search_video_route(app, client, tmp_path):
    """Query-without-ingest: a renamed copy of an analyzed upload names it
    by fingerprints and aligns with it at offset 0; the corpus is unchanged
    and the uploads went through the shared dispatcher."""
    app.start_poller()
    app.config.pipeline.early_exit = False
    first = ref._upload_and_wait(app, client, app.s3, "sv-src.y4m", seed=21,
                                 cut_frames=(60, 140))
    assert first["status"] == "done" and first["total_cuts"] == 2
    path = tmp_path / "query.y4m"
    write_synthetic_y4m(str(path), num_frames=200, height=72, width=96,
                        cut_frames=(60, 140), seed=21)
    videos = app.corpus.num_videos
    r = client.post("/search/video?filename=copy.y4m&top_k=3",
                    data=path.read_bytes())
    assert r.status_code == 200, r.get_json()
    data = r.get_json()
    assert data["frames"] == 200 and data["scene_cuts"] == first["scene_cuts"]
    assert data["timestamp_matches"][0]["filename"] == "sv-src.y4m"
    assert data["fingerprint_matches"][0]["filename"] == "sv-src.y4m"
    top = data["best_alignments"][0]
    assert top["filename"] == "sv-src.y4m"
    assert top["offset_frames"] == 0 and top["match_count"] == 200
    assert app.corpus.num_videos == videos
    assert client.post("/search/video", data=b"").status_code == 400
    assert client.post("/search/video?filename=x.y4m",
                       data=b"not a video").status_code == 400
    metrics = client.get("/metrics").get_json()
    assert metrics["block_dispatcher"]["passes"] > 0
    assert metrics["corpus_footprint"]["sync_bytes"]["al"] > 0


def test_evict_host_is_single_host(client):
    r = client.post("/admin/evict-host", json_body={"host": "host-1"})
    assert r.status_code == 400
    assert r.get_json()["error"] == "not a multi-host deployment"
