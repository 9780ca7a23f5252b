"""The port's spans (``tvidz_tpu_torch/utils/timing.py``) on the CPU: off
unless a ``torch.profiler`` session records, and then, through the service
with the in-process fakes, one trace id from an upload's S3 event to its
SSE verdict, and one from a fragment search to its pull."""

import json
import re
import threading
import time
import tracemalloc

import pytest
import torch

from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.corpus.store import Store
from tvidz_tpu_torch.decode import write_synthetic_y4m
from tvidz_tpu_torch.service import app as app_module
from tvidz_tpu_torch.service import fakes
from tvidz_tpu_torch.service.app import create_app
from tvidz_tpu_torch.utils import timing

STAGES = ["dedup-search", "download", "fingerprint", "fp-search", "probe"]
STATE_KEYS = {"status", "scene_cuts", "progress", "total_cuts", "duplicates",
              "original_filename", "clean_filename"}


def profiler():
    """A CPU profiler recording every thread, as the benchmark's is."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    try:
        cfg = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return profile(activities=[ProfilerActivity.CPU])
    return profile(activities=[ProfilerActivity.CPU], experimental_config=cfg)


def since(t0, trace_id=None):
    return [r for r in timing.TRACER.finished()
            if r.t0 >= t0 and (trace_id is None or r.trace == trace_id)]


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


@pytest.fixture
def no_device_calls(monkeypatch):
    """Profiler ranges, CUDA events and synchronisation all raise."""
    def refuse(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def test_off_spans_leave_no_record_and_open_nothing(no_device_calls):
    assert not timing.tracing()
    t0 = time.perf_counter()
    before = timing.TRACER.summary().get("test.off", {}).get("count", 0)
    timer = timing.StageTimer()
    with timing.trace("off-1"):
        with timing.span("test.off", frames=3) as sp:
            sp.note(more=1)
            with timer.stage("fingerprint"):
                pass
        timing.record("test.off", t0, time.perf_counter())
        timing.count("test.off.count", 2)
    assert not sp.traced and sp.attrs == {"frames": 3}
    assert since(t0) == []
    summary = timing.TRACER.summary()
    assert summary["test.off"]["count"] == before + 2
    assert summary["test.off.count"]["count"] >= 2
    assert summary["test.off.count"]["total_s"] == 0.0
    assert "fingerprint" not in summary      # a stage stays in its timer


def test_stage_timer_summary_keeps_its_five_stages_and_shape():
    timer = timing.StageTimer()
    t0 = time.perf_counter()
    for name in STAGES + ["fingerprint"]:
        with timer.stage(name):
            pass
    out = timer.summary()
    assert list(out) == STAGES
    assert out["fingerprint"]["count"] == 2
    for row in out.values():
        assert list(row) == ["total_s", "count", "mean_s"]
        assert isinstance(row["count"], int) and row["total_s"] >= 0
    assert since(t0) == []                   # off: stages leave no record


def test_off_span_retains_nothing_per_call(no_device_calls):
    """With tracing off a span keeps nothing after it closes: 20,000 spans
    leave the memory allocated in the timing module unchanged."""
    timer = timing.StageTimer()

    def run(n):
        for _ in range(n):
            with timing.span("test.alloc"):
                with timer.stage("probe"):
                    pass

    run(100)
    tracemalloc.start()
    try:
        run(100)
        first = tracemalloc.take_snapshot()
        run(20_000)
        second = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, timing.__file__)]
    grown = sum(d.size_diff for d in second.filter_traces(only).compare_to(
        first.filter_traces(only), "filename"))
    assert grown <= 512, grown


def test_spans_under_the_profiler_record_parent_trace_and_attrs(tmp_path):
    t0 = time.perf_counter()

    def worker():
        with timing.trace("req-2"), timing.span("test.worker") as w:
            w.note(frames=7)

    with profiler() as prof:
        assert timing.tracing()
        with timing.trace("req-1"):
            with timing.span("test.outer", blocks=2) as outer:
                with timing.span("test.inner"):
                    th = threading.Thread(target=worker, name="test-worker")
                    th.start()
                    th.join(timeout=30)
                outer.note(bytes=64)
                timing.record("test.queue", t0, time.perf_counter(), "req-9")
    assert not th.is_alive()
    recs = by_name(since(t0))
    o, i = recs["test.outer"][0], recs["test.inner"][0]
    w, q = recs["test.worker"][0], recs["test.queue"][0]
    assert outer.traced and i.parent == o.id and o.parent is None
    assert (o.trace, i.trace, w.trace, q.trace) == ("req-1", "req-1", "req-2",
                                                    "req-9")
    assert q.parent == o.id and w.parent is None
    assert o.attrs == {"blocks": 2, "bytes": 64} and w.attrs == {"frames": 7}
    assert w.thread == "test-worker" and o.t0 <= i.t0 <= i.t1 <= o.t1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tids = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if str(e.get("name", "")).startswith("tvidz.test."):
            tids.setdefault(e["name"], set()).add(e.get("tid"))
    assert {"tvidz.test.outer", "tvidz.test.inner",
            "tvidz.test.worker"} <= set(tids)
    assert tids["tvidz.test.worker"].isdisjoint(tids["tvidz.test.outer"])


def test_event_time_reads_onto_the_host_clock():
    received, wall = 1000.0, 1_700_000_000.25
    event = {"eventTime": "2023-11-14T22:13:19.750Z"}   # wall - 0.5 s
    assert app_module._event_age_start(event, received, wall) == pytest.approx(
        999.5, abs=1e-6)
    for bad in ({}, {"eventTime": None}, {"eventTime": "yesterday"}):
        assert app_module._event_age_start(bad, received, wall) is None


def test_fake_s3_events_carry_event_time(tmp_path):
    sqs, s3 = fakes.FakeSQS(), fakes.FakeS3(str(tmp_path / "s3"))
    s3.configure_notification(sqs, "q")
    before = time.time()
    s3.put_object("b", "a b.y4m", b"x")
    rec = json.loads(sqs.receive(sqs.get_or_create_queue("q"))[0]["Body"])[
        "Records"][0]
    assert re.fullmatch(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{3}Z",
                        rec["eventTime"])
    t = app_module._event_age_start(rec, 0.0, time.time())
    assert -(time.time() - before) - 0.002 <= t <= 0.0
    assert rec["s3"]["object"]["key"] == "a+b.y4m"


# -- the service -----------------------------------------------------------


def _app(tmp_path):
    cfg = Config()
    cfg.pipeline.block_frames = 64
    cfg.pipeline.scene_height = 72
    cfg.pipeline.scene_width = 96
    cfg.pipeline.tmp_dir = str(tmp_path / "work")
    cfg.service.sse_poll_s = 0.02
    cfg.service.sqs_idle_sleep_s = 0.05
    (tmp_path / "work").mkdir()
    sqs, s3 = fakes.FakeSQS(), fakes.FakeS3(str(tmp_path / "s3"))
    sqs.create_queue(cfg.service.sqs_queue)
    s3.create_bucket(cfg.service.s3_bucket)
    s3.configure_notification(sqs, cfg.service.sqs_queue)
    inspector = create_app(
        config=cfg, store=Store("sqlite:///:memory:"),
        corpus=DeviceCorpus(device="cpu", fp_initial_capacity=1024,
                            fp_block_n=256),
        s3=s3, sqs=sqs, device="cpu")
    assert inspector.block_dispatcher is not None
    return inspector


def _upload(inspector, tmp_path, name, seed, cut_frames):
    """Put a 200-frame Y4M into the fake bucket and read its SSE stream to
    the verdict."""
    path = tmp_path / name
    write_synthetic_y4m(str(path), num_frames=200, height=72, width=96,
                        cut_frames=cut_frames, seed=seed)
    inspector.s3.put_file(inspector.config.service.s3_bucket, name, str(path))
    client = inspector.wsgi.test_client()
    for chunk in client.stream(f"/status/stream/{name}"):
        state = json.loads(chunk.decode()[len("data: "):])
        if state.get("status") in ("done", "error"):
            return state
    raise AssertionError(f"no verdict for {name}")


@pytest.fixture
def service(tmp_path):
    inspector = _app(tmp_path)
    inspector.start_poller()
    first = _upload(inspector, tmp_path, "first.y4m", 1, (50, 130))
    assert first["status"] == "done"
    yield inspector
    inspector.stop()


def test_one_upload_carries_its_trace_id_through_every_layer(service,
                                                             tmp_path):
    key = "1700000000000-second.y4m"
    t0 = time.perf_counter()
    with profiler():
        state = _upload(service, tmp_path, key, 2, (40,))
    assert state["status"] == "done" and set(state) == STATE_KEYS
    spans = by_name(since(t0, key))
    for name in ("queue.age", "upload", "analysis.admit", "analyze", "store",
                 "download", "probe", "decode.block", "decode.wait",
                 "fingerprint", "dispatch.submit", "dispatch.queue",
                 "dispatch.pass", "dispatch.pull", "fp-search", "corpus.lock",
                 "corpus.vid_copy", "corpus.k4", "corpus.pull",
                 "corpus.evidence", "progress", "finalize", "sse.deliver"):
        assert name in spans, name
    (upload,), (analyze,) = spans["upload"], spans["analyze"]
    assert analyze.parent == upload.id
    assert spans["analysis.admit"][0].parent == upload.id
    analysis_thread = upload.thread
    assert {r.thread for r in spans["decode.block"]} != {analysis_thread}
    assert sum(r.attrs.get("frames", 0) for r in spans["decode.block"]) == 200
    assert all(r.thread == "block-dispatcher" for r in spans["dispatch.pass"])
    assert all(key in r.attrs["traces"] for r in spans["dispatch.pass"])
    assert len(spans["dispatch.queue"]) == len(spans["dispatch.submit"]) == 4
    fp_ids = {r.id for r in spans["fp-search"]}
    for name in ("corpus.lock", "corpus.vid_copy", "corpus.k4", "corpus.pull",
                 "corpus.evidence"):
        assert {r.parent for r in spans[name]} <= fp_ids, name
    # The video table is taken by reference: no byte is copied.
    assert all(r.attrs["bytes"] == 0 for r in spans["corpus.vid_copy"])
    direct = [r for rs in spans.values() for r in rs if r.parent == analyze.id]
    assert {r.name for r in direct} >= {"fingerprint", "decode.wait",
                                        "fp-search", "finalize"}
    assert sum(r.seconds for r in direct) >= 0.9 * analyze.seconds
    (age,) = spans["queue.age"]
    assert age.t0 <= upload.t0 and age.seconds >= 0
    (deliver,) = spans["sse.deliver"]
    assert analyze.t0 < deliver.t0 <= deliver.t1 and deliver.seconds < 5


def test_search_request_nests_locate_and_its_pull(service):
    client = service.wsgi.test_client()
    body = {"queries": [{"filename": "first.y4m", "start_frame": 10,
                         "num_frames": 64}], "top_k": 3}
    t0 = time.perf_counter()
    with profiler():
        r = client.post("/search/fragments", json_body=body)
    assert r.status_code == 200
    assert r.get_json()["results"][0]["matches"] == []  # exclude_self
    recs = [x for x in since(t0) if x.trace and x.trace.startswith("search-")]
    spans = by_name(recs)
    (req,), (loc,), (pull,) = (spans["search.request"], spans["locate"],
                               spans["locate.pull"])
    assert req.parent is None and loc.parent == req.id and pull.parent == loc.id
    assert len({x.trace for x in recs}) == 1
    for name in ("search.read", "search.resolve"):
        assert spans[name][0].parent == req.id
    for name in ("corpus.lock", "locate.place", "locate.launch",
                 "locate.copy", "locate.rank"):
        assert spans[name][0].parent == loc.id
    assert "k3_device_s" not in loc.attrs       # no CUDA events on the CPU


def test_metrics_serve_spans_and_nothing_else_changes(service):
    client = service.wsgi.test_client()
    out = client.get("/metrics").get_json()
    assert set(out) == {"stage_timings", "analyses_in_memory",
                        "corpus_videos", "corpus_fingerprints", "ingestion",
                        "kernel_launches", "corpus_footprint",
                        "block_dispatcher", "spans"}
    stages = out["stage_timings"]
    assert {"download", "probe", "fingerprint"} <= set(stages) <= set(STAGES)
    for name in ("poller.receive", "poller.sleep", "queue.age", "upload",
                 "decode.block", "dispatch.pass", "sse.deliver", "sse.polls"):
        row = out["spans"][name]
        assert list(row) == ["total_s", "count", "mean_s"] and row["count"] > 0
    assert out["spans"]["sse.polls"]["total_s"] == 0.0
    assert set(client.get("/healthz").get_json()) == {
        "status", "version", "poller_alive", "corpus_videos",
        "corpus_fingerprints"}
    assert set(client.get("/status/first.y4m").get_json()) == STATE_KEYS


def test_poller_takes_a_record_without_event_time(service):
    """An S3 record without ``eventTime`` is dispatched as before and gives
    no ``queue.age`` span."""
    import os

    src = os.path.join(service.config.pipeline.tmp_dir, "..", "s3",
                       service.config.service.s3_bucket, "first.y4m")
    bucket = service.config.service.s3_bucket
    with open(src, "rb") as f:
        data = f.read()
    service.s3._notify_sqs, sqs = None, service.s3._notify_sqs
    service.s3.put_object(bucket, "plain.y4m", data)
    url = sqs.get_or_create_queue(service.config.service.sqs_queue)
    t0 = time.perf_counter()
    with profiler():
        sqs.send(url, json.dumps({"Records": [{"s3": {
            "bucket": {"name": bucket}, "object": {"key": "plain.y4m"}}}]}))
        client = service.wsgi.test_client()
        for chunk in client.stream("/status/stream/plain.y4m"):
            state = json.loads(chunk.decode()[len("data: "):])
            if state.get("status") in ("done", "error"):
                break
    assert state["status"] == "done" and state["duplicates"] == ["first.y4m"]
    spans = by_name(since(t0, "plain.y4m"))
    assert "upload" in spans and "queue.age" not in spans
