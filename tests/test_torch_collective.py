"""The op-log serving layer on the port (``tvidz_tpu_torch/parallel/
collective.py``), on a one-rank gloo group over ``[cpu] * 8``.

Mirrors, one for one, the reference's multi-host cases:
- ``tests/test_collective.py`` (12): the op log's ordering, the
  DeviceCorpus-shaped client, the spanning alignment index, growth,
  tombstones, pruning and churn;
- ``tests/test_collective_evict.py`` (4): the lag alarm, eviction, the
  fence, re-admission, ``/admin/evict-host`` and ``/metrics``;
- the multi-host cases of ``tests/test_review_r4.py`` (7);
- ``tests/test_cli.py::test_evict_host_cli``;
- ``tests/test_store_outage.py``'s two collective cases, with the real
  ``MultiHostCorpusClient`` failing its ``remove`` (its op-log append)
  where the reference uses a ``_FlakyCorpus`` stand-in.

The cross-process legs are tests/test_torch_multihost_dryrun.py and
tests/test_torch_multihost_served.py. (``tests/test_multihost.py``'s
``test_mh_dispatch_pallas_deterministic_fallback`` has no mirror: the
port has no Pallas->XLA fallback to test — a K3 failure is raised on every
rank.)
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from tvidz_tpu_torch.corpus.store import Store
from tvidz_tpu_torch.parallel import distributed as tdist
from tvidz_tpu_torch.parallel.collective import (
    CollectiveRunner,
    MultiHostCorpusClient,
)
from tvidz_tpu_torch.parallel.distributed import (
    MultiHostShardedCorpus,
    make_multihost_mesh,
)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module", autouse=True)
def group():
    """A one-rank gloo group: the runner's collectives run through it."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert tdist.init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu")
    yield
    dist.destroy_process_group()


def _mh(al_tcap=256):
    return MultiHostShardedCorpus(make_multihost_mesh(local_devices=CPU8),
                                  max_cuts=16, hamming_threshold=5,
                                  al_tcap=al_tcap)


def _runner(store, mh=None, **kw):
    args = dict(hamming_threshold=5, poll_s=0.01, ts_capacity=64,
                fp_capacity=2048)
    args.update(kw)
    return CollectiveRunner(store, mh or _mh(), **args)


def _client(runner):
    return MultiHostCorpusClient(runner, max_cuts=16, op_timeout_s=60)


@pytest.fixture
def stack():
    store = Store("sqlite:///:memory:")
    runner = _runner(store)
    client = _client(runner)
    runner.start()
    yield store, runner, client
    runner.stop()
    store.close()


# -- tests/test_collective.py ---------------------------------------------------------


def test_ingest_and_verdict_through_op_log(stack, rng):
    _store, runner, client = stack
    fps1 = rng.integers(0, 2**32, size=(50, 2), dtype=np.uint32)
    client.upsert_timestamps(1, [1.5, 3.25, 9.0])
    client.append_fingerprints(1, fps1)
    assert client.num_videos == 1
    assert client.num_fingerprints == 50

    # Timestamp verdict (exact membership) with exclusion.
    assert client.match_timestamps([1.5, 9.0], min_match=2) == [(1, 2)]
    assert client.match_timestamps([1.5, 9.0], min_match=2,
                                   exclude_video_id=1) == []

    # Fingerprint evidence: nearest-per-query-frame counts.
    hits = client.nearest_video_counts(fps1[10:20])
    assert hits == {1: 10}
    assert client.nearest_video_counts(fps1[10:20], exclude_video_id=1) == {}


def test_streamed_blocks_extend_alignment_row(stack, rng):
    _store, _runner, client = stack
    # Stream a video in 3 blocks; locate a fragment spanning block 2.
    blocks = [rng.integers(0, 2**32, size=(40, 2), dtype=np.uint32)
              for _ in range(3)]
    client.upsert_timestamps(7, [2.0])
    for b in blocks:
        client.append_fingerprints(7, b)
    frag = np.concatenate([blocks[1][30:], blocks[2][:10]])
    hits = client.locate_fragment(frag, top_k=3)
    assert hits and hits[0][0] == 7
    assert hits[0][1] == 70       # offset: 40 + 30
    assert hits[0][2] == frag.shape[0]

    # Batch variant agrees — one "fragments" op row for the whole batch.
    seq_before = _runner._applied_seq
    batch = client.locate_fragments([frag, blocks[0][:16]], top_k=2)
    assert batch[0][0][0] == 7
    assert batch[1][0][:2] == (7, 0)
    assert _runner._applied_seq == seq_before + 1

    # Edge: an empty query inside the batch yields [] for that slot
    # without disturbing its neighbors; exclusions apply per query.
    batch = client.locate_fragments(
        [frag, np.zeros((0, 2), np.uint32), blocks[0][:16]],
        top_k=2, exclude_video_ids=[None, None, 7])
    assert batch[0][0][0] == 7
    assert batch[1] == []
    assert batch[2] == []


def test_remove_video_tombstones_everywhere(stack, rng):
    _store, _runner, client = stack
    fps = rng.integers(0, 2**32, size=(30, 2), dtype=np.uint32)
    client.upsert_timestamps(3, [4.0, 8.0])
    client.append_fingerprints(3, fps)
    client.remove_video(3)
    assert client.match_timestamps([4.0, 8.0], min_match=2) == []
    assert client.nearest_video_counts(fps[:8]) == {}
    assert client.locate_fragment(fps[:16]) == []
    # Re-ingest under a new id: the same content must attribute to it
    # (distance-0 tombstones must not shadow).
    client.upsert_timestamps(4, [4.0, 8.0])
    client.append_fingerprints(4, fps)
    assert client.nearest_video_counts(fps[:8]) == {4: 8}


def test_reset_drops_content(stack, rng):
    _store, _runner, client = stack
    client.upsert_timestamps(1, [1.0, 2.0])
    client.append_fingerprints(
        1, rng.integers(0, 2**32, size=(20, 2), dtype=np.uint32))
    client.reset()
    assert client.num_videos == 0
    assert client.num_fingerprints == 0
    assert client.match_timestamps([1.0, 2.0], min_match=2) == []


def test_capacity_grows_online_past_warm(stack, rng):
    """An append past the warm capacity triggers the in-place growth
    (deterministic at the op's seq) instead of a cluster restart; existing
    evidence survives bit-exact."""
    _store, runner, client = stack
    fps0 = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint32)
    client.upsert_timestamps(1, [1.5, 3.0])
    client.append_fingerprints(1, fps0)
    before = client.match_timestamps([1.5, 3.0], min_match=2)
    cap_before = runner.corpus._inner.corpus_fp.shape[0]

    big = rng.integers(0, 2**32, size=(cap_before + 1, 2), dtype=np.uint32)
    client.upsert_timestamps(9, [7.0])
    client.append_fingerprints(9, big)
    cap_after = runner.corpus._inner.corpus_fp.shape[0]
    assert cap_after >= cap_before * 2
    # Pre-growth evidence is intact through the redistribution...
    assert client.match_timestamps([1.5, 3.0], min_match=2) == before
    assert client.nearest_video_counts(fps0[10:20]) == {1: 10}
    frag = client.locate_fragment(fps0[20:52], top_k=1)
    assert frag and frag[0][:2] == (1, 20)
    # ...and the growth-crossing video is fully searchable.
    assert client.nearest_video_counts(big[100:108]) == {9: 8}


def test_timestamp_and_alignment_rows_grow_online(stack, rng):
    _store, runner, client = stack
    inner = runner.corpus._inner
    ts_cap = inner.corpus_ts.shape[0]
    for vid in range(1, ts_cap + 2):   # one past the warm row capacity
        client.upsert_timestamps(vid, [0.5 * vid, 1.5 * vid])
    assert inner.corpus_ts.shape[0] >= ts_cap * 2
    # Every row still serves, including pre-growth ones and the grower.
    assert client.match_timestamps([0.5, 1.5], min_match=2) == [(1, 2)]
    last = ts_cap + 1
    assert client.match_timestamps(
        [0.5 * last, 1.5 * last], min_match=2) == [(last, 2)]


def test_warm_from_store_then_collective_append(rng):
    """A second runner warming from the store sees pre-existing rows AND
    rows appended through the log afterwards."""
    store = Store("sqlite:///:memory:")
    store.add_video("a.mp4")
    store.add_timestamps(1, [5.0, 6.0])
    fps = rng.integers(0, 2**32, size=(25, 2), dtype=np.uint32)
    store.add_fingerprints(1, fps)

    runner = _runner(store)
    client = _client(runner)
    runner.start()
    try:
        assert client.num_videos == 1
        assert client.match_timestamps([5.0, 6.0], min_match=2) == [(1, 2)]
        assert client.nearest_video_counts(fps[:5]) == {1: 5}
        assert client.locate_fragment(fps[10:20])[0][:2] == (1, 10)
        fps2 = rng.integers(0, 2**32, size=(30, 2), dtype=np.uint32)
        client.upsert_timestamps(2, [7.0, 8.0])
        client.append_fingerprints(2, fps2)
        assert client.match_timestamps([7.0, 8.0], min_match=2) == [(2, 2)]
        assert client.nearest_video_counts(fps2[:6]) == {2: 6}
    finally:
        runner.stop()
        store.close()


def test_warm_barrier_gates_submissions(rng):
    """The warm barrier runs after this rank's watermark and warm reads,
    and no op can be submitted until it passes."""
    store = Store("sqlite:///:memory:")
    store.add_video("pre.mp4")
    store.add_timestamps(1, [5.0])
    events = []

    runner = _runner(store, warm_barrier=lambda: events.append(
        ("barrier", runner._ready.is_set(), runner.num_videos)))
    client = _client(runner)

    # Before start(): submissions are refused outright.
    with pytest.raises(RuntimeError, match="not ready"):
        client.upsert_timestamps(2, [1.0])

    runner.start()
    try:
        # The barrier ran exactly once, after the warm read (the store's
        # pre-existing video is already mirrored) and before ready.
        assert events == [("barrier", False, 1)]
        client.upsert_timestamps(2, [7.0, 8.0])
        assert client.match_timestamps([7.0, 8.0], min_match=2) == [(2, 2)]
    finally:
        runner.stop()
        store.close()


def test_ops_apply_in_log_order(stack, rng):
    """Interleaved ops from multiple submitter threads serialize through
    the log; final state reflects every op exactly once."""
    _store, runner, client = stack
    payloads = {v: rng.integers(0, 2**32, size=(10, 2), dtype=np.uint32)
                for v in range(10, 18)}

    def ingest(vid):
        client.upsert_timestamps(vid, [float(vid), float(vid) + 0.5])
        client.append_fingerprints(vid, payloads[vid])

    threads = [threading.Thread(target=ingest, args=(v,)) for v in
               range(10, 18)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert client.num_videos == 8
    assert client.num_fingerprints == 80
    for v in range(10, 18):
        assert client.match_timestamps(
            [float(v), float(v) + 0.5], min_match=2) == [(v, 2)]


def test_remove_video_with_interleaved_appends(stack, rng):
    """A video ingested in several appends with another video's rows
    between them is removed IN FULL without touching the other's rows."""
    _store, _runner, client = stack
    a1 = rng.integers(0, 2**32, size=(16, 2), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(16, 2), dtype=np.uint32)
    a2 = rng.integers(0, 2**32, size=(16, 2), dtype=np.uint32)
    client.upsert_timestamps(1, [1.0])
    client.append_fingerprints(1, a1)
    client.upsert_timestamps(2, [2.0])
    client.append_fingerprints(2, b)      # lands BETWEEN video 1's blocks
    client.append_fingerprints(1, a2)
    client.remove_video(1)
    assert client.nearest_video_counts(b[:8]) == {2: 8}
    assert client.nearest_video_counts(a1[:8]) == {}
    assert client.nearest_video_counts(a2[:8]) == {}


def test_oplog_pruned_to_min_member_watermark(rng):
    """Applied op rows are reclaimed down to the minimum watermark of ALL
    members, the max-seq row is kept for restart snapshots, a silent
    lagging member is never outrun, and departed members' rows are cleared
    at cluster start."""
    store = Store("sqlite:///:memory:")
    runner = _runner(store, wm_interval_s=0.0, prune_interval_s=0.05)
    client = _client(runner)
    runner.start()
    try:
        store.set_collective_watermark("host-peer", 2, time.time())
        fps = rng.integers(0, 2**32, size=(40, 2), dtype=np.uint32)
        for vid in (1, 2, 3):
            # Durable store rows FIRST, then the collective op (the
            # analyzer's order): pruning applied rows loses nothing.
            rec = store.add_video(f"v{vid}.mp4")
            assert rec.id == vid
            store.add_timestamps(vid, [0.5 * vid, 2.0 * vid])
            store.add_fingerprints(vid, fps)
            client.upsert_timestamps(vid, [0.5 * vid, 2.0 * vid])
            client.append_fingerprints(vid, fps)
        n_ops = store.max_collective_seq()
        assert n_ops >= 6
        deadline = time.time() + 5
        while store.collective_op_count() > n_ops - 2:
            assert time.time() < deadline, store.collective_op_count()
            time.sleep(0.05)
        remaining = {s for s, _, _ in store.collective_ops_after(0)}
        assert remaining == set(range(3, n_ops + 1))
        assert runner.oplog_pruned_total == 2

        # The peer stays SILENT: the prune point stays pinned.
        time.sleep(0.5)
        assert store.collective_op_count() == n_ops - 2

        # The peer catches up -> all applied rows but the max-seq one go.
        store.set_collective_watermark("host-peer", n_ops, time.time())
        deadline = time.time() + 5
        while store.collective_op_count() > 1:
            assert time.time() < deadline, store.collective_op_count()
            time.sleep(0.05)
        assert {s for s, _, _ in store.collective_ops_after(0)} == {n_ops}
        assert client.match_timestamps([1.0, 4.0], min_match=2) == [(2, 2)]
    finally:
        runner.stop()

    # Cluster restart: ghost members cleared, watermark from the max-seq
    # row, the same verdicts warmed from the durable tables.
    mh2 = _mh()
    runner2 = _runner(store, mh2)
    client2 = _client(runner2)
    runner2.start()
    try:
        assert store.min_collective_watermark() == store.max_collective_seq()
        assert runner2._applied_seq == store.max_collective_seq()
        assert client2.match_timestamps([1.0, 4.0], min_match=2) == [(2, 2)]
        assert client2.num_videos == 3
        assert client2.num_fingerprints == mh2._fp_count
    finally:
        runner2.stop()
        store.close()


def test_multihost_churn_reclaims_capacity(rng):
    """Tombstoned timestamp/alignment slots are reused by the next claim,
    and a full fingerprint tail with tombstones is compacted instead of
    grown, with verdicts and fragment localization intact."""
    store = Store("sqlite:///:memory:")
    mh = _mh(al_tcap=64)
    runner = _runner(store, mh, ts_capacity=16, fp_capacity=256)
    client = _client(runner)
    runner.start()
    try:
        cap = mh._inner.corpus_fp.shape[0]
        per = 128
        n_fill = cap // per
        assert n_fill >= 2
        all_fps = {}
        for i in range(n_fill):
            vid = i + 1
            fps = rng.integers(0, 2**32, size=(per, 2), dtype=np.uint32)
            all_fps[vid] = fps
            client.upsert_timestamps(vid, [0.5 + vid, 2.0 + vid])
            client.append_fingerprints(vid, fps)
        assert mh._fp_count == cap          # tail full
        assert mh.fp_compactions == 0

        client.remove_video(1)
        ts_rows = mh._ts_rows
        al_rows = mh._al_rows

        new_fps = rng.integers(0, 2**32, size=(per, 2), dtype=np.uint32)
        client.upsert_timestamps(99, [7.5, 8.0])
        client.append_fingerprints(99, new_fps)
        assert mh.fp_compactions == 1
        assert mh._fp_count == cap          # full again, no dead rows
        assert mh._ts_rows == ts_rows       # tombstoned ts slot reused
        assert mh._al_rows == al_rows       # tombstoned al row reused

        vid2 = 2
        assert client.match_timestamps([0.5 + vid2, 2.0 + vid2],
                                       min_match=2) == [(vid2, 2)]
        assert client.match_timestamps([1.5, 3.0], min_match=2) == []
        assert client.nearest_video_counts(all_fps[vid2][10:18]) == {vid2: 8}
        assert client.nearest_video_counts(new_fps[:8]) == {99: 8}
        hits = client.locate_fragment(new_fps[20:52], top_k=2)
        assert hits and hits[0][:2] == (99, 20), hits
        assert all(h[0] != 1 for h in hits)
    finally:
        runner.stop()
        store.close()


# -- tests/test_collective_evict.py --------------------------------------------------


class _StubCorpus:
    """Stand-in corpus for a FAKE second member inside one process: it
    applies ops as no-ops — these tests assert only the runner's
    fencing/watermark mechanics."""

    _fp_count = 0
    _inner = type("I", (), {"corpus_ts": None, "corpus_fp": None,
                            "words": 2})()

    def refresh_from_store(self, store, **kw):
        pass

    def append_video(self, *a, **kw):
        pass

    def remove_video(self, *a, **kw):
        pass

    def match_timestamps(self, *a, **kw):
        return []


def _mk_runner(store, *, process_index=None, lag_alarm_ops=4,
               wm_interval_s=0.0, prune_interval_s=0.05):
    mh = _StubCorpus() if process_index is not None else _mh()
    runner = _runner(store, mh, wm_interval_s=wm_interval_s,
                     prune_interval_s=prune_interval_s,
                     lag_alarm_ops=lag_alarm_ops)
    if process_index is not None:
        runner.process_index = process_index
    return runner


def test_stalled_member_alarm_then_eviction_unpins_pruning(rng):
    store = Store("sqlite:///:memory:")
    runner = _mk_runner(store, lag_alarm_ops=4)
    client = _client(runner)
    runner.start()
    try:
        store.set_collective_watermark("host-peer", 1, time.time())
        fps = rng.integers(0, 2**32, size=(40, 2), dtype=np.uint32)
        for vid in range(1, 6):
            client.upsert_timestamps(vid, [0.5 * vid, 2.0 * vid])
            client.append_fingerprints(vid, fps)
        n_ops = store.max_collective_seq()
        assert n_ops >= 10

        # Pruning is pinned at the stalled peer's watermark...
        time.sleep(0.3)
        assert store.collective_op_count() >= n_ops - 1
        # ...and the operator alarm fires (lag > lag_alarm_ops).
        st = runner.oplog_status()
        assert st["lag_alarm"] is True
        assert st["min_watermark"] == 1
        assert st["members"]["host-peer"]["seq"] == 1

        store.evict_collective_member("host-peer")
        deadline = time.time() + 5
        while store.collective_op_count() > 1:
            assert time.time() < deadline, store.collective_op_count()
            time.sleep(0.05)
        st = runner.oplog_status()
        assert st["lag_alarm"] is False
        assert st["members"]["host-peer"]["evicted"] is True

        # No divergence on the surviving member: every verdict still serves.
        assert client.match_timestamps([0.5, 2.0], min_match=2) == [(1, 2)]
        assert client.nearest_video_counts(fps[:8]) == {5: 8} or \
            client.nearest_video_counts(fps[:8])  # all vids share fps rows
    finally:
        runner.stop()
        store.close()


def test_evicted_member_fences_itself(rng):
    """The evicted member discovers the sentinel at its next hygiene pass
    and refuses to serve; the healthy member keeps serving."""
    store = Store("sqlite:///:memory:")
    r0 = _mk_runner(store)                      # host-0 (serving)
    r0.start()
    r1 = _mk_runner(store, process_index=1)     # host-1 (to be evicted)
    r1.start()
    c0 = _client(r0)
    c1 = _client(r1)
    try:
        c0.upsert_timestamps(3, [1.0, 2.0])
        assert c0.match_timestamps([1.0, 2.0], min_match=2) == [(3, 2)]
        deadline = time.time() + 5
        while r1._applied_seq < r0._applied_seq:
            assert time.time() < deadline
            time.sleep(0.02)

        store.evict_collective_member("host-1")
        deadline = time.time() + 5
        while not r1.evicted.is_set():
            assert time.time() < deadline, "member never fenced"
            time.sleep(0.02)
        with pytest.raises(RuntimeError):
            c1.match_timestamps([1.0, 2.0], min_match=2)
        assert c0.match_timestamps([1.0, 2.0], min_match=2) == [(3, 2)]
        deadline = time.time() + 5
        while store.min_collective_watermark() != r0._applied_seq:
            assert time.time() < deadline, (
                store.min_collective_watermark(), r0._applied_seq)
            time.sleep(0.02)
        # The sentinel row is never resurrected by a late heartbeat.
        store.set_collective_watermark("host-1", 99, time.time())
        assert store.collective_watermark("host-1") < 0
    finally:
        r1.stop()
        r0.stop()
        store.close()


def test_cluster_restart_readmits_evicted_member(rng):
    store = Store("sqlite:///:memory:")
    r0 = _mk_runner(store)
    r0.start()
    c0 = _client(r0)
    store.add_video("a.mp4")
    store.add_timestamps(1, [1.0, 2.0])
    c0.upsert_timestamps(1, [1.0, 2.0])
    store.evict_collective_member("host-0")
    deadline = time.time() + 5
    while not r0.evicted.is_set():
        assert time.time() < deadline
        time.sleep(0.02)
    r0.stop()

    r0b = _mk_runner(store)
    r0b.start()
    c0b = _client(r0b)
    try:
        assert store.collective_watermark("host-0") >= 0
        assert not r0b.evicted.is_set()
        assert c0b.match_timestamps([1.0, 2.0], min_match=2) == [(1, 2)]
    finally:
        r0b.stop()
        store.close()


def test_admin_evict_route(tmp_path):
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
    from tvidz_tpu_torch.service.app import create_app
    from tvidz_tpu_torch.service.fakes import FakeS3, FakeSQS

    cfg = Config()
    store = Store("sqlite:///:memory:")
    s3 = FakeS3(str(tmp_path / "s3"))
    sqs = FakeSQS()
    sqs.create_queue(cfg.service.sqs_queue)
    s3.create_bucket(cfg.service.s3_bucket)
    app = create_app(config=cfg, store=store,
                     corpus=DeviceCorpus(ts_initial_capacity=8,
                                         fp_initial_capacity=1024,
                                         fp_block_n=256, device="cpu"),
                     s3=s3, sqs=sqs, device="cpu")
    try:
        client = app.wsgi.test_client()
        # Single-host deployment: the route answers 400.
        r = client.post("/admin/evict-host", json_body={"host": "host-1"})
        assert r.status_code == 400
        assert "collective_oplog" not in client.get("/metrics").get_json()

        runner = _mk_runner(store)
        runner.start()
        app.collective_runner = runner
        try:
            r = client.post("/admin/evict-host", json_body={})
            assert r.status_code == 400
            r = client.post("/admin/evict-host",
                            json_body={"host": "host-0"})
            assert r.status_code == 400          # cannot self-evict
            r = client.post("/admin/evict-host",
                            json_body={"host": "host-3"})
            assert r.status_code == 400
            assert "host-0" in r.get_json()["members"]
            store.set_collective_watermark("host-3", 0, time.time())
            r = client.post("/admin/evict-host",
                            json_body={"host": "host-3"})
            assert r.status_code == 200
            body = r.get_json()
            assert body["status"] == "evicted"
            assert store.collective_watermark("host-3") < 0
            assert body["oplog"]["members"]["host-3"]["evicted"] is True
            m = client.get("/metrics").get_json()
            assert "lag_alarm" in m["collective_oplog"]
        finally:
            runner.stop()
    finally:
        app.stop()
        store.close()


# -- the multi-host cases of tests/test_review_r4.py ---------------------------------


def test_evict_unknown_member_rejected(tmp_path):
    from tvidz_tpu_torch.cli import main

    db = str(tmp_path / "shared.db")
    store = Store(f"sqlite:///{db}")
    store.set_collective_watermark("host-0", 7, time.time())
    with pytest.raises(KeyError):
        store.evict_collective_member("host-3")
    # No sentinel row was minted for the typo.
    assert store.collective_watermark("host-3") is None
    store.evict_collective_member("host-0")
    assert store.collective_watermark("host-0") < 0
    store.close()
    assert main(["evict-host", "host-9", "--db", f"sqlite:///{db}"]) == 2


def test_empty_ts_upsert_clears_row_multihost(stack):
    """A zero-cut re-analysis OVERWRITES the video's row to length 0
    (DeviceCorpus.upsert_timestamps parity)."""
    _store, runner, client = stack
    client.upsert_timestamps(1, [1.5, 3.25, 9.0])
    assert client.match_timestamps([1.5, 9.0], min_match=2) == [(1, 2)]
    client.upsert_timestamps(1, [])          # re-analysis: zero cuts
    assert client.match_timestamps([1.5, 9.0], min_match=2) == []
    assert client.num_videos == 1
    assert runner.corpus._ts_rows == 1


def test_mh_search_fingerprints_devicecorpus_parity(stack, rng):
    """MultiHostCorpusClient.search_fingerprints gives DeviceCorpus's
    answer: CORPUS-frame evidence, the same default min_match."""
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus

    fps_a = rng.integers(0, 2**32, size=(40, 2), dtype=np.uint32)
    fps_b = rng.integers(0, 2**32, size=(24, 2), dtype=np.uint32)
    q = fps_a[5:13]

    dc = DeviceCorpus(ts_initial_capacity=8, fp_initial_capacity=1024,
                      fp_block_n=256, hamming_threshold=5, device="cpu")
    dc.append_fingerprints(1, fps_a)
    dc.append_fingerprints(2, fps_b)
    expect = dc.search_fingerprints(q, min_match=2)
    expect_excl = dc.search_fingerprints(q, min_match=2, exclude_video_id=1)

    _store, _runner, client = stack
    client.append_fingerprints(1, fps_a)
    client.append_fingerprints(2, fps_b)
    assert client.search_fingerprints(q, min_match=2) == expect
    assert client.search_fingerprints(
        q, min_match=2, exclude_video_id=1) == expect_excl
    assert client.search_fingerprints(q) == dc.search_fingerprints(q)


def test_search_fingerprints_skips_tombstones(stack, rng):
    """A removed video's rows never surface from fingerprint evidence, on
    the spanning corpus as on one card, even for a dense query hash."""
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus

    a = rng.integers(0, 2**32, size=(16, 2), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(16, 2), dtype=np.uint32)
    dense = np.full((8, 2), 0xFFFFFFFF, np.uint32)
    c = DeviceCorpus(ts_initial_capacity=8, fp_initial_capacity=1024,
                     fp_block_n=256, hamming_threshold=10, device="cpu")
    _store, _runner, client = stack
    for corpus in (c, client):
        corpus.append_fingerprints(1, a)
        corpus.append_fingerprints(2, b)
        corpus.remove_video(2)
        hits = corpus.search_fingerprints(dense, min_match=1)
        assert all(v >= 0 for v, _ in hits), hits
        assert all(v != 2 for v, _ in corpus.search_fingerprints(b, min_match=1))


def test_deterministic_op_error_keeps_serving(stack):
    """A data error raises identically on every rank: the op is consumed,
    the submitter sees it, the runner keeps serving."""
    _store, runner, client = stack
    fut = runner.submit("no-such-kind", {})
    with pytest.raises(ValueError):
        fut.wait(30)
    assert not runner.evicted.is_set()
    client.upsert_timestamps(1, [1.5, 3.25])
    assert client.match_timestamps([1.5, 3.25], min_match=2) == [(1, 2)]


def test_query_retries_transient_local_failure(stack):
    """Single-process clusters retry rank-local failures of PURE QUERY ops:
    a two-shot device blip resolves on the third attempt with no fence."""
    _store, runner, client = stack
    client.upsert_timestamps(1, [1.5, 3.25])
    orig = runner.corpus.match_timestamps
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("transient device blip")
        return orig(*a, **k)

    runner.corpus.match_timestamps = flaky
    assert client.match_timestamps([1.5, 3.25], min_match=2) == [(1, 2)]
    assert calls["n"] == 3
    assert not runner.evicted.is_set()


def test_mutating_op_local_failure_fences(stack):
    """A rank-local failure applying a MUTATING op may be a partial apply:
    the rank fences itself rather than diverge."""
    _store, runner, client = stack

    def boom(*a, **k):
        raise RuntimeError("device memory exhausted mid-append")

    runner.corpus.append_video = boom
    with pytest.raises(RuntimeError):
        client.upsert_timestamps(1, [1.5])
    assert runner.evicted.is_set()
    assert "host-locally" in (runner.fence_reason or "")
    assert runner.oplog_status()["fence_reason"]
    with pytest.raises(RuntimeError):
        client.match_timestamps([1.5], min_match=1)


# -- tests/test_cli.py::test_evict_host_cli ------------------------------------------


def test_evict_host_cli(tmp_path, capsys):
    """Store-level operator eviction: writes the EVICTED sentinel without
    needing a reachable serving member, and needs no device."""
    from tvidz_tpu_torch.cli import main

    db = str(tmp_path / "shared.db")
    store = Store(f"sqlite:///{db}")
    store.set_collective_watermark("host-0", 7, time.time())
    store.set_collective_watermark("host-2", 3, time.time())
    store.close()

    rc = main(["evict-host", "host-2", "--db", f"sqlite:///{db}"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "evicted"
    assert out["min_live_watermark"] == 7      # host-2 no longer pins
    members = {m["host"]: m for m in out["members"]}
    assert members["host-2"]["evicted"] is True
    assert members["host-0"]["evicted"] is False

    # A malformed member id is rejected before touching the store.
    rc = main(["evict-host", "not-a-host", "--db", f"sqlite:///{db}"])
    assert rc == 2


# -- tests/test_store_outage.py's collective cases -----------------------------------


class _RemoveOpDown:
    """The runner's store with its op log down for ``remove`` ops (a
    budget of failures, None = forever): the real client's remove_video is
    an op-log append, which fails as the reference's _FlakyCorpus does."""

    def __init__(self, inner, budget=None):
        self._inner = inner
        self.budget = budget
        self.remove_attempts = 0

    def append_collective_op(self, kind, meta):
        if kind == "remove":
            self.remove_attempts += 1
            if self.budget is None or self.budget > 0:
                if self.budget is not None:
                    self.budget -= 1
                raise ConnectionError("collective op log unavailable")
        return self._inner.append_collective_op(kind, meta)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.fixture
def outage_env(tmp_path):
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.pipeline.analyzer import Analyzer
    from tvidz_tpu_torch.pipeline.progress import AnalysisRegistry

    cfg = Config()
    cfg.pipeline.block_frames = 32
    cfg.pipeline.scene_height = 72
    cfg.pipeline.scene_width = 96
    cfg.pipeline.tmp_dir = str(tmp_path / "work")
    cfg.pipeline.decode_prefetch_blocks = 0
    cfg.pipeline.store_retry_attempts = 4
    cfg.pipeline.store_retry_wait_s = 0.01
    os.makedirs(cfg.pipeline.tmp_dir)
    bucket = tmp_path / "bucket"
    os.makedirs(bucket)
    write_synthetic_y4m(str(bucket / "orig.y4m"), num_frames=128, height=72,
                        width=96, cut_frames=(40, 90), seed=11)
    shutil.copy(bucket / "orig.y4m", bucket / "copy.y4m")
    runners = []

    def fetcher(b, k, lp):
        shutil.copy(bucket / k, lp)

    def mk(store, runner_store):
        """An analyzer whose corpus is a MultiHostCorpusClient over a
        runner on ``runner_store``."""
        runner = _runner(runner_store)
        runner.start()
        runners.append(runner)
        return Analyzer(store, _client(runner), AnalysisRegistry(), fetcher, cfg)

    yield mk
    for r in runners:
        r.stop()


def test_collective_remove_failure_keeps_finalization_retry_path(outage_env):
    """The device-side removal inside the finalization-outage handler is a
    collective op: its own failure against the down store must not destroy
    the recovery (verdict recorded, TransientAnalysisError re-raised)."""
    from tvidz_tpu_torch.pipeline.analyzer import (
        AnalysisRetryContext,
        TransientAnalysisError,
    )
    from tests.test_store_outage import FlakyStore

    base = Store("sqlite:///:memory:")
    store = FlakyStore(base, fail_methods={"add_fingerprints"})  # down forever
    log_down = _RemoveOpDown(base)
    analyzer = outage_env(store, log_down)
    with pytest.raises(TransientAnalysisError) as ei:
        analyzer.analyze("videos", "orig.y4m",
                         retry_ctx=AnalysisRetryContext(more_attempts=True))
    assert log_down.remove_attempts == 1         # attempted, failed, deferred
    states = analyzer.registry.snapshot()
    assert any(s.get("status") == "retrying" for s in states.values()), states
    assert ei.value.video_id is not None


def test_supersede_remove_failure_surfaces_transient(outage_env):
    """A retry attempt whose supersede removal fails (a collective remove
    against a still-down op log) surfaces ANOTHER transient attempt with
    this attempt's landed row in tow."""
    from tvidz_tpu_torch.pipeline.analyzer import (
        AnalysisRetryContext,
        TransientAnalysisError,
    )

    store = Store("sqlite:///:memory:")
    log_down = _RemoveOpDown(store, budget=0)
    analyzer = outage_env(store, log_down)
    r1 = analyzer.analyze("videos", "orig.y4m")
    assert r1.status == "done"
    orphan = store.add_video("copy.y4m")

    log_down.budget, log_down.remove_attempts = 1, 0
    with pytest.raises(TransientAnalysisError) as ei:
        analyzer.analyze(
            "videos", "copy.y4m",
            retry_ctx=AnalysisRetryContext(
                more_attempts=True, supersede_vids=[orphan.id]))
    assert log_down.remove_attempts == 1
    assert ei.value.video_id is not None
    assert ei.value.video_id not in (r1.video_id, orphan.id)
    # Recovered op log: the next attempt (old rows + this one) succeeds
    # and names the original.
    r2 = analyzer.analyze(
        "videos", "copy.y4m",
        retry_ctx=AnalysisRetryContext(
            more_attempts=False,
            supersede_vids=[orphan.id, ei.value.video_id]))
    assert r2.status == "done"
    assert r2.duplicates == ["orig.y4m"]
