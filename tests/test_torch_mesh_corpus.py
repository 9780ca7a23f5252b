"""Port parity: MeshCorpus, interface-identical to DeviceCorpus.

Mirrors tests/test_mesh_corpus.py. The same updates and queries go through
the JAX MeshCorpus on the 8-device virtual CPU mesh, the port's MeshCorpus
on ``make_mesh(devices=[cpu] * 8)`` = (data 2, corpus 4) and the port's
single-card DeviceCorpus; every answer (exact integers, ties across shard
edges included) and the sync accounting must agree. Then the analyzer and
the service's route suite run on a port MeshCorpus.
"""

import inspect
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tvidz_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tvidz_tpu.parallel.mesh_corpus import MeshCorpus as JaxMeshCorpus
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.parallel.mesh import make_mesh
from tvidz_tpu_torch.parallel.mesh_corpus import MeshCorpus
from tvidz_tpu_torch.parallel.sharded_search import Sharded

KW = dict(ts_initial_capacity=8, fp_initial_capacity=256, fp_block_n=128)


@pytest.fixture(scope="module")
def meshes():
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jax_make_mesh(8), make_mesh(devices=[torch.device("cpu")] * 8)


def _three(meshes, **kw):
    """(JAX MeshCorpus, port MeshCorpus, port DeviceCorpus), same settings."""
    jm, tm = meshes
    kw = {**KW, **kw}
    return (JaxMeshCorpus(jm, **kw), MeshCorpus(tm, **kw),
            DeviceCorpus(device="cpu", **kw))


def _same(corpora, call):
    answers = [call(c) for c in corpora]
    assert all(a == answers[0] for a in answers[1:]), answers
    return answers[0]


def test_match_timestamps_parity_with_device_corpus(meshes, rng):
    corpora = _three(meshes)
    for vid in range(12):
        ts = sorted(rng.uniform(0, 100, size=rng.integers(2, 10)).round(1).tolist())
        for c in corpora:
            c.upsert_timestamps(vid, ts)
    query = corpora[2]._ts[3, :4].tolist() + [999.0]
    for c in corpora:
        c.upsert_timestamps(40, query[:3])      # a copy in another shard
    assert _same(corpora, lambda c: c.match_timestamps(query, min_match=2))
    _same(corpora, lambda c: c.match_timestamps(query, min_match=2,
                                                exclude_video_id=3))


def test_search_fingerprints_parity(meshes, rng):
    corpora = _three(meshes, hamming_threshold=5)
    for vid in (1, 2, 3):
        fp = rng.integers(0, 2**32, size=(40, 2), dtype=np.uint32)
        for c in corpora:
            c.append_fingerprints(vid, fp)
    q = corpora[2]._fp[50:60].copy()  # frames of video 2
    assert _same(corpora, lambda c: c.search_fingerprints(q, min_match=2))[0][0] == 2
    _same(corpora, lambda c: c.search_fingerprints(q[:3], min_match=1,
                                                   exclude_video_id=2))


def test_nearest_video_counts_ties_across_shard_edges(meshes, rng):
    """Exact copies of query frames on both sides of each shard edge (128
    rows a shard at capacity 512): the nearest row is the lower one, as on
    one card, so the video holding it gets the evidence."""
    corpora = _three(meshes, hamming_threshold=6)
    q = rng.integers(0, 2**32, size=(12, 2), dtype=np.uint32)
    fp = rng.integers(0, 2**32, size=(500, 2), dtype=np.uint32)
    for j, edge in enumerate((128, 256, 384)):
        fp[edge - 1] = fp[edge] = q[j]
        fp[edge - 3] = fp[edge + 2] = q[3 + j] ^ np.uint32(1)
    for vid, (s, e) in enumerate(((0, 127), (127, 255), (255, 300), (300, 500))):
        for c in corpora:
            c.append_fingerprints(vid + 1, fp[s:e])
    counts = _same(corpora, lambda c: c.nearest_video_counts(q))
    # q0: rows 127 (video 2) | 128; q3: 125 (1) | 130; q1: 255 (3) | 256;
    # q4: 253 (2) | 258; q2: 383 (4) | 384; q5: 381 (4) | 386.
    assert counts == {1: 1, 2: 2, 3: 1, 4: 2}
    _same(corpora, lambda c: c.nearest_video_counts(q, exclude_video_id=2))
    assert corpora[1]._fp_cap == 512 and corpora[1].n_shards == 4


def test_growth_preserves_shard_divisibility(meshes, rng):
    _, tm = meshes
    mc = MeshCorpus(tm, **KW)
    for vid in range(40):  # force ts growth past 8 -> 16 -> 32 -> 64
        mc.upsert_timestamps(vid, [float(vid), vid + 0.5])
    assert mc._ts_cap % mc.n_shards == 0
    fp = rng.integers(0, 2**32, size=(2000, 2), dtype=np.uint32)
    mc.append_fingerprints(99, fp)  # force fp growth
    assert mc._fp_cap % mc.n_shards == 0
    assert mc.match_timestamps([7.0, 7.5], min_match=2) == [(7, 2)]
    hits = mc.search_fingerprints(fp[100:108], min_match=2)
    assert hits and hits[0][0] == 99
    assert isinstance(mc._fp_dev, Sharded) and mc._fp_dev.block_rows == mc._fp_cap // 4


def test_full_pipeline_on_mesh_corpus(meshes, tmp_path):
    """The port's analyzer E2E with a sharded corpus — upload + duplicate
    verdict, and the same cuts the single-card corpus gives."""
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.corpus.store import Store
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.pipeline.analyzer import Analyzer
    from tvidz_tpu_torch.pipeline.progress import AnalysisRegistry

    cfg = Config()
    cfg.pipeline.block_frames = 64
    cfg.pipeline.scene_height = 72
    cfg.pipeline.scene_width = 96
    cfg.pipeline.tmp_dir = str(tmp_path / "work")
    os.makedirs(cfg.pipeline.tmp_dir)
    bucket = tmp_path / "bucket"
    os.makedirs(bucket)

    def fetcher(b, k, lp):
        shutil.copy(bucket / k, lp)

    write_synthetic_y4m(str(bucket / "m.y4m"), num_frames=200, height=72,
                        width=96, cut_frames=(50, 130), seed=3)
    shutil.copy(bucket / "m.y4m", bucket / "42-m.y4m")
    results = []
    for corpus in (MeshCorpus(meshes[1], **KW), DeviceCorpus(device="cpu", **KW)):
        analyzer = Analyzer(Store("sqlite:///:memory:"), corpus,
                            AnalysisRegistry(), fetcher, cfg)
        r1 = analyzer.analyze("videos", "m.y4m")
        r2 = analyzer.analyze("videos", "42-m.y4m")
        results.append((r1.status, r1.duplicates, r1.scene_cuts,
                        r2.status, r2.duplicates, r2.scene_cuts))
    assert results[0] == results[1]
    assert results[0][:2] == ("done", []) and results[0][3:5] == ("done", ["m.y4m"])


def test_incremental_sync_transfer_is_bounded(meshes, rng):
    """After the first placement, a dirty row or an appended block crosses
    host->device once per dirty shard (the data-axis replicas get a
    device-to-device copy): the same bytes the JAX MeshCorpus counts."""
    kw = dict(ts_initial_capacity=64, fp_initial_capacity=8192, fp_block_n=128,
              hamming_threshold=5)
    jc, tc, _ = _three(meshes, **kw)
    n_shards = tc.n_shards
    for vid in range(16):
        fp = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint32)
        for c in (jc, tc):
            c.upsert_timestamps(vid, [float(vid), float(vid) + 1])
            c.append_fingerprints(vid, fp)
    assert _same((jc, tc), lambda c: c.match_timestamps([3.0, 4.0], min_match=2)) == [(3, 2)]
    _same((jc, tc), lambda c: c.nearest_video_counts(c._fp[:8].copy()))
    assert tc.sync_bytes_transferred == jc.sync_bytes_transferred

    base = tc.sync_bytes_transferred
    for c in (jc, tc):
        c.upsert_timestamps(3, [100.0, 101.0])
    _same((jc, tc), lambda c: c.match_timestamps([100.0, 101.0], min_match=2))
    delta = tc.sync_bytes_transferred - base
    assert delta <= (tc._ts_cap // n_shards) * (tc.max_cuts * 4 + 4)
    assert delta < tc._ts.nbytes

    base = tc.sync_bytes_transferred
    extra = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint32)
    for c in (jc, tc):
        c.append_fingerprints(99, extra)
    counts = _same((jc, tc), lambda c: c.nearest_video_counts(
        c._fp[c._fp_count - 8: c._fp_count].copy()))
    assert counts.get(99, 0) == 8          # new rows ARE visible
    delta = tc.sync_bytes_transferred - base
    assert 0 < delta <= 2 * (tc._fp_cap // n_shards) * tc.words * 4
    assert delta < tc._fp.nbytes
    assert tc.sync_bytes == jc.sync_bytes
    assert tc.sync_bytes_transferred == jc.sync_bytes_transferred


def test_locate_fragment_parity_and_sharded_sync(meshes, rng):
    """Fragment search runs sharded (the alignment index row-sharded over
    the corpus axis): results equal DeviceCorpus's and the JAX
    MeshCorpus's, and a dirty-row sync re-uploads only the touched shard."""
    corpora = _three(meshes, hamming_threshold=5)
    seqs = {}
    for vid in range(1, 7):
        seqs[vid] = rng.integers(1, 2**32 - 1, size=(96, 2), dtype=np.uint32)
        for c in corpora:
            c.append_fingerprints(vid, seqs[vid])
    frag = seqs[4][30:80]
    got = _same(corpora, lambda c: c.locate_fragment(frag, top_k=3))
    assert got[0] == (4, 30, 50)
    tc = corpora[1]
    bu = tc._al_buckets[0]                 # 96-frame rows: bucket 0
    assert isinstance(bu.dev, Sharded) and bu.dev.axis == "corpus"
    assert bu.vcap % tc.n_shards == 0

    before = tc.sync_bytes_transferred
    for c in corpora:
        c.append_fingerprints(2, seqs[2][:8])
    _same(corpora, lambda c: c.locate_fragment(frag, top_k=1))
    delta = tc.sync_bytes_transferred - before
    rows_per_shard = bu.vcap // tc.n_shards
    assert 0 < delta <= rows_per_shard * (bu.tcap * tc.words * 4 + 4), delta
    assert delta < bu.buf.nbytes
    assert tc.sync_bytes["al"] == corpora[0].sync_bytes["al"]


def test_locate_fragments_batch_2d_parallel(meshes, rng):
    """One 2-D dispatch per bucket (queries over data x videos over corpus)
    equals per-query locate_fragment, the JAX MeshCorpus and the
    DeviceCorpus — with mixed-length buckets, per-query exclusions, an
    empty query and a query count that doesn't divide the data axis."""
    corpora = _three(meshes, hamming_threshold=5)
    seqs = {}
    for vid in range(1, 6):
        seqs[vid] = rng.integers(1, 2**32 - 1, size=(96, 2), dtype=np.uint32)
    seqs[9] = rng.integers(1, 2**32 - 1, size=(700, 2), dtype=np.uint32)
    for vid, s in seqs.items():
        for c in corpora:
            c.append_fingerprints(vid, s)        # 9 lands in a larger bucket

    queries = [seqs[2][10:60], seqs[9][300:420], seqs[4][5:40]]
    excl = [None, None, 4]
    batch = _same(corpora, lambda c: c.locate_fragments(
        queries, top_k=3, exclude_video_ids=excl))
    tc = corpora[1]
    assert batch == [tc.locate_fragment(q, top_k=3, exclude_video_id=e)
                     for q, e in zip(queries, excl)]
    assert batch[0][0] == (2, 10, 50)
    assert batch[1][0] == (9, 300, 120)
    assert all(h[0] != 4 for h in batch[2])
    empty = np.zeros((0, 2), np.uint32)
    assert tc.locate_fragments([empty, queries[0]], top_k=3)[0] == []


def test_ts_row_reuse_syncs_correctly_across_shards(meshes):
    """A reused (tombstoned) timestamp row reaches its owning shard through
    the dirty-shard sync and serves queries correctly."""
    corpora = _three(meshes)[1:]
    for cycle in range(20):
        vid = 3000 + cycle
        for c in corpora:
            c.upsert_timestamps(vid, [float(cycle), float(cycle) + 0.25])
        assert _same(corpora, lambda c: c.match_timestamps(
            [float(cycle), float(cycle) + 0.25], min_match=2)) == [(vid, 2)]
        for c in corpora:
            c.remove_video(vid)
        assert _same(corpora, lambda c: c.match_timestamps(
            [float(cycle), float(cycle) + 0.25], min_match=2)) == []
    fp = corpora[0].device_footprint
    assert fp["ts_capacity_rows"] == 8          # never grew
    assert fp["ts_rows"] <= 2 and fp["ts_free_rows"] >= 1
    corpora[0].upsert_timestamps(4001, [100.0, 200.0])
    assert corpora[0].num_videos == 1
    assert corpora[0].match_timestamps([100.0, 200.0], min_match=2) == [(4001, 2)]


def test_service_route_suite_on_mesh_corpus(meshes, tmp_path):
    """Every route test of tests/test_torch_service.py that takes its app,
    on an app whose corpus is a port MeshCorpus."""
    from tests import test_torch_service as svc

    ran = []
    for name in sorted(n for n in dir(svc) if n.startswith("test_")):
        fn = getattr(svc, name)
        params = inspect.signature(fn).parameters
        if not {"app", "client"} & set(params):
            continue
        work = tmp_path / name
        work.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            app = svc.make_app(work, mp, MeshCorpus(
                meshes[1], ts_initial_capacity=8, fp_initial_capacity=1024,
                fp_block_n=256))
            try:
                args = {"app": app, "client": app.wsgi.test_client(),
                        "tmp_path": work, "monkeypatch": mp}
                fn(**{k: args[k] for k in params})
            finally:
                app.stop()
        ran.append(name)
    assert len(ran) == 22, ran
