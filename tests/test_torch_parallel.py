"""Port parity: the mesh, the sharded searches and the multi-card step.

Mirrors tests/test_parallel.py. The same numpy-seeded inputs go through the
JAX function on the 8-device virtual CPU mesh (the Pallas kernels in
interpret mode where tests/test_parallel.py runs them) and through the port
on ``make_mesh(devices=[cpu] * 8)`` = (data 2, corpus 4), where every
shard runs the kernels' plain versions. Integers (counts, minima, argmins,
offsets, scores of fragments, top-k) are exact, first-index ties across
shard edges included; scene scores within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.ops import golden
from tvidz_tpu.parallel import mesh as jmesh
from tvidz_tpu.parallel import sharded_search as jss
from tvidz_tpu.parallel import step as jstep
from tvidz_tpu_torch.parallel import mesh as tmesh
from tvidz_tpu_torch.parallel import sharded_search as tss
from tvidz_tpu_torch.parallel import step as tstep

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jmesh.make_mesh(8), tmesh.make_mesh(devices=CPU8)


def _i32(a):
    """uint32 numpy rows -> the port's int32 bit-view tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_for(n):
    assert tmesh.mesh_shape_for(n) == jmesh.mesh_shape_for(n)


def test_make_mesh_layout(monkeypatch):
    m = tmesh.make_mesh(devices=CPU8)
    assert m.shape == {"data": 2, "corpus": 4} and m.home == torch.device("cpu")
    assert m.distinct_devices == [torch.device("cpu")]
    m = tmesh.make_mesh(4, data_size=2, corpus_size=2, devices=CPU8)
    assert m.shape == {"data": 2, "corpus": 2}
    with pytest.raises(ValueError):
        tmesh.make_mesh(8, data_size=3, corpus_size=2, devices=CPU8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tmesh.make_mesh()


def test_make_mesh_honours_the_device_choice(monkeypatch):
    """Without ``devices`` the mesh takes ``backend.resolve_device()``'s
    device: ``TVIDZ_TORCH_DEVICE=cpu`` gives ``[cpu] * n`` (8 cells when
    ``n_devices`` is not given); with no card and no variable it raises;
    explicit ``devices`` are taken as they are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TVIDZ_TORCH_DEVICE", "cpu")
    cpu = torch.device("cpu")
    m = tmesh.make_mesh(8)
    assert m.shape == {"data": 2, "corpus": 4}
    assert m.devices == ((cpu,) * 4,) * 2
    assert tmesh.make_mesh().shape == {"data": 2, "corpus": 4}
    assert tmesh.make_mesh(4).devices == ((cpu,) * 4,)
    monkeypatch.delenv("TVIDZ_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tmesh.make_mesh(8)
    m = tmesh.make_mesh(devices=["cpu"] * 2)
    assert m.shape == {"data": 1, "corpus": 2} and m.devices == ((cpu, cpu),)


def test_place_blocks_each_once_per_device():
    """The counterpart of the reference's per-shard block checks
    (_pallas_block_n has none: the port's kernels take any shard): blocks
    land on their cells, each leaves the host once, and cells on one
    device share one tensor."""
    m = tmesh.make_mesh(devices=CPU8)
    x = np.arange(16 * 3, dtype=np.int32).reshape(16, 3)
    puts = []

    def put(block, dev):
        puts.append(block.shape[0])
        return torch.from_numpy(block.copy()).to(dev)

    for axis, n in (("corpus", 4), ("data", 2), (None, 1)):
        puts.clear()
        sh = tss.place(x, m, axis, put=put)
        assert puts == [16 // n] * n and sh.block_rows == 16 // n
        shared = {}
        for d in range(2):
            for c in range(4):
                k = c if axis == "corpus" else d if axis == "data" else 0
                np.testing.assert_array_equal(sh.block(d, c).numpy(),
                                              x[k * (16 // n):(k + 1) * (16 // n)])
                assert shared.setdefault(k, sh.block(d, c)) is sh.block(d, c)
    sh = tss.place(x, m, "corpus")
    kept = tss.place(x + 100, m, "corpus", keep=sh, dirty={2})
    assert kept.block(1, 0) is sh.block(1, 0)
    np.testing.assert_array_equal(kept.block(1, 2).numpy(), x[8:12] + 100)
    with pytest.raises(ValueError):
        tss.place(x[:15], m, "corpus")


def test_sharded_timestamp_match_matches_golden(meshes, rng):
    jm, tm = meshes
    n, max_cuts = 32, 8
    corpus = rng.uniform(0, 50, size=(n, max_cuts)).astype(np.float32).round(1)
    lens = rng.integers(1, max_cuts + 1, size=n).astype(np.int32)
    query = np.concatenate([corpus[13, :4], [99.0, 98.0, 97.0, 96.0]]).astype(np.float32)
    corpus[9] = corpus[13]          # a second full match, in another shard
    with jm:
        want = np.asarray(jss.sharded_timestamp_match(
            jnp.asarray(query), jnp.asarray(corpus), jnp.asarray(lens), jm))
    got = tss.sharded_timestamp_match(torch.from_numpy(query),
                                      torch.from_numpy(corpus),
                                      torch.from_numpy(lens), tm).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, golden.timestamp_match_counts(query, corpus, lens))


def test_sharded_hamming_topk_ties_match_jax(meshes, rng):
    """Equal distances within a shard and across shard edges (the corpus
    axis is 4: rows 0-63, 64-127, ...) resolve to the lower global index,
    as jax.lax.top_k does; k cuts through a run of ties."""
    jm, tm = meshes
    m, n, k = 8, 256, 5
    q = rng.integers(0, 2**32, size=(m, 2), dtype=np.uint32)
    c = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    c[200] = q[3]
    for r in (63, 64, 130, 191, 192, 250):      # six exact copies of q[1]
        c[r] = q[1]
    c[5] = c[70] = c[140] = q[2] ^ np.uint32(1)  # three at distance 1
    valid = np.ones(n, bool)
    valid[250] = False
    with jm:
        wd, wi = jss.sharded_hamming_topk(jnp.asarray(q), jnp.asarray(c), jm, k=k)
        vd, vi = jss.sharded_hamming_topk(jnp.asarray(q), jnp.asarray(c), jm, k=k,
                                          valid=jnp.asarray(valid))
    d, idx = tss.sharded_hamming_topk(_i32(q), _i32(c), tm, k=k)
    np.testing.assert_array_equal(d.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    assert idx[1].tolist() == [63, 64, 130, 191, 192]
    d, idx = tss.sharded_hamming_topk(_i32(q), _i32(c), tm, k=k,
                                      valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(d.numpy(), np.asarray(vd))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(vi))
    h = golden.hamming_matrix(q, c)
    np.testing.assert_array_equal(np.sort(h, axis=1)[:, :k], np.asarray(wd))


def test_sharded_top1_takes_query_nearest_and_skips_masked_rows(
        meshes, rng, monkeypatch):
    """k = 1 (the multi-host verdict's nearest row) runs K4's
    ``query_nearest`` once per shard; a query whose nearest row is masked
    is answered by the masked scan. Both equal jax.lax.top_k's first
    index among ties, across shard edges too."""
    jm, tm = meshes
    m, n = 8, 256
    q = rng.integers(0, 2**32, size=(m, 2), dtype=np.uint32)
    c = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    for r in (63, 64, 130):                     # ties across shard edges
        c[r] = q[1]
    c[10] = c[200] = q[4]                       # nearest rows, both masked
    c[150] = q[4] ^ np.uint32(1)                # 2 bits off: the nearest valid
    valid = np.ones(n, bool)
    valid[[10, 63, 200]] = False
    calls = []
    real = tss.corpus_query_nearest
    monkeypatch.setattr(tss, "corpus_query_nearest",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    for mask in (None, valid):
        with jm:
            wd, wi = jss.sharded_hamming_topk(
                jnp.asarray(q), jnp.asarray(c), jm, k=1,
                **({} if mask is None else {"valid": jnp.asarray(mask)}))
        calls.clear()
        d, idx = tss.sharded_hamming_topk(
            _i32(q), _i32(c), tm, k=1,
            **({} if mask is None else {"valid": torch.from_numpy(mask)}))
        assert calls == [m] * 4                 # one K4 scan a shard
        np.testing.assert_array_equal(d.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    assert idx[1, 0] == 64 and idx[4, 0] == 150 and d[4, 0] == 2


def test_sharded_corpus_wrapper(meshes, rng):
    jm, tm = meshes
    fp = rng.integers(0, 2**32, size=(300, 2), dtype=np.uint32)
    vids = np.repeat([101, 202], 150).astype(np.int32)
    with jm:
        js = jss.ShardedCorpus(jm, max_cuts=16)
        js.load_timestamps([[1.0, 2.0, 3.0], [7.0, 8.0]], [101, 202])
        js.load_fingerprints(fp, vids)
        want = (js.match_timestamps([1.0, 2.0], min_match=2),
                js.match_timestamps([1.0, 2.0], min_match=2, exclude_video_id=101),
                js.nearest_fingerprints(fp[200:204], k=3))
    ts = tss.ShardedCorpus(tm, max_cuts=16)
    ts.load_timestamps([[1.0, 2.0, 3.0], [7.0, 8.0]], [101, 202])
    ts.load_fingerprints(fp, vids)
    got = (ts.match_timestamps([1.0, 2.0], min_match=2),
           ts.match_timestamps([1.0, 2.0], min_match=2, exclude_video_id=101),
           ts.nearest_fingerprints(fp[200:204], k=3))
    assert got == want
    assert got[0] == [(101, 2)] and got[1] == []
    assert got[2][0][0] == (0, 200, 202)


def test_sharded_nearest_fingerprints_drops_padding(meshes, rng):
    jm, tm = meshes
    fps = rng.integers(0, 2**32, size=(6, 2), dtype=np.uint32)
    q = np.full((1, 2), 0xFFFFFFF0, np.uint32)   # near the sentinel
    with jm:
        js = jss.ShardedCorpus(jm, max_cuts=8)
        js.load_fingerprints(fps, np.arange(6, dtype=np.int32))
        want = js.nearest_fingerprints(q, k=16)
    ts = tss.ShardedCorpus(tm, max_cuts=8)
    ts.load_fingerprints(fps, np.arange(6, dtype=np.int32))
    got = ts.nearest_fingerprints(q, k=16)
    assert got == want
    assert got[0] and all(vid >= 0 and idx < 6 for _, idx, vid in got[0])


def _run_steps(meshes, clips, pts, corpus_ts, corpus_len, corpus_fp, mafd=None,
               max_cuts=8):
    jm, tm = meshes
    with jm:
        args = jstep.place_step_inputs(jm, clips, pts, corpus_ts, corpus_len,
                                       corpus_fp)
        want = jstep.multichip_analysis_step(
            *args, mesh=jm, max_cuts=max_cuts,
            mafd=None if mafd is None else jnp.asarray(mafd))
        want = jax.tree_util.tree_map(np.asarray, want)
    got = tstep.multichip_analysis_step(
        *tstep.place_step_inputs(tm, clips, pts, corpus_ts, corpus_len, corpus_fp),
        mesh=tm, max_cuts=max_cuts,
        mafd=None if mafd is None else torch.from_numpy(mafd))
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_u32(got.fingerprints), want.fingerprints)
    np.testing.assert_array_equal(got.ts_counts.numpy(), want.ts_counts)
    np.testing.assert_array_equal(got.fp_min_dist.numpy(), want.fp_min_dist)
    return got


def test_multichip_analysis_step(meshes, rng):
    """Luma scene scores (no mafd): the step equals the JAX step, and its
    scores and hashes equal golden's whole-clip ones."""
    b, nt, t, h, w = 4, 2, 8, 24, 32
    clips = rng.integers(0, 256, size=(b, nt, t, h, w), dtype=np.uint8)
    clips[1, 1, 3:] = clips[1, 1, 2]            # a still run: score 0
    pts = np.tile(np.arange(nt * t, dtype=np.float32) / 25.0, (b, 1))
    corpus_ts = np.full((32, 16), np.nan, np.float32)
    corpus_len = np.zeros(32, np.int32)
    corpus_fp = rng.integers(0, 2**32, size=(512, 2), dtype=np.uint32)
    out = _run_steps(meshes, clips, pts, corpus_ts, corpus_len, corpus_fp)
    np.testing.assert_allclose(out.scores[0].numpy(),
                               golden.scene_scores(clips[0].reshape(nt * t, h, w)),
                               atol=1e-5)
    # Planted: clip 2's frame 5 in the corpus (min distance 0 there).
    corpus_fp[300] = _u32(out.fingerprints)[2, 5]
    out = _run_steps(meshes, clips, pts, corpus_ts, corpus_len, corpus_fp)
    assert out.fp_min_dist[2, 300] == 0


@pytest.mark.parametrize("base", [0.0, 3600.0 + 83 * (1001 / 30000.0)],
                         ids=["timeline_start", "hours_in"])
def test_multichip_step_rounds_pts_to_analyzer_boundary(meshes, base):
    """With mafd: cut timestamps extracted on the device match a corpus row
    holding the analyzer's 6-decimal-rounded values under EXACT equality,
    at the timeline's start and an hour into a 30000/1001 timeline (where a
    float32 rounding on the device would mis-round), and the mafd
    recurrence gives golden f_select scores."""
    b, nt, t, h, w = 2, 2, 8, 24, 32
    rng2 = np.random.default_rng(0 if base == 0.0 else 1)
    clips = rng2.integers(0, 256, size=(b, nt, t, h, w), dtype=np.uint8)
    pts = np.tile(base + np.arange(nt * t, dtype=np.float64) * (1001 / 30000.0),
                  (b, 1))
    if base == 0.0:
        pts = pts.astype(np.float32)
    mafd = np.full((b, nt * t), 1.0, np.float32)
    mafd[:, 3] = 80.0
    mafd[:, 7] = 60.0
    expect = [round(float(pts[0, 3]), 6), round(float(pts[0, 7]), 6)]
    corpus_ts = np.full((8 * 4, 16), np.nan, np.float32)
    corpus_ts[0, :2] = expect
    corpus_ts[13, :2] = expect                  # a second shard's copy
    corpus_len = np.zeros(8 * 4, np.int32)
    corpus_len[[0, 13]] = 2
    corpus_fp = rng2.integers(0, 2**32, size=(128 * 4, 2), dtype=np.uint32)
    out = _run_steps(meshes, clips, pts, corpus_ts, corpus_len, corpus_fp, mafd)
    assert out.ts_counts[:, 0].tolist() == [2, 2]
    assert out.ts_counts[:, 13].tolist() == [2, 2]
    prev = np.concatenate([[0.0], mafd[0, :-1]])
    want = np.clip(np.minimum(mafd[0], np.abs(mafd[0] - prev)) / 100, 0, 1)
    want[0] = 0.0
    np.testing.assert_allclose(out.scores[0].numpy(), want, atol=1e-6)


def test_sharded_fragment_search_batch_matches_jax(meshes, rng):
    """The 2-D (data x corpus) batch equals the JAX batch (per-tile Pallas
    kernel in interpret mode), a query of length 0 included."""
    jm, tm = meshes
    v, tc, tq_pad = 8, 64, 64
    corpus = rng.integers(1, 2**32 - 1, size=(v, tc, 2), dtype=np.uint32)
    lens = rng.integers(16, tc + 1, size=v).astype(np.int32)
    qs = np.full((4, tq_pad, 2), 0xFFFFFFFF, np.uint32)
    qlens = np.asarray([30, 20, 0, 12], np.int32)
    for i, ln in enumerate(qlens):
        src = int(rng.integers(0, v))
        qs[i, :ln] = corpus[src, : int(ln)]
    with jm:
        wo, ws = jss.sharded_fragment_search_batch(
            jnp.asarray(qs), jnp.asarray(qlens), jnp.asarray(corpus),
            jnp.asarray(lens), jm, hamming_threshold=5, use_pallas=True)
    offs, scores = tss.sharded_fragment_search_batch(
        _i32(qs), torch.from_numpy(qlens), _i32(corpus), torch.from_numpy(lens),
        tm, hamming_threshold=5)
    assert offs.shape == scores.shape == (4, v)
    np.testing.assert_array_equal(offs.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ws))
    assert scores[2].max() == 0


def test_sharded_fragment_search_matches_jax(meshes, rng):
    jm, tm = meshes
    v, tc, tq_pad = 16, 64, 64
    corpus = rng.integers(1, 2**32 - 1, size=(v, tc, 2), dtype=np.uint32)
    lens = rng.integers(16, tc + 1, size=v).astype(np.int32)
    q = np.full((tq_pad, 2), 0xFFFFFFFF, np.uint32)
    q_len = 24
    q[:q_len] = corpus[5, 8: 8 + q_len]
    corpus[12, 30: 30 + q_len] = q[:q_len]     # an equal match in shard 3
    lens[5], lens[12] = max(lens[5], 8 + q_len), max(lens[12], 30 + q_len)
    with jm:
        wo, ws = jss.sharded_fragment_search(
            jnp.asarray(q), jnp.int32(q_len), jnp.asarray(corpus),
            jnp.asarray(lens), jm, hamming_threshold=5, use_pallas=True)
    offs, scores = tss.sharded_fragment_search(
        _i32(q), q_len, _i32(corpus), torch.from_numpy(lens), tm,
        hamming_threshold=5)
    np.testing.assert_array_equal(offs.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ws))
    assert int(offs[5]) == 8 and int(offs[12]) == 30
    assert int(scores[5]) == int(scores[12]) == q_len


def test_sharded_verdict_scans_match_jax(meshes, rng):
    """frame_min and query-nearest per shard equal the JAX mesh scans (the
    Pallas kernels in interpret mode), argmin ties across shards resolving
    to the lowest global index."""
    jm, tm = meshes
    m, w, n = 16, 2, 2048          # corpus axis = 4 -> 512 rows a shard
    q = rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)
    c = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    c[511] = q[3]                  # exact hit at a shard boundary
    c[512] = q[1]                  # hit at the start of shard 1...
    c[1536 + 5] = q[1]             # ...tied in shard 3: argmin stays low
    c[1023] = c[1024] = q[6] ^ np.uint32(3)   # a distance-2 tie across an edge
    ct, qj = jnp.asarray(np.ascontiguousarray(c.T)), jnp.asarray(q)
    with jm:
        fm = np.asarray(jss.sharded_frame_min(qj, ct, jm, use_pallas=True))
        qm, qa = (np.asarray(x) for x in jss.sharded_nearest(qj, ct, jm,
                                                              use_pallas=True))
    got_fm = tss.sharded_frame_min(_i32(q), _i32(c), tm).numpy()
    got_rows = tss.sharded_frame_min_rows(_i32(q), _i32(c), tm).numpy()
    got_qm, got_qa = (x.numpy() for x in tss.sharded_nearest(_i32(q), _i32(c), tm))
    np.testing.assert_array_equal(got_fm, fm)
    np.testing.assert_array_equal(got_rows, fm)
    np.testing.assert_array_equal(got_qm, qm)
    np.testing.assert_array_equal(got_qa, qa)
    d = golden.hamming_matrix(q, c)
    np.testing.assert_array_equal(got_qa, d.argmin(axis=1))
    assert got_qa[1] == 512 and got_qa[3] == 511 and got_qa[6] == 1023
