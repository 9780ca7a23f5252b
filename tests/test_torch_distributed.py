"""Port parity: the corpus sharded across processes
(``tvidz_tpu_torch/parallel/distributed.py``).

The same seeded store rows and the same op sequence — warm, appends past
every capacity (online growth), removes, the compaction a full tail with
tombstones triggers, and every query — go through the JAX package's
``MultiHostShardedCorpus`` on its 8-device virtual CPU mesh (one process)
and through the port's on a one-rank gloo group over ``[cpu] * 8``: every
result is exactly equal (ids, counts, offsets, scores, tie order), and so
are the host mirrors and every device table, gathered.

Then the reference's ``tests/test_collective_append.py``, one for one, on
the port (its (data 2, corpus 4) mesh is ``local_data=2, local_corpus=4``).
"""

import numpy as np
import pytest
import torch

from tvidz_tpu_torch.parallel import distributed as tdist

CPU8 = [torch.device("cpu")] * 8


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group, as a served rank of a cluster of one."""
    import torch.distributed as dist

    assert tdist.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                  device="cpu")
    assert dist.get_backend() == "gloo" and tdist.process_count() == 1
    yield
    dist.destroy_process_group()


class _RowsStore:
    """The two reads ``refresh_from_store`` makes of a store."""

    def __init__(self, ts, fps):
        self.ts, self.fps = ts, fps

    def all_timestamps(self):
        return list(self.ts)

    def all_fingerprints(self):
        return list(self.fps)


def _video(rng, pool, n_frames):
    """Fingerprints drawn half from a small shared pool (distance ties and
    equal fragment scores across videos) and half at random."""
    own = rng.integers(0, 2 ** 32, size=(n_frames, 2), dtype=np.uint32)
    shared = pool[rng.integers(0, len(pool), size=n_frames)]
    return np.where(rng.random((n_frames, 1)) < 0.5, shared, own)


def _scenario(mh, seed: int, tables):
    """Warm, then appends, removes and queries; returns every result and,
    after each mutation batch, ``tables(mh)`` (the state to compare)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2 ** 32, size=(40, 2), dtype=np.uint32)
    ts_rows, fp_rows, vids = [], [], list(range(1, 13))
    for v in vids:
        n_cuts = int(rng.integers(0, 24))          # some past max_cuts (16)
        ts_rows.append((v, sorted(np.round(rng.uniform(0, 60, n_cuts), 2).tolist())))
        if v % 4:                                   # a few without fingerprints
            fp_rows.append((v, _video(rng, pool, int(rng.integers(20, 90)))))
    mh.refresh_from_store(_RowsStore(ts_rows, fp_rows), min_ts_rows=16,
                          min_fp_rows=512)
    known = {v: f for v, f in fp_rows}
    cuts = dict(ts_rows)
    out = []

    def queries(tag):
        qs = [v for v in cuts if len(cuts[v]) >= 3][:4]
        for i, v in enumerate(qs):
            out.append((tag, "ts", mh.match_timestamps(
                cuts[v][:3] + [99.5], min_match=2,
                exclude_video_id=v if i == 1 else None)))
        out.append((tag, "ts_tol", mh.match_timestamps(
            [x + 0.004 for x in cuts[qs[0]]], min_match=1, tolerance=0.01)))
        live = [v for v in known if known[v] is not None]
        for i, v in enumerate(live[:3]):
            f = known[v]
            q = np.concatenate([f[3:11], pool[:2]])
            out.append((tag, "fp_evidence", mh.search_fingerprints(
                q, min_match=1 + i, exclude_video_id=v if i == 2 else None)))
            out.append((tag, "nearest", mh.nearest_fingerprints(q, k=4)))
            out.append((tag, "fragment", mh.fragment_search(
                f[5:25], top_k=3, exclude_video_id=v if i == 1 else None)))
        out.append((tag, "fragment_thr0", mh.fragment_search(
            known[live[0]][:16], top_k=5, hamming_threshold=0)))
        out.append((tag, "fragments", mh.fragment_search_batch(
            [known[v][2:30] for v in live[:3]] + [np.zeros((0, 2), np.uint32)],
            top_k=2, exclude_video_ids=[None, live[1], None, None])))
        out.append((tag, "tables", tables(mh)))

    queries("warm")
    # Appends: new videos past the timestamp rows and the alignment rows,
    # and fingerprints past the 512-row warm capacity; streamed blocks of
    # one video; a zero-cut re-analysis; a re-analysis of a warm video.
    for v in range(20, 40):
        ts = sorted(np.round(rng.uniform(0, 60, int(rng.integers(2, 20))), 2).tolist())
        f = _video(rng, pool, int(rng.integers(10, 70)))
        mh.append_video(v, ts=ts, fps=f, src_process=0)
        cuts[v], known[v] = ts[:16], f
    for block in range(3):
        f = _video(rng, pool, 30)
        mh.append_video(30, fps=f, src_process=0)
        known[30] = np.concatenate([known[30], f])
    mh.append_video(21, ts=[], src_process=0, upsert_empty_ts=True)
    cuts[21] = []
    mh.append_video(2, ts=[1.0, 2.0, 3.0], src_process=0)
    cuts[2] = [1.0, 2.0, 3.0]
    queries("grown")
    for v in (3, 22, 25, 30):
        mh.remove_video(v)
        cuts.pop(v, None)
        known[v] = None
    queries("removed")
    # Refill past the fingerprint capacity: the tombstones are reclaimed by
    # a compaction first, then the index grows.
    fills = 0
    while mh.fp_compactions == 0 and fills < 100:
        v = 100 + fills
        f = _video(rng, pool, 64)
        mh.append_video(v, ts=[float(v), float(v) + 0.5], fps=f, src_process=0)
        cuts[v], known[v] = [float(v), float(v) + 0.5], f
        fills += 1
    assert mh.fp_compactions == 1
    queries("compacted")
    return out


def _jax_tables(mh):
    import jax

    inner = mh._inner
    host = lambda a: np.asarray(jax.device_get(a))  # noqa: E731
    return _state(mh, host(inner.corpus_ts), host(inner.corpus_len),
                  host(inner.corpus_fp).view(np.int32),
                  host(inner.corpus_fp_valid), host(mh.corpus_al).view(np.int32),
                  host(mh.corpus_al_len))


def _torch_tables(mh):
    inner = mh._inner
    g = lambda s: mh._gather_all(s).numpy()  # noqa: E731
    return _state(mh, g(inner.corpus_ts), g(inner.corpus_len), g(inner.corpus_fp),
                  g(inner.corpus_fp_valid), g(mh.corpus_al), g(mh.corpus_al_len))


def _state(mh, ts, ts_len, fp, valid, al, al_len):
    inner = mh._inner
    return {
        "counts": (mh._ts_rows, mh._fp_count, mh._al_rows, mh.fp_compactions),
        "mirrors": [a.tolist() for a in (inner.video_ids, inner.fp_video_ids,
                                         mh.al_video_ids, mh.al_len_host)],
        # NaN padding compares through its bits.
        "ts": ts.view(np.int32).tolist(), "ts_len": ts_len.tolist(),
        "fp": fp.tolist(), "valid": valid.astype(bool).tolist(),
        "al": al.tolist(), "al_len": al_len.tolist(),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_same_ops_same_results_and_tables_as_the_reference(group, seed):
    import jax

    from tvidz_tpu.parallel import distributed as jdist

    if jax.device_count() < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    kw = dict(max_cuts=16, hamming_threshold=5, al_tcap=64)
    jmh = jdist.MultiHostShardedCorpus(jdist.make_multihost_mesh(), **kw)
    tmh = tdist.MultiHostShardedCorpus(
        tdist.make_multihost_mesh(local_devices=CPU8), **kw)
    assert dict(tmh.mesh.shape) == dict(jmh.mesh.shape) == {"data": 1, "corpus": 8}
    want = _scenario(jmh, seed, _jax_tables)
    got = _scenario(tmh, seed, _torch_tables)
    assert len(got) == len(want)
    for (tag, what, g), (_, _, w) in zip(got, want):
        assert g == w, (tag, what)


def test_make_multihost_mesh_layout(group):
    m = tdist.make_multihost_mesh(local_devices=CPU8)
    assert (m.rank, m.world, m.shape) == (0, 1, {"data": 1, "corpus": 8})
    assert m.local.shape == {"data": 1, "corpus": 8}
    m = tdist.make_multihost_mesh(local_corpus=2, local_devices=CPU8[:6])
    assert m.shape == {"data": 3, "corpus": 2}
    m = tdist.make_multihost_mesh(local_devices=CPU8[:6])
    assert m.shape == {"data": 3, "corpus": 2}       # largest power of 2 dividing
    with pytest.raises(ValueError, match="does not divide"):
        tdist.make_multihost_mesh(local_corpus=4, local_devices=CPU8[:6])
    with pytest.raises(ValueError, match="local mesh"):
        tdist.make_multihost_mesh(local_data=3, local_corpus=2,
                                  local_devices=CPU8[:4])


def test_init_distributed_needs_a_coordinator(monkeypatch):
    for k in ("TVIDZ_COORDINATOR", "TVIDZ_NUM_PROCESSES", "TVIDZ_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_distributed(device="cpu") is False
    monkeypatch.setenv("TVIDZ_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="TVIDZ_NUM_PROCESSES"):
        tdist.init_distributed(device="cpu")
    # NCCL is for CUDA ranks: a CPU rank asked for it is refused, never
    # quietly given gloo.
    monkeypatch.setenv("TVIDZ_NUM_PROCESSES", "1")
    monkeypatch.setenv("TVIDZ_PROCESS_ID", "0")
    monkeypatch.setenv(tdist.ENV_BACKEND, "nccl")
    with pytest.raises(ValueError, match="nccl"):
        tdist.init_distributed(device="cpu")


# -- tests/test_collective_append.py on the port -------------------------------------


@pytest.fixture
def mesh(group):
    return tdist.make_multihost_mesh(local_data=2, local_corpus=4,
                                     local_devices=CPU8)


@pytest.fixture()
def corpus(mesh):
    c = tdist.MultiHostShardedCorpus(mesh, max_cuts=16)
    c.load_timestamps([[1.0, 2.0, 3.0]], [100], min_rows=64)
    fp0 = np.arange(20, dtype=np.uint32).reshape(10, 2)
    c.load_fingerprints(fp0, np.full(10, 100, np.int32), min_rows=2048)
    return c


def test_append_timestamps_matches_load(corpus):
    corpus.append_video(200, ts=[5.5, 7.25, 9.0], src_process=0)
    hits = corpus.match_timestamps([5.5, 9.0, 42.0], min_match=2)
    assert hits == [(200, 2)]
    # The pre-existing row is untouched.
    assert corpus.match_timestamps([1.0, 2.0], min_match=2) == [(100, 2)]


def test_append_timestamps_upsert_same_video(corpus):
    corpus.append_video(200, ts=[5.5, 7.25, 9.0], src_process=0)
    corpus.append_video(200, ts=[11.0, 13.0], src_process=0)  # re-analysis
    assert corpus.match_timestamps([11.0, 13.0], min_match=2) == [(200, 2)]
    # Old row content replaced, including length (no stale tail).
    assert corpus.match_timestamps([5.5, 9.0], min_match=2) == []
    assert corpus._ts_rows == 2  # upsert did not claim a new row


def test_append_fingerprints_searchable(corpus):
    rng = np.random.default_rng(3)
    new = rng.integers(1, 2**32 - 1, size=(130, 2), dtype=np.uint32)
    corpus.append_video(300, fps=new, src_process=0)  # spans a 128-row bucket
    nn = corpus.nearest_fingerprints(new[:4], k=1)
    for m in range(4):
        d0, idx0, vid0 = nn[m][0]
        assert d0 == 0 and vid0 == 300, (m, nn[m])
    # Earlier fingerprints still intact.
    nn0 = corpus.nearest_fingerprints(
        np.arange(4, dtype=np.uint32).reshape(2, 2), k=1)
    assert nn0[0][0][0] == 0 and nn0[0][0][2] == 100


def test_append_accumulates_many_videos(corpus):
    rng = np.random.default_rng(4)
    rows = {}
    for vid in range(500, 510):
        ts = sorted(rng.uniform(0, 100, size=4).round(2).tolist())
        fps = rng.integers(1, 2**32 - 1, size=(16, 2), dtype=np.uint32)
        corpus.append_video(vid, ts=ts, fps=fps, src_process=0)
        rows[vid] = (ts, fps)
    for vid, (ts, fps) in rows.items():
        assert corpus.match_timestamps(ts[:2], min_match=2)[0][0] == vid
        nn = corpus.nearest_fingerprints(fps[:2], k=1)
        assert nn[0][0][0] == 0 and nn[0][0][2] == vid


def test_append_past_capacity_grows(mesh):
    """Appends past warm capacity grow the index online instead of
    raising; prior rows survive the redistribution."""
    c = tdist.MultiHostShardedCorpus(mesh, max_cuts=16)
    c.load_timestamps([[1.0]], [1])  # minimal capacity
    fp0 = np.ones((1, 2), np.uint32)
    c.load_fingerprints(fp0, np.array([1], np.int32))
    cap_ts = c._inner.corpus_ts.shape[0]
    for vid in range(2, cap_ts + 2):          # one past warm capacity
        c.append_video(vid, ts=[float(vid)], src_process=0)
    assert c._inner.corpus_ts.shape[0] >= cap_ts * 2
    assert c.match_timestamps([1.0], min_match=1) == [(1, 1)]
    assert c.match_timestamps([float(cap_ts + 1)], min_match=1) == \
        [(cap_ts + 1, 1)]
    cap_fp = c._inner.corpus_fp.shape[0]
    big = np.arange(cap_fp * 2, dtype=np.uint32).reshape(cap_fp, 2)
    c.append_video(9999, fps=big, n_fp=cap_fp, src_process=0)
    assert c._inner.corpus_fp.shape[0] >= cap_fp * 2
    nn = c.nearest_fingerprints(big[3:4], k=1)
    assert nn[0][0][0] == 0 and nn[0][0][2] == 9999  # distance 0, vid


def test_append_requires_metadata_only_on_nonsource(corpus):
    """The metadata-only call shape is accepted when this process IS the
    source (payload wins, counts validated)."""
    corpus.append_video(700, ts=[1.5, 2.5], n_ts=2,
                        fps=np.ones((3, 2), np.uint32), n_fp=3,
                        src_process=0)
    assert corpus.match_timestamps([1.5, 2.5], min_match=2)[0][0] == 700


def test_append_truncates_first_max_cuts(mesh):
    """>max_cuts videos truncate to the FIRST max_cuts (store invariant)
    instead of raising on the source, which would leave a multi-process
    collective waiting."""
    c = tdist.MultiHostShardedCorpus(mesh, max_cuts=16)
    c.load_timestamps([[1.0]], [1], min_rows=16)
    long_ts = [float(i) for i in range(40)]  # 40 cuts > max_cuts=16
    c.append_video(900, ts=long_ts, src_process=0)
    # First 16 kept: matching on early cuts works...
    assert c.match_timestamps([0.0, 5.0], min_match=2)[0][0] == 900
    # ...cuts beyond max_cuts were dropped.
    assert c.match_timestamps([20.0, 30.0], min_match=2) == []


def test_append_payload_guards(corpus):
    with pytest.raises(ValueError, match="must supply ts"):
        corpus.append_video(901, n_ts=3, src_process=0)
    with pytest.raises(ValueError, match="must supply fps"):
        corpus.append_video(902, n_fp=8, src_process=0)
    with pytest.raises(ValueError, match="only the analyzing process"):
        corpus.append_video(903, ts=[1.0, 2.0], src_process=1)
