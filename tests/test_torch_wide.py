"""Port parity at any word width, and scans of any query count.

phash256 fingerprints are 8 words. The same seeded numpy inputs go through
the JAX package — its Pallas scans and fragment kernel in interpret mode,
as tests/test_edge_parity.py and tests/test_torch_align.py run them, its
model, corpus and service — and the port's plain versions (what K2, K3 and
K4 are held to on the card), model, corpus and service. Distances,
argmins, offsets, counts and verdicts are integers: every comparison is
exact, except fingerprints, which the port's float32 sums may put
max(2, words) bits from the reference's (tests/test_ops_hashes.py).
Queries beyond a launch's 16,384 are split into chunks
(``max_queries``); the split is held to one unchunked call.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu import config as jax_config
from tvidz_tpu.corpus.device_corpus import DeviceCorpus as JaxCorpus
from tvidz_tpu.models.fingerprint import FingerprintModel as JaxModel
from tvidz_tpu.ops.align_pallas import fragment_search_pallas_batch
from tvidz_tpu.ops.hamming import corpus_min_distance as jax_corpus_min_distance
from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.corpus.store import Store
from tvidz_tpu_torch.decode import synthetic, write_synthetic_y4m
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.ops import align, hamming
from tvidz_tpu_torch.service import fakes
from tvidz_tpu_torch.service.app import create_app

SENTINEL = 0xFFFFFFFF


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _scan_case(words, m=19, n=700, seed=5):
    rng = np.random.default_rng(seed + words)
    q = rng.integers(0, 2 ** 32, size=(m, words), dtype=np.uint32)
    c = rng.integers(0, 2 ** 32, size=(n, words), dtype=np.uint32)
    c[[n - 100, 17]] = q[1]                          # a tie: the first wins
    c[[n // 2, n // 2 - 1]] = q[2] ^ np.uint32(1)    # a distance-1 tie
    c[-n // 20:] = SENTINEL
    q[3] = SENTINEL                                  # nearest: sentinel rows
    return q, c


# Widths the kernels walk in word chunks: 32 (TVIDZ_HASH_SIZE=32) and 128
# (TVIDZ_DCT_SIZE=64 TVIDZ_HASH_SIZE=64), and 26 and 42, whose last chunk
# of words is short.
WIDER_WORDS = [26, 32, 42, 128]


@pytest.mark.parametrize("words", [1, 3, 5, 8, *WIDER_WORDS])
def test_plain_scans_match_pallas_at_any_width(words):
    """K2's and K4's plain versions (every mode) equal the reference's Pallas
    scan (interpret mode) exactly, ties and sentinels included."""
    q, c = _scan_case(words)
    want = [np.asarray(x) for x in jax_corpus_min_distance(
        jnp.asarray(q), jnp.asarray(c), block_n=256)]
    got = hamming.corpus_min_distance(_t(q), _t(c))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[2][1]) == 17 and int(got[2][2]) == 349
    for mode in hamming.MODES:
        for g, w in zip(hamming.corpus_scan_tc(_t(q), _t(c), mode), want):
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=mode)
    np.testing.assert_array_equal(
        hamming.corpus_frame_min_xor(_t(q), _t(c)).numpy(), want[0])


def test_plain_fragment_search_matches_pallas_at_w8():
    rng = np.random.default_rng(8)
    v, tc, tq_pad, words = 12, 160, 64, 8
    corpus = rng.integers(0, 2 ** 32, size=(v, tc, words), dtype=np.uint32)
    lens = np.full(v, tc, np.int32)
    lens[3], lens[4] = 50, 0
    qs = np.full((3, tq_pad, words), SENTINEL, np.uint32)
    qlens = np.asarray([60, 23, 64], np.int32)
    for i, (tv, ts) in enumerate([(2, 30), (7, 90), (9, 0)]):
        qs[i, :qlens[i]] = corpus[tv, ts:ts + qlens[i]]
        qs[i, ::5, 3] ^= np.uint32(0b10101)          # 3 bits of damage
    for thr in (0, 10, 100):
        po, ps = align.fragment_search_batch(_t(qs), _t(qlens), _t(corpus),
                                             _t(lens), thr)
        ko, ks = fragment_search_pallas_batch(
            jnp.asarray(qs), jnp.asarray(qlens), jnp.asarray(corpus),
            jnp.asarray(lens), hamming_threshold=thr)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(ks))
        np.testing.assert_array_equal(po.numpy(), np.asarray(ko))
    assert ps[0, 2] == 60 and po[0, 2] == 30


@pytest.mark.parametrize("words", WIDER_WORDS)
def test_plain_fragment_search_matches_pallas_at_wider_words(words):
    """K3's plain version at the word widths K3 walks in chunks, against
    the reference's fragment kernel (interpret mode): offsets and counts
    equal at threshold 10 (and at 0 and 4 W, where most pairs match, at
    W = 26), ties included (video 3 repeats a 20-frame period)."""
    rng = np.random.default_rng(80 + words)
    v, tc, tq_pad = 4, 100, 40
    corpus = rng.integers(0, 2 ** 32, size=(v, tc, words), dtype=np.uint32)
    corpus[3] = np.resize(corpus[3, :20], (tc, words))
    lens = np.full(v, tc, np.int32)
    lens[1] = 30
    qs = np.full((2, tq_pad, words), SENTINEL, np.uint32)
    qlens = np.asarray([40, 25], np.int32)
    qs[0, :40] = corpus[2, 50:90]
    qs[0, ::3, 1] ^= np.uint32(0b1011)               # 3 bits of damage
    qs[1, :25] = corpus[3, 7:32]
    for thr in ((0, 10, 4 * words) if words == WIDER_WORDS[0] else (10,)):
        po, ps = align.fragment_search_batch(_t(qs), _t(qlens), _t(corpus),
                                             _t(lens), thr)
        ko, ks = fragment_search_pallas_batch(
            jnp.asarray(qs), jnp.asarray(qlens), jnp.asarray(corpus),
            jnp.asarray(lens), hamming_threshold=thr)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(ks))
        np.testing.assert_array_equal(po.numpy(), np.asarray(ko))
        if thr == 10:
            assert (int(ps[0, 2]), int(po[0, 2])) == (40, 50)
            assert (int(ps[1, 3]), int(po[1, 3])) == (25, 7)


def test_kernel_word_limits_are_not_shared_memory():
    """Every width a dct_size / hash_size pair reaches up to 64 x 64 passes
    the kernels' checks; only their keys bound W."""
    for w in (1, 2, 8, *WIDER_WORDS):
        assert w <= min(hamming.K2_MAX_WORDS, hamming.K4_MAX_WORDS,
                        align.K3_MAX_WORDS)
    assert min(hamming.K2_MAX_WORDS, hamming.K4_MAX_WORDS,
               align.K3_MAX_WORDS) > 1 << 17


@pytest.mark.parametrize("words", [2, 8])
def test_query_chunks_equal_one_call(words):
    """M = 40,000 queries in chunks of at most ``max_queries`` (the kernels'
    16,384 lowered to 7,000 and 16,384) equal one unchunked plain call:
    frame_min the min over chunks, q_min / q_arg concatenated."""
    q, c = _scan_case(words, m=40_000, n=64, seed=9)
    q[39_999] = c[40]
    q_, c_ = _t(q), _t(c)
    want = hamming.corpus_min_distance_plain(q_, c_)
    assert int(want[2][39_999]) == 40
    for chunk in (7_000, 16_384):
        for g, w in zip(hamming.corpus_min_distance(q_, c_, max_queries=chunk), want):
            assert torch.equal(g, w)
        assert torch.equal(hamming.corpus_frame_min_xor(q_, c_, max_queries=chunk),
                           want[0])
        for mode in hamming.MODES:
            got = hamming.corpus_scan_tc(q_, c_, mode, max_queries=chunk)
            assert all(g is None or torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(hamming.corpus_frame_min(q_, c_, max_queries=chunk),
                           want[0])
        assert all(torch.equal(g, w) for g, w in zip(
            hamming.corpus_query_nearest(q_, c_, max_queries=chunk), want[1:]))


def test_corpus_routes_never_pass_more_than_a_launch(monkeypatch):
    """``nearest_video_counts`` and ``search_fingerprints`` with 40,000 query
    rows (a 22-minute video) hand at most 16,384 rows to each scan, and
    answer as the reference's corpus does."""
    seen = []
    one = hamming.corpus_scan_pm1_plain

    def recording(q, corpus, mode):
        seen.append(q.shape[0])
        return one(q, corpus, mode)

    monkeypatch.setattr(hamming, "corpus_scan_pm1_plain", recording)
    rng = np.random.default_rng(12)
    vids = {v: rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
            for v, n in ((1, 200), (2, 300))}
    tc, jc = DeviceCorpus(device="cpu", fp_initial_capacity=512), JaxCorpus(
        fp_initial_capacity=512)
    for v, fp in vids.items():
        tc.append_fingerprints(v, fp)
        jc.append_fingerprints(v, fp)
    query = rng.integers(0, 2 ** 32, size=(40_000, 2), dtype=np.uint32)
    query[:150] = vids[2][:150]
    query[-70:] = vids[1][100:170]
    got = tc.nearest_video_counts(query)
    assert seen and max(seen) <= 16_384 and sum(seen) >= 40_000
    assert got == jc.nearest_video_counts(query) == {1: 70, 2: 150}
    seen.clear()
    assert (tc.search_fingerprints(query, min_match=1)
            == jc.search_fingerprints(query, min_match=1))
    assert seen and max(seen) <= 16_384


def _configs(monkeypatch, algo="phash256"):
    monkeypatch.setenv("TVIDZ_HASH_ALGO", algo)
    jcfg, tcfg = jax_config.Config(), Config()
    for cfg in (jcfg, tcfg):
        cfg.pipeline.block_frames = 64
        cfg.pipeline.scene_height = 36
        cfg.pipeline.scene_width = 64
    assert tcfg.hash.algorithm == algo == jcfg.hash.algorithm
    return jcfg, tcfg


@pytest.mark.parametrize("algo", ["phash256", "dhash"])
def test_model_under_a_family_matches_reference(monkeypatch, algo):
    """``analyze_array`` under ``TVIDZ_HASH_ALGO``: the same cuts as the
    reference's model, fingerprints of its width within tolerance."""
    jcfg, tcfg = _configs(monkeypatch, algo)
    luma, _ = synthetic.synthetic_video(150, 36, 64, cut_frames=(40, 100), seed=4)
    luma[::7] = np.random.default_rng(1).integers(0, 256, size=luma[::7].shape)
    pts = np.arange(150) / 25.0
    model = FingerprintModel(tcfg, device="cpu")
    assert not model.k1 and model.words == tcfg.hash.words
    cuts, fps = model.analyze_array(luma, pts)
    jcuts, jfps = JaxModel(jcfg).analyze_array(luma, pts)
    assert cuts == jcuts
    assert fps.shape == np.asarray(jfps).shape == (150, tcfg.hash.words)
    x = fps ^ np.asarray(jfps, np.uint32)
    assert np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).max() <= max(2, tcfg.hash.words)


def test_wide_corpus_matches_reference():
    """``DeviceCorpus(words=8)`` answers ``search_fingerprints``,
    ``nearest_video_counts`` and ``locate_fragment`` as the reference's."""
    rng = np.random.default_rng(21)
    kw = dict(words=8, fp_initial_capacity=512, fp_block_n=256, hamming_threshold=20)
    tc, jc = DeviceCorpus(device="cpu", **kw), JaxCorpus(**kw)
    vids = {v: rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)
            for v, n in ((1, 130), (2, 300), (3, 90))}
    for v, fp in vids.items():
        for c in (tc, jc):
            c.append_fingerprints(v, fp)
    tc.remove_video(3)
    jc.remove_video(3)
    frag = vids[2][70:140].copy()
    frag[::4, 5] ^= np.uint32(0b111)
    queries = [frag, vids[1][:20], vids[3][:10],
               rng.integers(0, 2 ** 32, size=(9, 8), dtype=np.uint32)]
    for q in queries:
        for excl in (None, 2):
            assert (tc.nearest_video_counts(q, exclude_video_id=excl)
                    == jc.nearest_video_counts(q, exclude_video_id=excl))
            assert (tc.search_fingerprints(q, min_match=1, exclude_video_id=excl)
                    == jc.search_fingerprints(q, min_match=1, exclude_video_id=excl))
        assert tc.locate_fragment(q, top_k=3) == jc.locate_fragment(q, top_k=3)
    assert tc.locate_fragment(frag, top_k=1) == [(2, 70, 70)]


def test_service_duplicate_under_phash256(tmp_path, monkeypatch):
    """The service under ``TVIDZ_HASH_ALGO=phash256``: a renamed copy of an
    upload is its duplicate, ``/search/fragment`` and ``/search/video``
    find it, and the corpus holds 8-word fingerprints."""
    monkeypatch.setenv("TVIDZ_HASH_ALGO", "phash256")
    cfg = Config()
    cfg.pipeline.block_frames = 64
    cfg.pipeline.scene_height = 72
    cfg.pipeline.scene_width = 96
    cfg.pipeline.tmp_dir = str(tmp_path / "work")
    cfg.service.sse_poll_s = 0.02
    (tmp_path / "work").mkdir()
    sqs, s3 = fakes.FakeSQS(), fakes.FakeS3(str(tmp_path / "s3"))
    sqs.create_queue(cfg.service.sqs_queue)
    s3.create_bucket(cfg.service.s3_bucket)
    s3.configure_notification(sqs, cfg.service.sqs_queue)
    app = create_app(config=cfg, store=Store("sqlite:///:memory:"), s3=s3,
                     sqs=sqs, device="cpu")
    client = app.wsgi.test_client()
    path = tmp_path / "src.y4m"
    write_synthetic_y4m(str(path), num_frames=200, height=72, width=96,
                        cut_frames=(60, 140), seed=31)

    def upload(name):
        s3.put_file(cfg.service.s3_bucket, name, str(path))
        deadline = time.time() + 60
        while time.time() < deadline:
            data = client.get(f"/status/{name}").get_json()
            if data.get("status") in ("done", "error"):
                return data
            time.sleep(0.05)
        raise TimeoutError(name)

    try:
        assert app.corpus.words == 8
        app.start_poller()
        app.config.pipeline.early_exit = False
        first = upload("src.y4m")
        assert first["status"] == "done" and first["duplicates"] == []
        copy = upload("1700000000-src.y4m")
        assert copy["status"] == "done" and copy["duplicates"] == ["src.y4m"]
        frag = client.post("/search/fragment", json_body={
            "filename": "src.y4m", "start_frame": 100, "num_frames": 40}).get_json()
        assert frag["matches"][0]["filename"] == "src.y4m"
        found = client.post("/search/video?filename=q.y4m&top_k=3",
                            data=path.read_bytes()).get_json()
        assert found["fingerprint_matches"][0]["filename"] == "src.y4m"
        assert found["best_alignments"][0]["match_count"] == 200
        assert app.corpus._fp.shape[1] == 8
    finally:
        app.stop()
