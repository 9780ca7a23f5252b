"""Port parity for slice 3: the corpus-scan modes of kernel K4.

Each mode's plain version (``corpus_scan_pm1_plain``, what K4 is held to
on the card) against the JAX Pallas kernel it replaces, run interpreted as
tests/test_ops_hamming.py runs them, on seeded corpora word-major on the
JAX side and row-major in the port, with ties planted across the JAX
blocks, sentinel rows and duplicate queries. Tolerance: exact. Then
``search_fingerprints`` and ``nearest_video_counts`` of the port against
the JAX ``DeviceCorpus``, with tombstones; and the
port's ``bench`` on the CPU at tiny sizes.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.corpus.device_corpus import DeviceCorpus as JaxCorpus
from tvidz_tpu.ops.hamming import (
    corpus_frame_min_t_mxu,
    corpus_min_distance_t_mxu,
    corpus_min_distance_t_mxu_hoisted,
    corpus_min_distance_t_mxu_twophase,
    corpus_query_nearest_t_mxu,
)
from tvidz_tpu_torch import bench, cli
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.ops import hamming

N = 2048
# mode -> (the JAX kernel, which of (frame_min, q_min, q_arg) it returns)
REFERENCES = {
    "full": (corpus_min_distance_t_mxu, (0, 1, 2)),
    "full_cols": (corpus_min_distance_t_mxu_hoisted, (0, 1, 2)),
    "twophase": (corpus_min_distance_t_mxu_twophase, (0, 1, 2)),
    "frame_min": (lambda q, c, block_n: (corpus_frame_min_t_mxu(
        q, c, block_n=block_n),), (0,)),
    "query_nearest": (corpus_query_nearest_t_mxu, (1, 2)),
}


def _inputs(m, block_n, seed=31):
    rng = np.random.default_rng(seed)
    corpus = rng.integers(0, 2 ** 32, size=(N, 2), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(m, 2), dtype=np.uint32)
    corpus[-64:] = 0xFFFFFFFF                        # sentinel rows
    q[0] = 0xFFFFFFFF                                # nearest are sentinels
    corpus[[block_n - 1, block_n]] = q[1]            # tie across a block edge
    corpus[[3 * block_n + 5, block_n + 9]] = q[2]    # lower copy, later block
    corpus[[700, 300, 1500]] = q[3] ^ np.uint32(5)   # distance-4 ties
    q[4] = q[2]                                      # duplicate query rows
    return q, corpus


def _jax(mode, q, corpus, block_n):
    """The JAX kernel's outputs at (frame_min, q_min, q_arg) positions; M is
    padded to the 8-row multiple with copies of row 0, as its wrappers do."""
    m = q.shape[0]
    qp = np.concatenate([q, np.repeat(q[:1], -m % 8, axis=0)])
    fn, slots = REFERENCES[mode]
    outs = fn(jnp.asarray(qp), jnp.asarray(corpus.T), block_n=block_n)
    full = [None, None, None]
    for slot, o in zip(slots, outs):
        full[slot] = np.asarray(o) if slot == 0 else np.asarray(o)[:m]
    return full


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("block_n", [256, 512])
@pytest.mark.parametrize("m", [8, 37])
@pytest.mark.parametrize("mode", hamming.MODES)
def test_plain_mode_equals_jax_kernel(mode, m, block_n):
    q, corpus = _inputs(m, block_n)
    want = _jax(mode, q, corpus, block_n)
    got = hamming.corpus_scan_pm1_plain(_t(q), _t(corpus), mode)
    wrapped = hamming.corpus_scan_tc(_t(q), _t(corpus), mode)   # CPU: plain
    for w, g, g2 in zip(want, got, wrapped):
        assert (w is None) == (g is None) == (g2 is None)
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), w)
            np.testing.assert_array_equal(g2.numpy(), w)
    if want[1] is not None:                          # the planted answers
        assert (want[1][1], want[2][1]) == (0, block_n - 1)
        assert (want[1][2], want[2][2]) == (0, block_n + 9)
        assert (want[1][3], want[2][3]) == (4, 300)
        assert want[2][0] == N - 64


def test_k2_frame_min_only_equals_the_full_scan():
    q, corpus = _inputs(37, 256)
    full = hamming.corpus_min_distance(_t(q), _t(corpus))
    assert torch.equal(hamming.corpus_frame_min_xor(_t(q), _t(corpus)), full[0])


def test_unknown_mode_and_wide_hashes_raise():
    q, corpus = _inputs(8, 256)
    with pytest.raises(ValueError, match="unknown scan mode"):
        hamming.corpus_scan_tc(_t(q), _t(corpus), "fast")
    with pytest.raises(ValueError, match="unknown scan mode"):
        hamming.corpus_scan_pm1_plain(_t(q), _t(corpus), "fast")
    # Any width a configuration reaches passes the kernels' checks (8
    # words: phash256; 128: TVIDZ_DCT_SIZE=64 TVIDZ_HASH_SIZE=64); a row
    # wider than the keys hold raises rather than fall back.
    assert hamming._check_kernel_inputs(
        _t(np.tile(q, 4)), _t(np.tile(corpus, 4)), "tensor-core scan",
        hamming.K4_MAX_WORDS)[1:] == (8, corpus.shape[0])
    assert hamming._check_kernel_inputs(
        _t(np.tile(q, 64)), _t(np.tile(corpus, 64)), "tensor-core scan",
        hamming.K4_MAX_WORDS)[1:] == (8, corpus.shape[0])
    words = hamming.K4_MAX_WORDS + 1
    with pytest.raises(ValueError, match=f"1..{hamming.K4_MAX_WORDS} words"):
        hamming._check_kernel_inputs(
            torch.zeros((1, words), dtype=torch.int32),
            torch.zeros((1, words), dtype=torch.int32),
            "tensor-core scan", hamming.K4_MAX_WORDS)


KW = dict(ts_initial_capacity=8, fp_initial_capacity=512, fp_block_n=256)


def _corpora():
    """The same seeded corpus in both packages: 6 videos, two of them
    removed (tombstoned rows), one re-appended, a near-copy of video 3."""
    rng = np.random.default_rng(41)
    videos = {v: rng.integers(0, 2 ** 32, size=(60 + 25 * v, 2), dtype=np.uint32)
              for v in range(1, 7)}
    videos[6][:40] = videos[3][10:50] ^ np.uint32(1 << 7)
    out = []
    for c in (JaxCorpus(**KW), DeviceCorpus(device="cpu", **KW)):
        for v, fp in videos.items():
            c.append_fingerprints(v, fp)
        c.remove_video(2)
        c.remove_video(5)
        c.append_fingerprints(7, videos[2][:30])
        out.append(c)
    query = np.concatenate([videos[3][5:60], videos[2][:20],
                            rng.integers(0, 2 ** 32, size=(9, 2), dtype=np.uint32)])
    return out, query


@pytest.mark.parametrize("excl", [None, 3])
def test_search_fingerprints_matches_jax(excl):
    (jc, tc), query = _corpora()
    want = jc.search_fingerprints(query, exclude_video_id=excl)
    assert tc.search_fingerprints(query, exclude_video_id=excl) == want
    assert dict(want)[6] >= 40 and 2 not in dict(want)


@pytest.mark.parametrize("excl", [None, 3])
def test_nearest_video_counts_matches_jax(excl):
    (jc, tc), query = _corpora()
    want = jc.nearest_video_counts(query, exclude_video_id=excl)
    assert tc.nearest_video_counts(query, exclude_video_id=excl) == want
    assert want[7] == 20 and 2 not in want


def test_bench_on_cpu_prints_every_key(capsys):
    assert cli.main(["bench", "--device", "cpu", "--sizes", "tiny"]) == 0
    card, record = capsys.readouterr().out.strip().splitlines()[-2:]
    assert "device cpu" in card
    rec = json.loads(record)
    for key in ("value", "verdict_1m_device_ms", "verdict_16m_device_ms",
                "verdict_compares_per_sec", "frame_evidence_1m_device_ms",
                "frame_evidence_16m_device_ms", "timestamp_match_p50_ms",
                "fragment_search_1m_p50_ms", "fragment_search_10m_p50_ms"):
        assert key in rec
    # No card: device numbers are not measured, host numbers are.
    assert rec["value"] is None and rec["verdict_1m_device_ms"] is None
    assert rec["fragment_search_10m_p50_ms"] > 0
    assert rec["host"]["verdict_1m_wall_p50_ms"] > 0
    variants = {r["variant"] for r in rec["race"]}
    assert variants == set(bench.SCANS)
    assert all(r["agree"] for r in rec["race"])
    assert {r["n"] for r in rec["race"] if r["variant"] == "k4_full_cols"} == {
        1 << 11, 1 << 12, 1 << 13}
