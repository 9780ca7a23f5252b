"""Port parity: fragment alignment (ops/align.py).

The same seeded numpy inputs go through the JAX package — ``ops.align``'s
XLA composition and the Pallas fragment kernel in interpret mode, as
tests/test_align_pallas.py runs it — and the port's plain versions, which
are what kernel K3 is held to on the card. Offsets and scores are integers:
every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.ops import align as jax_align
from tvidz_tpu.ops.align_pallas import (
    fragment_search_pallas,
    fragment_search_pallas_batch,
)
from tvidz_tpu_torch.ops import align

SENTINEL = 0xFFFFFFFF


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _port(q, tq, corpus, lens, thr):
    o, s = align.fragment_search(_t(q), tq, _t(corpus), _t(lens), thr)
    return o.numpy(), s.numpy()


def _all_equal(q, tq, corpus, lens, thr, chunk=8):
    """Port == XLA fragment_search == Pallas kernel (interpret) for one query."""
    po, ps = _port(q, tq, corpus, lens, thr)
    jo, js = jax_align.fragment_search(
        jnp.asarray(q), jnp.int32(tq), jnp.asarray(corpus), jnp.asarray(lens),
        hamming_threshold=thr, chunk=chunk)
    ko, ks = fragment_search_pallas(
        jnp.asarray(q), jnp.int32(tq), jnp.asarray(corpus), jnp.asarray(lens),
        hamming_threshold=thr)
    for o, s in ((jo, js), (ko, ks)):
        np.testing.assert_array_equal(ps, np.asarray(s))
        np.testing.assert_array_equal(po, np.asarray(o))
    return po, ps


def _planted(rng, v, t, tq_pad, tq, row, start):
    corpus = rng.integers(0, 2 ** 32, size=(v, t, 2), dtype=np.uint32)
    lens = np.full(v, t, np.int32)
    q = np.full((tq_pad, 2), SENTINEL, np.uint32)
    q[:tq] = corpus[row, start:start + tq]
    return q, corpus, lens


@pytest.mark.parametrize("v,t,tq_pad,tq", [
    (8, 256, 64, 40),
    (16, 128, 128, 100),
    (8, 512, 320, 300),
    (5, 96, 64, 64),
])
def test_fragment_search_matches_jax_and_pallas(rng, v, t, tq_pad, tq):
    q, corpus, lens = _planted(rng, v, t, tq_pad, tq, 2, 10)
    lens[3] = t // 2                       # a short row
    offs, scores = _all_equal(q, tq, corpus, lens, 5, chunk=v if v % 8 else 8)
    assert scores[2] == tq and offs[2] == 10


@pytest.mark.parametrize("thr", [0, 4, 12])
def test_planted_in_short_row_loose_threshold(rng, thr):
    v, t = 8, 256
    corpus = rng.integers(0, 2 ** 32, size=(v, t, 2), dtype=np.uint32)
    lens = np.full(v, t, np.int32)
    lens[5] = 90
    q = np.full((64, 2), SENTINEL, np.uint32)
    frag = corpus[5, 40:80].copy()
    frag[::4, 0] ^= 0b111                  # 3-bit damage every 4th frame
    q[:40] = frag
    offs, scores = _all_equal(q, 40, corpus, lens, thr)
    assert offs[5] == 40 and scores[5] == (40 if thr >= 3 else 30)
    # The invalid tail of row 5 cannot match.
    q2 = np.full((64, 2), SENTINEL, np.uint32)
    q2[:40] = corpus[5, 120:160]
    _o, s = _all_equal(q2, 40, corpus, lens, thr)
    assert s[5] <= 2


def test_no_match_row_is_zero_at_the_first_offset(rng):
    corpus = rng.integers(0, 2 ** 32, size=(8, 128, 2), dtype=np.uint32)
    lens = np.full(8, 128, np.int32)
    lens[2] = 0                            # an empty row
    q = rng.integers(0, 2 ** 32, size=(64, 2), dtype=np.uint32)
    offs, scores = _all_equal(q, 64, corpus, lens, 0)
    assert (scores == 0).all() and (offs == -(64 - 1)).all()


@pytest.mark.parametrize("period", [7, 50])
def test_periodic_row_reports_the_first_of_a_plateau(rng, period):
    """Equal maxima at every period: the first offset wins, as in the
    reference's first-index argmax."""
    v, t = 8, 300
    corpus = rng.integers(0, 2 ** 32, size=(v, t, 2), dtype=np.uint32)
    lens = np.full(v, t, np.int32)
    corpus[3] = np.resize(corpus[3, :period], (t, 2))
    q = np.full((128, 2), SENTINEL, np.uint32)
    q[:100] = corpus[3, 120:220]
    offs, scores = _all_equal(q, 100, corpus, lens, 2)
    assert scores[3] == 100 and offs[3] == 120 % period


@pytest.mark.parametrize("v", [1, 11, 13])
def test_v_not_a_multiple_of_eight(rng, v):
    t = 128
    corpus = rng.integers(0, 2 ** 32, size=(v, t, 2), dtype=np.uint32)
    lens = np.full(v, t, np.int32)
    q = np.full((64, 2), SENTINEL, np.uint32)
    q[:48] = corpus[v - 1, 7:55]           # hit in the LAST row
    offs, scores = _all_equal(q, 48, corpus, lens, 5, chunk=v)
    assert scores.shape == (v,)
    assert scores[v - 1] == 48 and offs[v - 1] == 7


def test_query_longer_than_the_bucket(rng):
    """A query past the bucket's time capacity (/search/video sends every
    frame): negative offsets reach the planted start."""
    v, t = 8, 64
    corpus = rng.integers(0, 2 ** 32, size=(v, t, 2), dtype=np.uint32)
    lens = np.full(v, t, np.int32)
    q = rng.integers(0, 2 ** 32, size=(192, 2), dtype=np.uint32)
    q[100:160] = corpus[4, :60]
    offs, scores = _all_equal(q, 190, corpus, lens, 3)
    assert scores[4] == 60 and offs[4] == -100


def test_batch_rows_equal_single_queries(rng):
    """fragment_search_batch row q == fragment_search of query q ==
    the Pallas batch kernel's row, across mixed query lengths."""
    v, t, tq_pad = 16, 128, 64
    corpus = rng.integers(0, 2 ** 32, size=(v, t, 2), dtype=np.uint32)
    lens = np.full(v, t, np.int32)
    lens[5] = 40
    qs = np.full((3, tq_pad, 2), SENTINEL, np.uint32)
    qlens = np.asarray([48, 20, 64], np.int32)
    plants = [(2, 10), (5, 4), (9, 60)]
    for i, ((tv, ts), ln) in enumerate(zip(plants, qlens)):
        ln = min(int(ln), int(lens[tv]) - ts)
        qlens[i] = ln
        qs[i, :ln] = corpus[tv, ts:ts + ln]
    ob, sb = align.fragment_search_batch(_t(qs), _t(qlens), _t(corpus),
                                         _t(lens), 5)
    ko, ks = fragment_search_pallas_batch(
        jnp.asarray(qs), jnp.asarray(qlens), jnp.asarray(corpus),
        jnp.asarray(lens), hamming_threshold=5)
    np.testing.assert_array_equal(sb.numpy(), np.asarray(ks))
    np.testing.assert_array_equal(ob.numpy(), np.asarray(ko))
    for i, (tv, ts) in enumerate(plants):
        o1, s1 = _port(qs[i], int(qlens[i]), corpus, lens, 5)
        np.testing.assert_array_equal(sb[i].numpy(), s1)
        np.testing.assert_array_equal(ob[i].numpy(), o1)
        assert s1[tv] == qlens[i] and o1[tv] == ts


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_chunking_does_not_change_answers(rng, chunk):
    q, corpus, lens = _planted(rng, 16, 128, 64, 50, 9, 30)
    want = align.fragment_core(_t(q), 50, _t(corpus), _t(lens), 5)
    got = align.fragment_core(_t(q), 50, _t(corpus), _t(lens), 5, chunk=chunk)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("tq,tc", [(40, 100), (1, 7), (9, 3)])
def test_align_scores_and_best_alignment(rng, tq, tc):
    c = rng.integers(0, 2 ** 32, size=(tc, 2), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(tq, 2), dtype=np.uint32)
    k = min(tq, tc) // 2
    q[:k] = c[tc - k:]                     # overlap at offset tc - k
    got = align.align_scores(_t(q), _t(c), 10).numpy()
    want = np.asarray(jax_align.align_scores(jnp.asarray(q), jnp.asarray(c), 10))
    np.testing.assert_array_equal(got, want)
    go, gs = align.best_alignment(_t(q), _t(c), 10)
    jo, js = jax_align.best_alignment(jnp.asarray(q), jnp.asarray(c),
                                      hamming_threshold=10)
    assert (int(go), int(gs)) == (int(jo), int(js))


def test_batch_best_alignment_matches_jax(rng):
    v, t = 6, 80
    corpus = rng.integers(0, 2 ** 32, size=(v, t, 2), dtype=np.uint32)
    lens = np.asarray([80, 50, 0, 80, 30, 79], np.int32)
    corpus[1, 50:] = SENTINEL
    q = corpus[3, 20:52].copy()
    q[::5, 1] ^= np.uint32(0b11)
    go, gs = align.batch_best_alignment(_t(q), _t(corpus), _t(lens), 4)
    jo, js = jax_align.batch_best_alignment(
        jnp.asarray(q), jnp.asarray(corpus), jnp.asarray(lens),
        hamming_threshold=4)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(js))
    np.testing.assert_array_equal(go.numpy(), np.asarray(jo))
    assert int(gs[3]) == 32 and int(go[3]) == 20


def test_diag_scores_counts_beyond_int8(rng):
    """A 300-row all-match matrix: diagonal sums reach 300, which the
    reference's int8 staging could not hold before its widening level."""
    m = torch.ones((300, 310), dtype=torch.bool)
    s = align._diag_scores(m)
    assert s.dtype == torch.int32 and int(s.max()) == 300
    assert s.shape == (300 + 310 - 1,)
    assert [align.fragment_chunk(v) for v in (64, 24, 12, 6, 7)] == [
        16, 8, 4, 2, 1]


def test_wrapper_checks_and_device_rule():
    q = torch.zeros((1, 64, 2), dtype=torch.int32)
    c = torch.zeros((4, 32, 2), dtype=torch.int32)
    ql = torch.tensor([10], dtype=torch.int32)
    ln = torch.full((4,), 32, dtype=torch.int32)
    with pytest.raises(ValueError):
        align.fragment_search_batch(q, ql, c[:, :, :1], ln)
    with pytest.raises(ValueError, match="unsupported device"):
        align.fragment_search_batch(q.to("meta"), ql.to("meta"), c.to("meta"),
                                    ln.to("meta"))
    assert align.K3.replaces.startswith("tvidz_tpu/ops/align_pallas.py:91")
