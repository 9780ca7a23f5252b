"""Port parity: the packed-Hamming corpus scan.

The port's plain scan (what the corpus-scan kernel is checked against on
the card) against the JAX package's Pallas scans in interpret mode — the
XOR+popcount ``corpus_min_distance_t`` and the TPU production
``corpus_min_distance_t_mxu_twophase`` — on the same seeded corpus with
planted exact hits, equal-distance ties (first index wins) and all-ones
sentinel rows. All three outputs must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.ops import golden
from tvidz_tpu.ops.hamming import (
    corpus_min_distance_t,
    corpus_min_distance_t_mxu_twophase,
)
from tvidz_tpu_torch.ops import hamming

M, BLOCK_N, BLOCKS = 16, 256, 4
N = BLOCK_N * BLOCKS


def _scan_inputs():
    rng = np.random.default_rng(21)
    corpus = rng.integers(0, 2 ** 32, size=(N, 2), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(M, 2), dtype=np.uint32)
    corpus[-100:] = 0xFFFFFFFF                   # sentinel padding rows
    corpus[[40, 700]] = q[1]                     # exact hit, tied later
    corpus[[BLOCK_N - 1, BLOCK_N]] = q[2]        # tie across a block edge
    flip = q[3].copy()
    flip[1] ^= np.uint32(0b111)
    corpus[[300, 301, 600]] = flip               # distance-3 ties
    q[4] = 0xFFFFFFFF                            # nearest rows are sentinels
    q[5] = q[1]                                  # duplicate query rows
    return q, corpus


def _port(q, corpus):
    t = lambda a: torch.from_numpy(a.view(np.int32))  # noqa: E731
    f, m, a = hamming.corpus_min_distance(t(q), t(corpus))
    return f.numpy(), m.numpy(), a.numpy()


@pytest.mark.parametrize("reference", [corpus_min_distance_t,
                                       corpus_min_distance_t_mxu_twophase],
                         ids=["xor_popcount", "mxu_twophase"])
def test_scan_matches_pallas_interpret(reference):
    q, corpus = _scan_inputs()
    want = reference(jnp.asarray(q), jnp.asarray(np.ascontiguousarray(corpus.T)),
                     block_n=BLOCK_N)
    got = _port(q, corpus)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[1][1] == 0 and got[2][1] == 40
    assert got[2][2] == BLOCK_N - 1
    assert got[1][3] == 3 and got[2][3] == 300
    assert got[1][4] == 0 and got[2][4] == N - 100


def test_scan_blocks_keep_the_first_tie():
    """The plain scan's corpus blocks: a tie in a later block never moves
    the argmin (also across the block boundary of the plain loop)."""
    q, corpus = _scan_inputs()
    t = lambda a: torch.from_numpy(a.view(np.int32))  # noqa: E731
    old = hamming._PLAIN_PAIRS
    hamming._PLAIN_PAIRS = M * 64                   # 64-row blocks
    try:
        small = hamming.corpus_min_distance_plain(t(q), t(corpus))
    finally:
        hamming._PLAIN_PAIRS = old
    for g, w in zip(small, _port(q, corpus)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_query_nearest_and_frame_min_halves():
    q, corpus = _scan_inputs()
    t = lambda a: torch.from_numpy(a.view(np.int32))  # noqa: E731
    f, m, a = _port(q, corpus)
    qm, qa = hamming.corpus_query_nearest(t(q), t(corpus))
    np.testing.assert_array_equal(qm.numpy(), m)
    np.testing.assert_array_equal(qa.numpy(), a)
    np.testing.assert_array_equal(hamming.corpus_frame_min(t(q), t(corpus)).numpy(), f)


def test_hamming_matrix_matches_golden():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 2 ** 32, size=(7, 2), dtype=np.uint32)
    c = rng.integers(0, 2 ** 32, size=(33, 2), dtype=np.uint32)
    got = hamming.hamming_matrix(torch.from_numpy(q.view(np.int32)),
                                 torch.from_numpy(c.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), golden.hamming_matrix(q, c))


def test_scan_rejects_bad_inputs():
    z = torch.zeros((0, 2), dtype=torch.int32)
    one = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        hamming.corpus_min_distance(z, one)
    with pytest.raises(ValueError):
        hamming.corpus_min_distance(one, torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        hamming.corpus_min_distance(one.to("meta"), one.to("meta"))
