"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device (a CUDA kernel has no CPU mode). The file
imports no jax, so on a machine without it run:

    TVIDZ_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda -q

(``TVIDZ_TEST_TPU=1`` keeps tests/conftest.py from importing jax.)
Tolerances as in test_torch_fused.py: scores 1e-6, hashes 2 bits per frame,
median/pack and the scan exact.
"""

import numpy as np
import pytest
import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch._reference import synthetic
from tvidz_tpu_torch.ops import align, fused, hamming, phash

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return backend.resolve_device("cuda")


def test_fingerprint_block_kernel_matches_plain(dev):
    luma, _ = synthetic.synthetic_video(2 * 128, 90, 160, cut_frames=(3, 150),
                                        seed=4)
    left, right = phash.hash_operators(90, 160, dev)
    ck = fused.initial_fingerprint_carry(90, 160, dev)
    cp = fused.initial_fingerprint_carry(90, 160, dev)
    before = fused.K1.launches
    for s, vt in ((0, None), (128, 100)):
        x = torch.from_numpy(luma[s:s + 128]).to(dev)
        sk, fk, ck = fused.fingerprint_block(x, ck, left, right, valid_t=vt)
        sp, fp, cp = fused.fingerprint_block_plain(x, cp, left, right, valid_t=vt)
        torch.cuda.synchronize()
        assert (sk - sp).abs().max().item() <= 1e-6
        x_or = phash.words_to_numpy(fk) ^ phash.words_to_numpy(fp)
        assert np.unpackbits(x_or.view(np.uint8), axis=-1).sum(-1).max() <= 2
        assert torch.equal(ck.scene.prev_frame, cp.scene.prev_frame)
        assert abs(ck.scene.prev_mafd.item() - cp.scene.prev_mafd.item()) <= 1e-6
    assert fused.K1.launches == before + 2


def test_median_pack_kernel_is_exact_with_ties(dev):
    low = torch.round(torch.randn(2048, 64, device=dev) * 3)
    low[:8] = 2.0
    assert torch.equal(fused.median_pack_cuda(low),
                       phash.pack_bits_i32(phash.median_threshold_bits(low, 8)))


def test_corpus_scan_kernel_matches_plain(dev):
    rng = np.random.default_rng(6)
    corpus = rng.integers(0, 2 ** 32, size=(70_001, 2), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(40, 2), dtype=np.uint32)
    corpus[-50:] = 0xFFFFFFFF
    corpus[[1023, 1024, 5000]] = q[0]
    q[1] = 0xFFFFFFFF
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    got = hamming.corpus_min_distance(t(q), t(corpus))
    want = hamming.corpus_min_distance_plain(t(q), t(corpus))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2][0]) == 1023 and int(got[2][1]) == 70_001 - 50


@pytest.mark.parametrize("v,tc,tq_pad", [(37, 1024, 320), (9, 256, 1536)])
def test_fragment_search_kernel_matches_plain(dev, v, tc, tq_pad):
    """K3 == the plain version on every (q, v) offset and score: planted
    fragments (one damaged, one in a periodic row whose equal maxima must
    resolve to the first offset), a short and an empty row, a random query
    (its zero rows report -(Tq_pad-1)), V not a multiple of 8, two
    thresholds, a query longer than the bucket; each batch row == its
    single call."""
    rng = np.random.default_rng(9)
    corpus = rng.integers(0, 2 ** 32, size=(v, tc, 2), dtype=np.uint32)
    lens = np.full(v, tc, np.int32)
    lens[4], lens[7] = tc // 2, 0
    corpus[4] = np.resize(corpus[4, :50], (tc, 2))   # period 50: tied maxima
    qs = rng.integers(0, 2 ** 32, size=(3, tq_pad, 2), dtype=np.uint32)
    q_lens = np.asarray([min(tq_pad, tc // 4), min(tq_pad - 1, tc // 2 - 3),
                         tq_pad], np.int32)
    qs[0, :q_lens[0]] = corpus[4, 3:3 + q_lens[0]]
    qs[1, :q_lens[1]] = corpus[v - 1, 3:3 + q_lens[1]]
    qs[1, ::3, 0] ^= np.uint32(0b101)
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32  # noqa: E731
                                   else a).to(dev)
    before = align.K3.launches
    for thr in (0, 6):
        got = align.fragment_search_batch(t(qs), t(q_lens), t(corpus), t(lens), thr)
        want = align.fragment_search_batch_plain(t(qs), t(q_lens), t(corpus),
                                                 t(lens), thr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        one = align.fragment_search(t(qs[1]), int(q_lens[1]), t(corpus),
                                    t(lens), thr)
        assert torch.equal(one[0], got[0][1]) and torch.equal(one[1], got[1][1])
        assert int(got[1][0, 4]) == q_lens[0] and int(got[0][0, 4]) == 3
        assert (got[0][2][got[1][2] == 0] == -(tq_pad - 1)).all()
    assert align.K3.launches == before + 4
