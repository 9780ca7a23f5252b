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
from tvidz_tpu_torch.ops import fused, hamming, phash

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
