"""Port parity: ``FingerprintModel.forward_batch`` (B independent clips).

Mirrors tests/test_forward_batch.py on the port, and holds the port's
batched pass against the reference's ``_forward_batch_impl`` on the same
seeded numpy clips. For the 64-bit pHash the port's pass is K1's: B
segments each starting from the initial carry (one launch per 64 clips on
CUDA; its plain version here). The reference zeroes frame 0's mafd and
score; the initial carry does the same, so the two agree. Tolerances: scores
1e-6 (float32 means in another order), hashes equal (the plain version's
float32 products, as tests/test_torch_forward_streams.py), every other
family's hashes equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.config import Config as JaxConfig
from tvidz_tpu.models.fingerprint import FingerprintModel as JaxModel
from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.ops import golden

SCORE_TOL = 1e-6


def _cfg(cls=Config, t=32, h=48, w=64):
    cfg = cls()
    cfg.pipeline.block_frames = t
    cfg.pipeline.scene_height = h
    cfg.pipeline.scene_width = w
    return cfg


def _clips(b, t, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, t, h, w),
                                                dtype=np.uint8)


@pytest.mark.parametrize("algo", ["phash", "ahash", "dhash", "phash256"])
def test_forward_batch_matches_reference(algo):
    clips = _clips(3, 32, 48, 64, seed=1)
    model = FingerprintModel(_cfg(), device="cpu")
    ref = JaxModel(_cfg(JaxConfig))
    model.algorithm = ref.algorithm = algo
    scores, fps = model.forward_batch(torch.from_numpy(clips))
    want_s, want_f = ref.forward_batch(jnp.asarray(clips))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s), atol=SCORE_TOL)
    np.testing.assert_array_equal(fps.numpy().view(np.uint32), np.asarray(want_f))
    assert (scores[:, 0] == 0).all()                 # frame 0 of every clip


def test_forward_batch_matches_streaming():
    """Each clip equals a lone forward from a fresh carry, and golden."""
    model = FingerprintModel(_cfg(), device="cpu")
    clips = _clips(3, 32, 48, 64)
    scores_b, fps_b = model.forward_batch(clips)
    for i in range(3):
        s, f, _ = model.forward(torch.from_numpy(clips[i]), model.init_carry())
        np.testing.assert_allclose(scores_b[i].numpy(), s.numpy(), atol=1e-5)
        assert torch.equal(fps_b[i], f)
        np.testing.assert_allclose(s.numpy(), golden.scene_scores(clips[i]),
                                   atol=1e-5)


def test_forward_batch_not_stale_after_attribute_change():
    """forward_batch reads the model's current hash parameters."""
    clips = _clips(2, 8, 24, 32, seed=2)
    m = FingerprintModel(Config(), device="cpu")
    _, fps_phash = m.forward_batch(clips)
    m.algorithm = "ahash"
    _, fps_ahash = m.forward_batch(clips)
    fresh = FingerprintModel(Config(), device="cpu")
    fresh.algorithm = "ahash"
    _, fps_fresh = fresh.forward_batch(clips)
    assert torch.equal(fps_ahash, fps_fresh)
    assert not torch.equal(fps_ahash, fps_phash)


def test_forward_batch_clip_count_past_one_launch():
    """More clips than one K1 launch's 64 segments: the chunks join in
    order (the plain version here; on the card, two launches)."""
    clips = _clips(67, 4, 16, 32, seed=3)
    model = FingerprintModel(_cfg(t=4, h=16, w=32), device="cpu")
    scores, fps = model.forward_batch(clips)
    assert scores.shape == (67, 4) and fps.shape == (67, 4, 2)
    s, f, _ = model.forward(torch.from_numpy(clips[66]), model.init_carry())
    assert torch.equal(fps[66], f) and torch.allclose(scores[66], s)


def test_empty_inputs_are_clean_noops():
    m = FingerprintModel(Config(), device="cpu")
    cuts, fps = m.analyze_array(np.zeros((0, 24, 32), np.uint8),
                                np.zeros(0, np.float32))
    assert cuts == [] and fps.shape == (0, m.config.hash.words)
    with pytest.raises(ValueError, match="clips must be"):
        m.forward_batch(np.zeros((0, 4, 24, 32), np.uint8))
