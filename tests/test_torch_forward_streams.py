"""Port parity: ``FingerprintModel.forward_streams`` (the dispatcher's pass).

K independent streams' blocks, chained over two rounds with per-stream
carries and a short final block, go through the JAX package's
``fingerprint_blocks_batched`` and the port's ``forward_streams`` (plain
versions on the CPU), with tests/test_torch_fused.py's tolerances against
the JAX op: scores 1e-6 (the float32 mean runs in another order), hashes 2
bits per frame, carry frames exact. Stream k must equal a lone ``forward``
of it bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.ops.fused import fingerprint_blocks_batched
from tvidz_tpu.ops.fused import initial_fingerprint_carry as jax_initial_carry
from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.decode import synthetic
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.ops import phash

T, H, W = 16, 36, 64
SCORE_TOL = 1e-6
HASH_BITS = 2


def _model() -> FingerprintModel:
    cfg = Config()
    cfg.pipeline.block_frames = T
    cfg.pipeline.scene_height = H
    cfg.pipeline.scene_width = W
    return FingerprintModel(cfg, device="cpu")


def _streams(k: int):
    """k streams of 2 blocks each; the last stream's second block is short
    (padded with its last frame, valid_t < T)."""
    out = []
    for s in range(k):
        luma, _ = synthetic.synthetic_video(2 * T, H, W, cut_frames=(5 + s, 20),
                                            seed=30 + s)
        if s % 2:
            luma = np.random.default_rng(s).integers(0, 256, size=luma.shape,
                                                     dtype=np.uint8)
        out.append(luma)
    valid = [[T, T] for _ in range(k)]
    valid[-1][1] = T - 5
    for s in range(k):
        v = valid[s][1]
        out[s][T + v:] = out[s][T + v - 1]
    return out, valid


@pytest.mark.parametrize("k", [1, 2, 4])
def test_forward_streams_matches_jax_batched(k):
    model = _model()
    streams, valid = _streams(k)
    tc = [model.init_carry() for _ in range(k)]
    jc = tuple(jax_initial_carry(H, W) for _ in range(k))
    for r in range(2):
        blocks = [s[r * T:(r + 1) * T] for s in streams]
        vts = [v[r] for v in valid]
        ts, tf, tc = model.forward_streams(
            [torch.from_numpy(b) for b in blocks], tc, vts)
        js, jf, jc = fingerprint_blocks_batched(
            jnp.asarray(np.stack(blocks)), jc, jnp.asarray(vts, jnp.int32))
        assert ts.shape == (k, T) and tf.shape == (k, T, 2)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=SCORE_TOL)
        x = phash.words_to_numpy(tf) ^ np.asarray(jf, np.uint32)
        assert np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).max() <= HASH_BITS
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a.scene.prev_frame.numpy(),
                                          np.asarray(b.scene.prev_frame))
            assert abs(a.scene.prev_mafd.item()
                       - float(b.scene.prev_mafd)) <= SCORE_TOL


def test_stream_equals_a_lone_forward():
    model = _model()
    streams, valid = _streams(3)
    carries = [model.init_carry() for _ in range(3)]
    lone = [model.init_carry() for _ in range(3)]
    for r in range(2):
        blocks = [torch.from_numpy(s[r * T:(r + 1) * T]) for s in streams]
        ts, tf, carries = model.forward_streams(blocks, carries,
                                                [v[r] for v in valid])
        for j in range(3):
            s1, f1, lone[j] = model.forward(blocks[j], lone[j],
                                            valid_t=valid[j][r])
            assert torch.equal(ts[j], s1) and torch.equal(tf[j], f1)
            assert torch.equal(carries[j].scene.prev_frame,
                               lone[j].scene.prev_frame)


def test_example_payload_is_the_dispatch_shape():
    model = _model()
    p = model.example_payload()
    assert p.shape == (T, H, W) and p.dtype == torch.uint8
    assert p.device.type == "cpu"


def test_forward_streams_mixed_carries_and_valid_t_match_jax_batched():
    """One pass over four streams at different points: a fresh one, two
    mid-stream (carried from a full and from a short block) and one whose
    block holds a single real frame; against the JAX batched op."""
    model = _model()
    k = 4
    streams, _ = _streams(k)
    first = [T, T - 3, T, T]          # round 0 leaves stream 1 on a short block
    second = [T - 7, 1, T, 5]
    tc = [model.init_carry() for _ in range(k)]
    jc = [jax_initial_carry(H, W) for _ in range(k)]
    blocks0 = [s[:T] for s in streams]
    _, _, tc0 = model.forward_streams([torch.from_numpy(b) for b in blocks0], tc, first)
    _, _, jc0 = fingerprint_blocks_batched(jnp.asarray(np.stack(blocks0)), tuple(jc),
                                           jnp.asarray(first, jnp.int32))
    tc = [model.init_carry(), *tc0[1:]]
    jc = (jax_initial_carry(H, W), *jc0[1:])
    blocks1 = [s[T:2 * T] for s in streams]
    ts, tf, tcn = model.forward_streams([torch.from_numpy(b) for b in blocks1], tc,
                                        second)
    js, jf, jcn = fingerprint_blocks_batched(jnp.asarray(np.stack(blocks1)), jc,
                                             jnp.asarray(second, jnp.int32))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=SCORE_TOL)
    x = phash.words_to_numpy(tf) ^ np.asarray(jf, np.uint32)
    assert np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).max() <= HASH_BITS
    for a, b in zip(tcn, jcn):
        np.testing.assert_array_equal(a.scene.prev_frame.numpy(),
                                      np.asarray(b.scene.prev_frame))
        # The carried mafd is unscaled (up to 255): XLA's mean and the
        # port's exact division of the same integer sum may differ by one
        # float32 ulp, 2^-23 relative.
        np.testing.assert_allclose(a.scene.prev_mafd.numpy(),
                                   np.asarray(b.scene.prev_mafd), rtol=2 ** -23,
                                   atol=0)
        assert bool(a.scene.has_prev) and bool(b.scene.has_prev)
