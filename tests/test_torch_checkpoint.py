"""Port parity: analysis checkpoints are byte-identical across packages, so
a checkpoint written by either package resumes in the other."""

import numpy as np
import pytest
import torch

from tvidz_tpu.ops.fused import FingerprintCarry as JaxCarry
from tvidz_tpu.ops.scene import SceneCarry as JaxScene
from tvidz_tpu.pipeline.checkpoint import AnalysisCheckpoint as JaxCheckpoint
from tvidz_tpu.pipeline.checkpoint import content_signature as jax_signature
from tvidz_tpu_torch import state
from tvidz_tpu_torch.pipeline.checkpoint import AnalysisCheckpoint, content_signature

CPU = torch.device("cpu")


def _inputs():
    rng = np.random.default_rng(12)
    fps = [rng.integers(0, 2 ** 32, size=(16, 2), dtype=np.uint32)
           for _ in range(3)]
    frame = rng.integers(0, 256, size=(9, 16)).astype(np.float32)
    return fps, frame, 7.25


@pytest.mark.parametrize("video_id", [None, 42])
def test_blobs_are_byte_identical(video_id):
    fps, frame, mafd = _inputs()
    jax_carry = JaxCarry(scene=JaxScene(frame, np.float32(mafd), np.bool_(True)))
    port_carry = state.fingerprint_carry_from_numpy(frame, mafd, True, CPU)
    args = ("sig", 48, [0.4, 1.2])
    jb = JaxCheckpoint.capture(*args, fps, jax_carry, video_id=video_id).to_blob()
    tb = AnalysisCheckpoint.capture(*args, fps, port_carry,
                                    video_id=video_id).to_blob()
    assert jb == tb


def test_jax_blob_resumes_in_the_port_and_back():
    fps, frame, mafd = _inputs()
    jax_carry = JaxCarry(scene=JaxScene(frame, np.float32(mafd), np.bool_(True)))
    blob = JaxCheckpoint.capture("sig", 48, [0.4], fps, jax_carry,
                                 video_id=3).to_blob()
    ck = AnalysisCheckpoint.from_blob(blob)
    carry = ck.restore_carry(CPU)
    np.testing.assert_array_equal(carry.scene.prev_frame.numpy(), frame)
    assert carry.scene.prev_mafd.item() == mafd and bool(carry.scene.has_prev)
    np.testing.assert_array_equal(ck.fingerprints, np.concatenate(fps))
    assert (ck.frames_done, ck.scene_cuts, ck.video_id) == (48, [0.4], 3)

    back = JaxCheckpoint.from_blob(
        AnalysisCheckpoint.capture("sig", 48, [0.4], [ck.fingerprints], carry,
                                   video_id=3).to_blob())
    jc = back.restore_carry()
    np.testing.assert_array_equal(np.asarray(jc.scene.prev_frame), frame)
    assert float(jc.scene.prev_mafd) == mafd and bool(jc.scene.has_prev)
    np.testing.assert_array_equal(back.fingerprints, np.concatenate(fps))


def test_content_signature_matches(tmp_path):
    path = tmp_path / "clip.bin"
    path.write_bytes(np.random.default_rng(1).bytes(300_000))
    assert content_signature(str(path)) == jax_signature(str(path))
