"""Per-video analysis checkpoints.

Port of ``tvidz_tpu/pipeline/checkpoint.py`` with a byte-identical blob: a
little-endian u32 length, a JSON header, the (frames, words) uint32
fingerprints and the (H, W) float32 carry frame. A checkpoint written by
either package resumes in the other. Only the carry's capture and restore
touch torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import struct
from typing import List, Optional

import numpy as np
import torch

from tvidz_tpu_torch.ops.fused import FingerprintCarry
from tvidz_tpu_torch.ops.scene import SceneCarry


def content_signature(path: str) -> str:
    """Cheap identity for a downloaded file: size + head/middle/tail sample
    hash (the middle sample tells apart recordings that share a container
    preamble and trailer)."""
    size = os.path.getsize(path)
    h = hashlib.sha256()
    h.update(str(size).encode())
    with open(path, "rb") as f:
        h.update(f.read(65536))
        if size > 131072:
            f.seek(size // 2)
            h.update(f.read(65536))
        if size > 65536:
            f.seek(-min(65536, size), os.SEEK_END)
            h.update(f.read(65536))
    return h.hexdigest()[:32]


@dataclasses.dataclass
class AnalysisCheckpoint:
    content_sig: str
    frames_done: int
    scene_cuts: List[float]
    fingerprints: np.ndarray          # (frames_done, words) uint32
    carry_prev_frame: np.ndarray      # (H, W) float32
    carry_prev_mafd: float
    carry_has_prev: bool
    # Video row id of the attempt that WROTE this checkpoint (a resume
    # under a new id supersedes it); None in pre-field blobs.
    video_id: Optional[int] = None

    def to_blob(self) -> bytes:
        buf = io.BytesIO()
        meta = {
            "content_sig": self.content_sig,
            "frames_done": self.frames_done,
            "scene_cuts": self.scene_cuts,
            "fp_shape": list(self.fingerprints.shape),
            "frame_shape": list(self.carry_prev_frame.shape),
            "prev_mafd": float(self.carry_prev_mafd),
            "has_prev": bool(self.carry_has_prev),
            "video_id": self.video_id,
        }
        mb = json.dumps(meta).encode()
        buf.write(struct.pack("<I", len(mb)))
        buf.write(mb)
        buf.write(np.ascontiguousarray(self.fingerprints, np.uint32).tobytes())
        buf.write(np.ascontiguousarray(self.carry_prev_frame, np.float32).tobytes())
        return buf.getvalue()

    @classmethod
    def from_blob(cls, blob: bytes) -> "AnalysisCheckpoint":
        (mlen,) = struct.unpack_from("<I", blob, 0)
        meta = json.loads(blob[4 : 4 + mlen].decode())
        off = 4 + mlen
        fp_shape = tuple(meta["fp_shape"])
        fp_n = int(np.prod(fp_shape)) if fp_shape else 0
        fp = np.frombuffer(blob, np.uint32, count=fp_n, offset=off).reshape(fp_shape).copy()
        off += fp_n * 4
        fr_shape = tuple(meta["frame_shape"])
        fr_n = int(np.prod(fr_shape))
        frame = np.frombuffer(blob, np.float32, count=fr_n, offset=off).reshape(fr_shape).copy()
        return cls(
            content_sig=meta["content_sig"],
            frames_done=int(meta["frames_done"]),
            scene_cuts=[float(x) for x in meta["scene_cuts"]],
            fingerprints=fp,
            carry_prev_frame=frame,
            carry_prev_mafd=float(meta["prev_mafd"]),
            carry_has_prev=bool(meta["has_prev"]),
            video_id=meta.get("video_id"),
        )

    def restore_carry(self, device: torch.device) -> FingerprintCarry:
        return FingerprintCarry(scene=SceneCarry(
            prev_frame=torch.tensor(self.carry_prev_frame, dtype=torch.float32,
                                    device=device),
            prev_mafd=torch.tensor(self.carry_prev_mafd, dtype=torch.float32,
                                   device=device),
            has_prev=torch.tensor(self.carry_has_prev, dtype=torch.bool,
                                  device=device),
        ))

    @classmethod
    def capture(
        cls,
        content_sig: str,
        frames_done: int,
        scene_cuts: List[float],
        fingerprints: List[np.ndarray],
        carry: FingerprintCarry,
        video_id: Optional[int] = None,
    ) -> "AnalysisCheckpoint":
        fp = (
            np.concatenate(fingerprints)
            if fingerprints
            else np.zeros((0, 2), np.uint32)
        )
        sc = carry.scene
        return cls(
            content_sig=content_sig,
            frames_done=frames_done,
            scene_cuts=list(scene_cuts),
            fingerprints=fp,
            carry_prev_frame=sc.prev_frame.detach().cpu().numpy().astype(
                np.float32, copy=False),
            carry_prev_mafd=float(sc.prev_mafd.item()),
            carry_has_prev=bool(sc.has_prev.item()),
            video_id=video_id,
        )
