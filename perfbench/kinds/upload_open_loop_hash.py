"""Open-loop uploads to verdict under a DCT pHash that the fused kernel does
not compute (traffic kind ``upload_open_loop_hash``): ``phash256``, or
``phash`` at a ``hash_size`` other than 8.

The same traffic, seams, comparison and control as ``upload_open_loop``,
but for two things:

- the reference hashes every upload and original with
  ``perfbench/reference/dct_hash.py`` at the configuration's own DCT
  geometry (``phash256``: a 64×64 DCT, its low 16×16 block), and the
  control is that hash with TF32 on;
- the span around the dispatcher's ``forward_streams`` pass is
  ``fp_family``, bounded by ``peaks_family.family_bound_s`` (the family
  pass's folded resize and DCT), in place of K1's ``k1``.

Everything else is inherited: the nearest-row scan's ``k4`` span and its
``peaks.scan_bound_s(..., words)`` already take the configuration's words.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from perfbench.load import load_kind
from perfbench.peaks_family import family_bound_s
from perfbench.probes import wrap
from perfbench.reference import dct_hash, video

UploadOpenLoop = load_kind(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "upload_open_loop")

# The (dct, keep) of each named DCT hash (``ops/hashes.py`` of the program,
# README's ``TVIDZ_HASH_ALGO``); ``phash`` takes the configuration's sizes.
DCT_GEOMETRY = {"phash256": (64, 16)}


def dct_geometry(hash_settings) -> Tuple[int, int]:
    """(dct, keep) of a configuration's hash."""
    if hash_settings.algorithm == "phash":
        return hash_settings.dct_size, hash_settings.hash_size
    if hash_settings.algorithm not in DCT_GEOMETRY:
        raise ValueError(f"{hash_settings.algorithm!r} is not a DCT pHash")
    return DCT_GEOMETRY[hash_settings.algorithm]


class UploadOpenLoopHash(UploadOpenLoop):
    """Open-loop uploads to verdict under a family DCT pHash (module note)."""

    # The steps this kind shares with ``upload_open_loop``, stated here as
    # every kind states its own.
    setup = UploadOpenLoop.setup
    run_window = UploadOpenLoop.run_window
    drain = UploadOpenLoop.drain
    verify = UploadOpenLoop.verify

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dct, self.keep = dct_geometry(self.cfg.hash)

    def instrument(self) -> None:
        super().instrument()
        model, rec = self.dep.app.analyzer._model, self.rec
        h, w = self.cfg.pipeline.scene_height, self.cfg.pipeline.scene_width
        keep = self.keep
        # Drop the parent's ``k1`` span: back to the program's own method.
        vars(model).pop("forward_streams", None)

        def forward_streams(orig):
            def f(lumas, carries, valid_ts):
                with rec.span("fp_family",
                              bound_s=family_bound_s(valid_ts, h, w, keep)):
                    return orig(lumas, carries, valid_ts)
            return f

        wrap(model, "forward_streams", forward_streams)

    def control_hooks(self) -> list:
        """The reference's hash of each block at the configuration's
        geometry, computed with TF32 on (one step below the float32 the
        configuration states), returned in place of the hashes the family
        pass made; scores and carries are the program's."""
        dct, keep = self.dct, self.keep

        def hook(kind):
            def make(orig):
                def f(lumas, carries, valid_ts):
                    scores, fps, new = orig(lumas, carries, valid_ts)
                    ref = np.stack([dct_hash.phash(x, dct, keep, tf32=True)
                                    for x in lumas])
                    ref = torch.from_numpy(ref.view(np.int32)).to(fps.device)
                    return scores, ref.reshape(fps.shape).to(fps.dtype), new
                return f
            wrap(kind.dep.app.analyzer._model, "forward_streams", make)
        return [hook]

    def reference_frames(self, item: dict, tag) -> Tuple[np.ndarray, List[int]]:
        """(T, words) reference hashes and cut frames of an upload's pixels."""
        s = self.cfg.pipeline
        full = self.luma(item, tag)
        hashes = dct_hash.phash(
            video.downscale(full, s.scene_height, s.scene_width), self.dct,
            self.keep)
        cuts = video.cut_frames(video.mafd(full), self.cfg.scene.threshold)
        return hashes, cuts


KIND = UploadOpenLoopHash
