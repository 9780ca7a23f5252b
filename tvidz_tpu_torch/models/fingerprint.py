"""The streaming video-fingerprinting model, on PyTorch.

Port of ``tvidz_tpu/models/fingerprint.py``. ``FingerprintModel.forward``
maps a (T, H, W) luma block and a carry to (scene scores, packed pHash,
new carry) through ``ops/fused.fingerprint_block`` (kernel K1 on CUDA).
``process_block`` is the one per-block path every surface shares: pad a
short block with its last frame and pass ``valid_t``, score through the
``NativeSceneScorer`` policy, cut at the threshold with 6-decimal rounding.
With a ``SharedBlockDispatcher`` attached (the service does), its device
step goes through the dispatcher's batched ``forward_streams`` pass instead.

Not ported yet (ROADMAP queue A): the coefficient-shipping payload
(``ship_dct_coeffs``), the other hash families and ``forward_batch``.
"""

from __future__ import annotations

import types
from typing import List, Optional, Tuple

import numpy as np
import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.decode import get_decoder
from tvidz_tpu_torch.ops.fused import (
    FingerprintCarry,
    fingerprint_block,
    fingerprint_blocks_batched,
    initial_fingerprint_carry,
)
from tvidz_tpu_torch.ops.phash import hash_operators, words_to_numpy
from tvidz_tpu_torch.ops.scene import NativeSceneScorer

_LATER = "not ported yet (ROADMAP.md queue A, item 3)"


class FingerprintModel:
    """Config-bound streaming fingerprint model on one device.

    forward(luma_block, carry) -> (scores, fingerprints, carry')
      luma_block:   (T, H, W) uint8 luma at the model's scene geometry
      scores:       (T,) float32 FFmpeg-parity scene scores
      fingerprints: (T, words) int32 bit-views of the packed pHash words
    """

    def __init__(self, config: Optional[Config] = None, device=None):
        self.config = config or Config()
        self.device = backend.resolve_device(device)
        p = self.config.pipeline
        self.block_frames = p.block_frames
        self.height = p.scene_height
        self.width = p.scene_width
        self.dct_size = self.config.hash.dct_size
        self.hash_size = self.config.hash.hash_size
        self.algorithm = self.config.hash.algorithm
        if self.algorithm != "phash":
            raise NotImplementedError(
                f"hash algorithm {self.algorithm!r}: {_LATER}")
        if getattr(p, "ship_dct_coeffs", False):
            raise NotImplementedError(f"ship_dct_coeffs: {_LATER}")
        self.ship_coeffs = False
        # Optional SharedBlockDispatcher (pipeline/dispatcher.py): when set,
        # process_block's device step rides its shared batched pass.
        self.dispatcher = None
        self.left, self.right = hash_operators(
            self.height, self.width, self.device, self.dct_size,
            self.hash_size)

    # -- single-stream API ----------------------------------------------------

    def init_carry(self) -> FingerprintCarry:
        return initial_fingerprint_carry(self.height, self.width, self.device)

    def forward(self, luma_block: torch.Tensor, carry: FingerprintCarry,
                valid_t: Optional[int] = None):
        return fingerprint_block(luma_block, carry, self.left, self.right,
                                 valid_t=valid_t)

    def example_inputs(self) -> Tuple[torch.Tensor, FingerprintCarry]:
        luma = torch.zeros((self.block_frames, self.height, self.width),
                           dtype=torch.uint8, device=self.device)
        return luma, self.init_carry()

    def forward_batch(self, clips):
        raise NotImplementedError(f"forward_batch: {_LATER}")

    def forward_streams(self, lumas, carries, valid_ts):
        """K independent streams' (T, H, W) blocks in one pass: ((K, T)
        scores, (K, T, words) int32 fps, tuple of K carries), through
        ``fingerprint_blocks_batched`` (one K1 launch on CUDA), so stream
        k's results equal a lone ``forward`` of it bit for bit.
        ``valid_ts``: each block's real frame count (T for a full block)."""
        return fingerprint_blocks_batched(lumas, carries, valid_ts, self.left,
                                          self.right)

    def example_payload(self) -> torch.Tensor:
        """A zero (T, H, W) uint8 block at the model's dispatch shape (warm
        passes use it)."""
        return torch.zeros((self.block_frames, self.height, self.width),
                           dtype=torch.uint8, device=self.device)

    def process_block(self, block, carry, scorer, last_cut=None):
        """Pad a short block to the static shape (carry kept on the last
        REAL frame via valid_t), run the fused op, score through the given
        NativeSceneScorer policy, slice fps to the real frame count, and
        extract cut timestamps.

        block needs .luma (t, H, W), .pts (t,), .mafd (optional).
        Returns (fps (t, W) np.uint32, new_carry, new_cuts, t)."""
        t = block.luma.shape[0]
        if t == 0:
            return (np.zeros((0, self.config.hash.words), np.uint32),
                    carry, [], 0)
        bt = self.block_frames
        buf = np.asarray(block.luma)
        if t < bt:
            buf = np.concatenate([buf, np.repeat(buf[-1:], bt - t, axis=0)])
        if self.dispatcher is not None:
            # Shared batched dispatch (pipeline/dispatcher.py): concurrent
            # analyses' blocks ride one pass; the future blocks this thread
            # where the direct forward would have.
            scores_h, fps_h, carry = self.dispatcher.submit(
                buf, carry, t).result()
            scores = scorer.scores(block, scores_h, t)
            fps = fps_h[:t]
        else:
            luma = torch.from_numpy(np.ascontiguousarray(buf)).to(self.device)
            scores_dev, fps_dev, carry = self.forward(
                luma, carry, valid_t=t if t < bt else None)
            scores = scorer.scores(block, scores_dev, t)
            fps = words_to_numpy(fps_dev[:t])
        cuts = self.extract_cuts(scores, block.pts, t, last_cut)
        return fps, carry, cuts, t

    def extract_cuts(self, scores, pts, t: int, last_cut=None) -> List[float]:
        """The one cut-timestamp policy: threshold, 6-decimal rounding,
        consecutive dedupe honoring config."""
        cuts: List[float] = []
        dedupe = self.config.scene.dedupe_consecutive
        thr = self.config.scene.threshold
        for i in np.nonzero(scores[:t] > thr)[0]:
            ts = round(float(pts[i]), 6)
            prev = cuts[-1] if cuts else last_cut
            if not dedupe or prev is None or ts != prev:
                cuts.append(ts)
        return cuts

    # -- whole-stream convenience ---------------------------------------------

    def _stream(self, blocks, scorer) -> Tuple[List[float], np.ndarray]:
        carry = self.init_carry()
        cuts: List[float] = []
        fps_out: List[np.ndarray] = []
        for block in blocks:
            fps, carry, new_cuts, _t = self.process_block(
                block, carry, scorer, last_cut=cuts[-1] if cuts else None)
            fps_out.append(fps)
            cuts.extend(new_cuts)
        words = self.config.hash.words
        return cuts, (np.concatenate(fps_out) if fps_out
                      else np.zeros((0, words), np.uint32))

    def analyze_path(self, path: str) -> Tuple[List[float], np.ndarray]:
        """Stream a video file block by block: (cut timestamps, packed fps).
        Only the 8-byte-per-frame fingerprints accumulate."""
        decoder = get_decoder(
            path, lowres=self.config.pipeline.decode_lowres,
            dct_dc=self.config.pipeline.decode_dct_dc)
        scorer = NativeSceneScorer(self.config.scene.native_resolution)
        return self._stream(
            decoder.blocks(path, self.block_frames, self.height, self.width),
            scorer)

    def analyze_array(self, luma: np.ndarray, pts: np.ndarray
                      ) -> Tuple[List[float], np.ndarray]:
        """Host-streamed analysis of (T, H, W) luma: (cut timestamps, fps).
        Arrays carry no decoder mafd, so the device scores decide cuts."""
        bt = self.block_frames
        blocks = (types.SimpleNamespace(luma=luma[s:s + bt],
                                        pts=pts[s:s + bt], mafd=None)
                  for s in range(0, luma.shape[0], bt))
        return self._stream(blocks, NativeSceneScorer(False))
