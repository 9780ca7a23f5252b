"""The streaming video-fingerprinting model, on PyTorch.

Port of ``tvidz_tpu/models/fingerprint.py``. ``FingerprintModel.forward``
maps a (T, H, W) luma block and a carry to (scene scores, packed hashes,
new carry) through ``ops/fused.fingerprint_block``: kernel K1 on CUDA for
the 64-bit DCT pHash (the default), and for every other configuration of
``Config.hash`` (``ahash``, ``dhash``, ``phash256``, ``phash`` at another
``hash_size``) the family's plain-torch composition, as the reference
computes those in XLA. The word count follows the configuration
(``config.hash.words``: 8 for phash256).
``process_block`` is the one per-block path every surface shares: pad a
short block with its last frame and pass ``valid_t``, score through the
``NativeSceneScorer`` policy, cut at the threshold with 6-decimal rounding.
With a ``SharedBlockDispatcher`` attached (the service does), its device
step goes through the dispatcher's batched ``forward_streams`` pass instead.

Under ``PipelineConfig.ship_dct_coeffs`` (``TVIDZ_SHIP_DCT_COEFFS=1``, the
64-bit or any-size DCT pHash only) the device payload is the host-projected
(T, hash²) float32 coefficients (``project_payload``, bit-exact to golden)
and the device runs only the median threshold and pack; scene scores then
come from the host (``NativeSceneScorer`` with ``host_mafd_fallback``).
``forward_batch`` fingerprints B independent clips in one pass (one K1
launch per 64 clips for the 64-bit pHash on CUDA).
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
    fingerprint_block_coeffs,
    fingerprint_blocks_batched,
    fingerprint_blocks_batched_coeffs,
    initial_fingerprint_carry,
    uses_k1,
)
from tvidz_tpu_torch.ops.phash import (
    hash_operators,
    phash_project_host,
    words_to_numpy,
)
from tvidz_tpu_torch.ops.scene import NativeSceneScorer


class FingerprintModel:
    """Config-bound streaming fingerprint model on one device.

    forward(luma_block, carry) -> (scores, fingerprints, carry')
      luma_block:   (T, H, W) uint8 luma at the model's scene geometry
      scores:       (T,) float32 FFmpeg-parity scene scores
      fingerprints: (T, words) int32 bit-views of the packed hash words
                    (words = config.hash.words)
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
        self.words = self.config.hash.words
        # Ship the sufficient statistic (tvidz_tpu/models/fingerprint.py:45):
        # the host projects each frame to its low DCT coefficients and the
        # device finishes the hash; scores come from the host.
        self.ship_coeffs = bool(getattr(p, "ship_dct_coeffs", False))
        if self.ship_coeffs and self.algorithm != "phash":
            raise ValueError(
                "ship_dct_coeffs is a phash-specific projection; "
                f"algorithm={self.algorithm!r} must ship luma blocks")
        # Optional SharedBlockDispatcher (pipeline/dispatcher.py): when set,
        # process_block's device step rides its shared batched pass.
        self.dispatcher = None
        # K1's operators (the 64-bit pHash); other families build their own.
        self.k1 = uses_k1(self.algorithm, self.hash_size)
        self.left, self.right = (hash_operators(
            self.height, self.width, self.device, self.dct_size,
            self.hash_size) if self.k1 else (None, None))
        self._family = dict(algorithm=self.algorithm, dct_size=self.dct_size,
                            hash_size=self.hash_size)

    # -- single-stream API ----------------------------------------------------

    def init_carry(self) -> FingerprintCarry:
        return initial_fingerprint_carry(self.height, self.width, self.device)

    def forward(self, luma_block: torch.Tensor, carry: FingerprintCarry,
                valid_t: Optional[int] = None):
        if self.ship_coeffs:
            # The (T, hash²) coefficient block (``project_payload``): zero
            # scores, the carry passes through.
            return fingerprint_block_coeffs(luma_block, carry, self.hash_size)
        return fingerprint_block(luma_block, carry, self.left, self.right,
                                 valid_t=valid_t, **self._family)

    def project_payload(self, luma: np.ndarray) -> np.ndarray:
        """The device payload of a (t, H, W) luma block, on the host: the
        projected (t, hash²) float32 coefficients under ship_coeffs, the
        luma itself otherwise. Runs on the decoding thread."""
        if not self.ship_coeffs:
            return luma
        return phash_project_host(luma, dct_size=self.dct_size,
                                  hash_size=self.hash_size)

    def example_inputs(self) -> Tuple[torch.Tensor, FingerprintCarry]:
        luma = torch.zeros((self.block_frames, self.height, self.width),
                           dtype=torch.uint8, device=self.device)
        return luma, self.init_carry()

    def forward_batch(self, clips) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, H, W) luma of B independent clips -> ((B, T) float32
        scores, (B, T, words) int32 fps), each clip from a fresh carry
        (frame 0 scores 0), as ``_forward_batch_impl`` in the reference
        (tvidz_tpu/models/fingerprint.py:287). Through
        ``fingerprint_blocks_batched`` with B initial carries: for the 64-bit
        pHash on CUDA one K1 launch per 64 clips, each clip a segment;
        another family the same pass in plain torch. The model's current
        ``algorithm``, ``dct_size`` and ``hash_size`` are read at each call."""
        clips = torch.as_tensor(clips, device=self.device)
        if clips.ndim != 4 or 0 in clips.shape:
            raise ValueError(f"clips must be (B, T, H, W), got {tuple(clips.shape)}")
        b, t, h, w = clips.shape
        scores, fps, _ = fingerprint_blocks_batched(
            list(clips), [initial_fingerprint_carry(h, w, self.device)] * b,
            [t] * b, algorithm=self.algorithm, dct_size=self.dct_size,
            hash_size=self.hash_size)
        return scores, fps

    def forward_streams(self, lumas, carries, valid_ts):
        """K independent streams' (T, H, W) blocks in one pass: ((K, T)
        scores, (K, T, words) int32 fps, tuple of K carries), through
        ``fingerprint_blocks_batched``: for the 64-bit pHash one K1 launch
        on CUDA, stream k's results equal to a lone ``forward`` of it bit
        for bit; for another family one batched plain-torch pass.
        ``valid_ts``: each block's real frame count (T for a full block).
        Under ship_coeffs the payloads are (T, hash²) coefficient blocks:
        ``fingerprint_blocks_batched_coeffs``."""
        if self.ship_coeffs:
            return fingerprint_blocks_batched_coeffs(lumas, carries, valid_ts,
                                                     self.hash_size)
        return fingerprint_blocks_batched(lumas, carries, valid_ts, self.left,
                                          self.right, **self._family)

    def example_payload(self) -> torch.Tensor:
        """A zero payload block at the model's dispatch shape (warm passes
        use it): (T, hash²) float32 under ship_coeffs, else (T, H, W)
        uint8."""
        if self.ship_coeffs:
            return torch.zeros((self.block_frames, self.hash_size * self.hash_size),
                               dtype=torch.float32, device=self.device)
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
            return (np.zeros((0, self.words), np.uint32), carry, [], 0)
        bt = self.block_frames
        # The device payload, projected before padding: the projection is
        # linear per frame, so padding coefficient rows with the last row
        # equals projecting a last-frame-padded block.
        buf = np.asarray(self.project_payload(block.luma))
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
        return cuts, (np.concatenate(fps_out) if fps_out
                      else np.zeros((0, self.words), np.uint32))

    def analyze_path(self, path: str) -> Tuple[List[float], np.ndarray]:
        """Stream a video file block by block: (cut timestamps, packed fps).
        Only the 4·words-byte-per-frame fingerprints accumulate."""
        decoder = get_decoder(
            path, lowres=self.config.pipeline.decode_lowres,
            dct_dc=self.config.pipeline.decode_dct_dc)
        scorer = NativeSceneScorer(self.config.scene.native_resolution,
                                   host_mafd_fallback=self.ship_coeffs)
        return self._stream(
            decoder.blocks(path, self.block_frames, self.height, self.width),
            scorer)

    def analyze_array(self, luma: np.ndarray, pts: np.ndarray
                      ) -> Tuple[List[float], np.ndarray]:
        """Host-streamed analysis of (T, H, W) luma: (cut timestamps, fps).
        Arrays carry no decoder mafd, so the device scores decide cuts, or
        under ship_coeffs the scorer's host fallback (device scores are
        zeros there)."""
        bt = self.block_frames
        blocks = (types.SimpleNamespace(luma=luma[s:s + bt],
                                        pts=pts[s:s + bt], mafd=None)
                  for s in range(0, luma.shape[0], bt))
        return self._stream(blocks, NativeSceneScorer(
            False, host_mafd_fallback=self.ship_coeffs))
