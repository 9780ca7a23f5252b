"""Scene-cut scoring with FFmpeg ``select`` semantics, streaming-block form.

Port of ``tvidz_tpu/ops/scene.py``:

    mafd[t]  = mean |luma[t] - luma[t-1]|        (8-bit pixel units)
    score[t] = clip(min(mafd[t], |mafd[t] - mafd[t-1]|) / 100, 0, 1)

The carry (last luma frame, its mafd, a has-previous flag) makes block
boundaries invisible. ``scene_scores_block`` is the plain PyTorch version
(``scene_scores_blocks`` the same over K streams at once, as the
reference's ``jax.vmap`` of it); on the GPU the fingerprint-block kernel
(ops/fused.py) computes the same scores for the 64-bit pHash, and the other
hash families take these plain versions (ops/fused.fingerprint_family_*). ``NativeSceneScorer`` is the host policy shared by every surface and
is carried over unchanged except that device scores arrive as a tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class SceneCarry(NamedTuple):
    prev_frame: torch.Tensor   # (H, W) float32 — last luma frame seen
    prev_mafd: torch.Tensor    # () float32 — mafd of the last comparison
    has_prev: torch.Tensor     # () bool — False before the first real frame


def initial_scene_carry(height: int, width: int,
                        device: torch.device) -> SceneCarry:
    return SceneCarry(
        prev_frame=torch.zeros((height, width), dtype=torch.float32,
                               device=device),
        prev_mafd=torch.zeros((), dtype=torch.float32, device=device),
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
    )


def scene_scores_from_mafd_block(
    mafd: np.ndarray, prev_mafd: float
) -> Tuple[np.ndarray, float]:
    """Host-side streaming scorer over decoder-provided NATIVE-resolution
    mafd values (FrameBlock.mafd). Returns ((T,) float32 scores, mafd of the
    last frame for the next block's prev_mafd)."""
    m = np.asarray(mafd, np.float64)
    prev = np.concatenate([[prev_mafd], m[:-1]])
    scores = np.clip(np.minimum(m, np.abs(m - prev)) / 100.0, 0.0, 1.0)
    return scores.astype(np.float32), float(m[-1]) if m.size else prev_mafd


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class NativeSceneScorer:
    """Per-stream policy for native-resolution scene scoring — the single
    implementation behind the analyzer, ``FingerprintModel.analyze_path``
    and (later) multistream, so cut timestamps agree exactly between
    surfaces (exact-equality dedup depends on it).

    Scores come from the decoder's native-res mafd while available;
    sticky-disables to the device's downscaled scores the first time a
    block can't provide usable mafd, so one video's score stream never
    mixes recurrences. ``host_mafd_fallback=True`` (the coefficient-shipping
    mode) computes the fallback recurrence host-side over the downscaled
    luma instead (tvidz_tpu/ops/scene.py:64-182 has the full rationale).
    """

    def __init__(self, enabled: bool, host_mafd_fallback: bool = False):
        self.active = enabled
        self.host_fallback = host_mafd_fallback
        self.prev_mafd = 0.0
        self._host_prev_luma = None     # (H, W) — last block's tail
        self._host_prev_mafd = 0.0
        self._host_started = False

    def _host_mafd(self, block, t: int) -> np.ndarray:
        """(t,) float64 mafd over the DOWNSCALED block luma, continuous with
        the previous block via the tracked tail frame (uint8 diffs run in
        exact int16; the mean accumulates in float64)."""
        x = np.asarray(block.luma[:t])
        m = np.empty((t,), np.float64)
        if t:
            xi = x.astype(
                np.int16 if x.dtype == np.uint8 else np.float64, copy=False)
            if self._host_prev_luma is None:
                m[0] = 0.0          # stream start: FFmpeg scores frame 0 as 0
            else:
                m[0] = float(np.mean(
                    np.abs(xi[0] - self._host_prev_luma),
                    dtype=np.float64))
            if t > 1:
                m[1:] = np.mean(np.abs(xi[1:] - xi[:-1]),
                                axis=(1, 2), dtype=np.float64)
            self._host_prev_luma = xi[-1].copy()
        return m

    def replay(self, block) -> None:
        """Checkpoint-resume skip path: keep the recurrence warm without
        scoring."""
        if block.mafd is not None and block.mafd.size:
            self.prev_mafd = float(block.mafd[-1])
        if self.host_fallback:
            t = block.luma.shape[0]
            if t:
                if self._host_started or not self._usable_mafd(block):
                    m = self._host_mafd(block, t)
                    self._host_started = True
                    self._host_prev_mafd = float(m[-1])
                else:
                    tail = np.asarray(block.luma[t - 1])
                    self._host_prev_luma = tail.astype(
                        np.int16 if tail.dtype == np.uint8 else np.float64)

    @staticmethod
    def _usable_mafd(block) -> bool:
        return not (
            block.mafd is None
            or (block.mafd.size and float(block.mafd.min()) < 0)
        )

    def scores(self, block, device_scores, t: int) -> np.ndarray:
        """(t,) float32 scores for a processed block. ``device_scores`` is
        only read (and only then copied to the host) on the fallback path."""
        if self.active and not self._usable_mafd(block):
            self.active = False
        if self.active:
            sc, self.prev_mafd = scene_scores_from_mafd_block(
                block.mafd, self.prev_mafd
            )
            if self.host_fallback and t:
                tail = np.asarray(block.luma[t - 1])
                self._host_prev_luma = tail.astype(
                    np.int16 if tail.dtype == np.uint8 else np.float64)
            return sc
        if self.host_fallback:
            m = self._host_mafd(block, t)
            if not self._host_started:
                self._host_prev_mafd = self.prev_mafd
                self._host_started = True
            sc, self._host_prev_mafd = scene_scores_from_mafd_block(
                m, self._host_prev_mafd
            )
            return sc
        return _host(device_scores[:t])


def scene_scores_block(
    luma: torch.Tensor, carry: SceneCarry, valid_t=None
) -> Tuple[torch.Tensor, SceneCarry]:
    """Score one (T, H, W) block of luma frames — the plain PyTorch version.

    Returns ((T,) float32 scores, new carry). For the stream's first block,
    frame 0 is differenced against the zero carry frame; that mafd is
    meaningless, so its score and its contribution to frame 1's prev_mafd
    are masked to 0 (FFmpeg's startup state). ``valid_t`` (int): number of
    REAL frames of a block padded by repeating its last frame; the carry
    then reflects frame valid_t-1, not the last pad row (a pad row's mafd of
    0 carried into the next block would score a spurious cut).
    """
    t = luma.shape[0]
    x = luma.reshape(t, -1).to(torch.float32)
    prev = torch.cat([carry.prev_frame.reshape(1, -1), x[:-1]], dim=0)
    mafd = torch.mean(torch.abs(x - prev), dim=1)                # (T,)
    is_stream_start = torch.logical_not(carry.has_prev) & (
        torch.arange(t, device=x.device) == 0)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mafd = torch.where(is_stream_start, zero, mafd)
    prev_mafd = torch.cat([carry.prev_mafd.reshape(1), mafd[:-1]])
    diff = torch.abs(mafd - prev_mafd)
    scores = torch.clamp(torch.minimum(mafd, diff) / 100.0, 0.0, 1.0)
    scores = torch.where(is_stream_start, zero, scores)
    idx = t - 1 if valid_t is None else int(valid_t) - 1
    new_carry = SceneCarry(
        prev_frame=x[idx].reshape(luma.shape[1:]).clone(),
        prev_mafd=mafd[idx].clone(),
        has_prev=torch.ones((), dtype=torch.bool, device=x.device),
    )
    return scores, new_carry


def scene_scores_blocks(lumas: torch.Tensor, carries, valid_ts
                        ) -> Tuple[torch.Tensor, Tuple[SceneCarry, ...]]:
    """``scene_scores_block`` of K streams at once: (K, T, H, W) luma, K
    carries and K real frame counts -> ((K, T) float32 scores, K new
    carries), stream k continuing its own carry."""
    k, t = lumas.shape[:2]
    x = lumas.reshape(k, t, -1).to(torch.float32)
    prev = torch.cat([torch.stack([c.prev_frame.reshape(-1) for c in carries])[:, None],
                      x[:, :-1]], dim=1)
    mafd = torch.mean(torch.abs(x - prev), dim=2)                 # (K, T)
    has_prev = torch.stack([c.has_prev for c in carries])
    is_stream_start = (torch.logical_not(has_prev)[:, None]
                       & (torch.arange(t, device=x.device) == 0)[None, :])
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mafd = torch.where(is_stream_start, zero, mafd)
    prev_mafd = torch.cat([torch.stack([c.prev_mafd for c in carries])[:, None],
                           mafd[:, :-1]], dim=1)
    diff = torch.abs(mafd - prev_mafd)
    scores = torch.clamp(torch.minimum(mafd, diff) / 100.0, 0.0, 1.0)
    scores = torch.where(is_stream_start, zero, scores)
    one = torch.ones((), dtype=torch.bool, device=x.device)
    new = tuple(SceneCarry(prev_frame=x[j, int(v) - 1].reshape(lumas.shape[2:]).clone(),
                           prev_mafd=mafd[j, int(v) - 1].clone(), has_prev=one)
                for j, v in enumerate(valid_ts))
    return scores, new
