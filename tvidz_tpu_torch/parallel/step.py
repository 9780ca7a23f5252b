"""The full multi-card analysis step.

Port of ``tvidz_tpu/parallel/step.py`` (one jitted SPMD program there). Over
a (data, corpus) mesh:

1. **Data parallelism**: a batch of B clips split over the ``data`` axis.
2. **Sequence streaming**: each clip is (NT, T, H, W) time tiles whose scene
   carry threads from tile to tile. Each data device fingerprints its clips
   in ONE K1 launch (``ops/fused.fingerprint_blocks_batched``, a segment of
   NT·T frames from a fresh carry per clip), which is the reference's
   ``lax.scan`` over tiles: K1's segments carry across frames exactly as
   chained blocks do.
3. **Corpus sharding**: per (clip, corpus shard), the timestamp match
   counts (plain torch) and the per-corpus-frame min Hamming distance over
   the clip's frames (K4 ``frame_min``), gathered on the mesh's first
   device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tvidz_tpu_torch.ops.fused import fingerprint_blocks_batched, initial_fingerprint_carry
from tvidz_tpu_torch.ops.hamming import corpus_frame_min
from tvidz_tpu_torch.ops.phash import hash_operators
from tvidz_tpu_torch.ops.timestamps import timestamp_match_counts
from tvidz_tpu_torch.parallel.mesh import CORPUS_AXIS, DATA_AXIS, Mesh
from tvidz_tpu_torch.parallel.sharded_search import as_sharded, place


class StepOutput(NamedTuple):
    scores: torch.Tensor        # (B, NT*T) scene scores
    fingerprints: torch.Tensor  # (B, NT*T, W) packed pHash, int32 bit-views
    ts_counts: torch.Tensor     # (B, N) timestamp match counts per corpus row
    fp_min_dist: torch.Tensor   # (B, NF) min hamming of each corpus frame row


def _clips_fingerprint(clips: torch.Tensor):
    """(B, NT, T, H, W) uint8 -> ((B, NT*T) scores, (B, NT*T, 2) fps): each
    clip one segment of NT*T frames from a fresh carry, one K1 launch for
    all B on CUDA (up to K1's 64 segments a launch)."""
    b, nt, t, h, w = clips.shape
    left, right = hash_operators(h, w, clips.device)
    carry = initial_fingerprint_carry(h, w, clips.device)
    scores, fps, _ = fingerprint_blocks_batched(
        clips.reshape(b, nt * t, h, w).unbind(0), [carry] * b, [nt * t] * b,
        left, right)
    return scores, fps


def _mafd_scores(mafd: torch.Tensor) -> torch.Tensor:
    """FFmpeg f_select recurrence on a (B, F) mafd sequence (prev_mafd
    starts 0; frame 0 scores 0) — golden.scene_scores semantics."""
    prev = torch.cat([torch.zeros_like(mafd[:, :1]), mafd[:, :-1]], dim=1)
    sc = torch.clamp(torch.minimum(mafd, torch.abs(mafd - prev)) / 100.0, 0.0, 1.0)
    sc[:, 0] = 0.0
    return sc


def _extract_cut_ts(scores: torch.Tensor, pts: torch.Tensor, threshold: float,
                    max_cuts: int) -> torch.Tensor:
    """(B, F) scores and pts -> (B, min(max_cuts, F)) pts of the first
    max_cuts frames whose score exceeds threshold, NaN-padded.

    pts MUST arrive already rounded to 6 decimals at the HOST boundary
    (``place_step_inputs`` does; the analyzer's invariant): a float32
    round(x*1e6)/1e6 quantizes before rounding past ~16 s of timeline, and
    matching is exact equality."""
    total = scores.shape[-1]
    idx = torch.arange(total, device=scores.device)
    order = torch.where(scores > threshold, idx, total)
    picked = torch.sort(order, dim=-1).values[..., :max_cuts]
    taken = pts.gather(-1, picked.clamp(max=total - 1))
    return torch.where(picked < total, taken, torch.full_like(taken, float("nan")))


def multichip_analysis_step(
    clips,                      # (B, NT, T, H, W) uint8 — sharded over data
    pts,                        # (B, NT*T) float32 — sharded over data
    corpus_ts,                  # (N, MAX) float32 — sharded over corpus
    corpus_len,                 # (N,) int32 — sharded over corpus
    corpus_fp,                  # (NF, W) int32 — sharded over corpus
    mesh: Mesh,
    threshold: float = 0.3,
    max_cuts: int = 32,
    mafd: Optional[torch.Tensor] = None,    # (B, NT*T) f32 — native-res mafd
) -> StepOutput:
    """The dp batch of clips x streamed time tiles x the sharded corpus
    match. Each data device fingerprints its clips (one K1 launch), then
    matches them against every corpus shard on that shard's cell of its
    data row. Outputs land on the mesh's first device.

    Scene scoring policy: with decoder-provided NATIVE-resolution ``mafd``
    (what every host surface uses), scores come from its recurrence and
    cut timestamps agree exactly with the analyzer/CLI; without it, from
    the device's downscaled luma."""
    clips = as_sharded(clips, mesh, DATA_AXIS)
    pts = as_sharded(pts, mesh, DATA_AXIS)
    mafd = None if mafd is None else as_sharded(mafd, mesh, DATA_AXIS)
    ts = as_sharded(corpus_ts, mesh, CORPUS_AXIS)
    ln = as_sharded(corpus_len, mesh, CORPUS_AXIS)
    fp = as_sharded(corpus_fp, mesh, CORPUS_AXIS)
    rows = []
    for d in range(mesh.shape[DATA_AXIS]):
        scores, fps = _clips_fingerprint(clips.block(d, 0))
        if mafd is not None:
            scores = _mafd_scores(mafd.block(d, 0))
        cut_ts = _extract_cut_ts(scores, pts.block(d, 0), threshold, max_cuts)
        counts, fp_min = [], []
        for c in range(mesh.shape[CORPUS_AXIS]):
            dev = mesh.devices[d][c]
            q_ts, q_fp = cut_ts.to(dev), fps.to(dev)
            counts.append(torch.stack([
                timestamp_match_counts(q, ts.block(d, c), ln.block(d, c))
                for q in q_ts]))
            fp_min.append(torch.stack([corpus_frame_min(q, fp.block(d, c))
                                       for q in q_fp]))
        rows.append((scores, fps, counts, fp_min))
    home = mesh.home
    return StepOutput(
        scores=torch.cat([r[0].to(home) for r in rows]),
        fingerprints=torch.cat([r[1].to(home) for r in rows]),
        ts_counts=torch.cat([torch.cat([x.to(home) for x in r[2]], dim=1)
                             for r in rows]),
        fp_min_dist=torch.cat([torch.cat([x.to(home) for x in r[3]], dim=1)
                               for r in rows]),
    )


def place_step_inputs(mesh: Mesh, clips, pts, corpus_ts, corpus_len, corpus_fp):
    """Each numpy input laid out with its step sharding (``corpus_fp`` as
    uint32 rows, placed as int32 bit-views).

    The HOST boundary for the 6-decimal timestamp rounding invariant
    (analyzer parity): pts are rounded in float64 here, because float32
    arithmetic cannot correctly round microseconds past ~16 s of timeline
    (see ``_extract_cut_ts``). Callers bypassing this helper must
    pre-round."""
    pts = np.round(np.asarray(pts, np.float64), 6).astype(np.float32)
    fp = np.ascontiguousarray(corpus_fp, np.uint32).view(np.int32)
    return (
        place(np.asarray(clips, np.uint8), mesh, DATA_AXIS),
        place(pts, mesh, DATA_AXIS),
        place(np.asarray(corpus_ts, np.float32), mesh, CORPUS_AXIS),
        place(np.asarray(corpus_len, np.int32), mesh, CORPUS_AXIS),
        place(fp, mesh, CORPUS_AXIS),
    )
