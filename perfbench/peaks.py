"""Peak rates of one NVIDIA H100 and the least time each measured op needs.

NVIDIA's data-sheet rates for the SXM part at its full 700 W limit, dense
(no sparsity). A Hamming distance between packed fingerprints is bounded as
the card's fastest form of it, a 32·W-term ±1 int8 dot product on the tensor
cores, whichever kernel computes it; the pHash's DCT is float32 work outside
the tensor cores (TF32 stays off). Every bound counts each input byte read
once and each output byte written once, and the operations the inputs need
(real frames and real rows, not padding).
"""

from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_TC_OPS_PER_S = 1979e12


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """Seconds to move ``nbytes`` once and do ``ops`` at peak: the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def k1_bound_s(valid_ts: Sequence[int], height: int, width: int) -> float:
    """One pass of the fingerprint block op over K streams' blocks with
    ``valid_ts`` real frames each at (height, width): the frames, each
    stream's carry frame in and out, scores and hashes; per frame the
    factored DCT (2·8·H·W + 2·64·H) and the mafd (3·H·W) in float32."""
    frames = sum(int(t) for t in valid_ts)
    hw = height * width
    nbytes = frames * hw + len(valid_ts) * 2 * 4 * hw + frames * 12
    ops = frames * (2 * 8 * hw + 2 * 64 * height + 3 * hw)
    return bound_s(nbytes, ops, FP32_OPS_PER_S)


def scan_bound_s(m: int, n: int, words: int) -> float:
    """A query-nearest corpus scan of ``m`` queries against ``n`` rows of
    ``words`` 32-bit words: corpus and queries in, (min, row) out."""
    return bound_s(4 * words * (n + m) + 8 * m, 2 * 32 * words * m * n,
                   INT8_TC_OPS_PER_S)


def align_ops(query_lens: Sequence[int], video_lens: Sequence[int],
              words: int) -> float:
    """Operations of a fragment alignment: every real query frame against
    every real frame of every candidate video, one 32·W-term dot each."""
    return 2.0 * 32 * words * sum(query_lens) * sum(video_lens)


def align_bound_s(query_lens: Sequence[int], video_lens: Sequence[int],
                  words: int) -> float:
    """A fragment alignment of Q queries against V videos: their real rows
    in, a (video, offset, score) per pair out."""
    q, v = len(query_lens), len(video_lens)
    nbytes = 4 * words * (sum(query_lens) + sum(video_lens)) + 16 * q * v
    return bound_s(nbytes, align_ops(query_lens, video_lens, words),
                   INT8_TC_OPS_PER_S)
