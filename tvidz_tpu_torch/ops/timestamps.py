"""Scene-cut timestamp matching — plain PyTorch, blocked over the corpus.

Port of ``tvidz_tpu/ops/timestamps.py`` (contract: the reference's
``find_duplicates``, db.py:76-94): per corpus row, how many query
timestamps appear in it — exact float32 equality (or within ``tolerance``),
each query timestamp counted at most once, NaN query padding never
matching. The reference has no Pallas kernel here, so neither has the port.
"""

from __future__ import annotations

import torch


def match_counts_block(query_ts: torch.Tensor, c_ts: torch.Tensor,
                       c_len: torch.Tensor, tolerance: float) -> torch.Tensor:
    """(B,) int32 counts for one block of corpus rows."""
    max_cuts = c_ts.shape[1]
    q = query_ts[None, :, None]             # (1, K, 1)
    c = c_ts[:, None, :]                    # (B, 1, MAX)
    valid = (torch.arange(max_cuts, device=c_ts.device)[None, None, :]
             < c_len[:, None, None])
    if tolerance <= 0.0:
        hit = (q == c) & valid
    else:
        hit = (torch.abs(q - c) <= tolerance) & valid
    return hit.any(dim=-1).sum(dim=-1).to(torch.int32)


def timestamp_match_counts(
    query_ts: torch.Tensor,     # (K,) float32, padded entries = NaN
    corpus_ts: torch.Tensor,    # (N, MAX_CUTS) float32 padded
    corpus_len: torch.Tensor,   # (N,) int32
    tolerance: float = 0.0,
    block_n: int = 4096,
) -> torch.Tensor:
    """(N,) int32 match counts; the (block, K, MAX) comparison never exceeds
    ``block_n`` corpus rows at a time."""
    n = corpus_ts.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=corpus_ts.device)
    for s in range(0, n, block_n):
        out[s:s + block_n] = match_counts_block(
            query_ts, corpus_ts[s:s + block_n], corpus_len[s:s + block_n],
            tolerance)
    return out
