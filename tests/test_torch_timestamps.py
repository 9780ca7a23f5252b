"""Port parity: scene-cut timestamp matching (plain PyTorch; the reference
has no Pallas kernel here). Counts must equal the JAX op and the golden
model exactly: float32 equality, NaN padding never matches, each query
timestamp counted at most once per row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvidz_tpu.corpus.device_corpus import DeviceCorpus as JaxCorpus
from tvidz_tpu.ops import golden
from tvidz_tpu.ops.timestamps import timestamp_match_counts as jax_counts
from tvidz_tpu_torch import state
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.ops.timestamps import timestamp_match_counts

CPU = torch.device("cpu")


def _corpus(n=300, max_cuts=16, seed=2):
    rng = np.random.default_rng(seed)
    grid = (np.arange(200) * 0.04).astype(np.float32)
    ts = np.full((n, max_cuts), np.nan, np.float32)
    ln = rng.integers(0, max_cuts + 1, size=n).astype(np.int32)
    for i in range(n):
        ts[i, : ln[i]] = np.sort(rng.choice(grid, ln[i], replace=False))
    ts[5, :4] = ts[5, 0]                           # repeated stored value
    ln[5] = max(ln[5], 4)
    q = np.full(max_cuts, np.nan, np.float32)
    q[:6] = rng.choice(grid, 6, replace=False)
    q[6] = q[0]                                    # repeated query value
    return q, ts, ln


@pytest.mark.parametrize("tolerance,block_n", [(0.0, 4096), (0.0, 64),
                                               (0.05, 64)])
def test_counts_match_jax_and_golden(tolerance, block_n):
    q, ts, ln = _corpus()
    want = np.asarray(jax_counts(jnp.asarray(q), jnp.asarray(ts),
                                 jnp.asarray(ln), tolerance=tolerance,
                                 block_n=block_n))
    got = timestamp_match_counts(torch.from_numpy(q), torch.from_numpy(ts),
                                 torch.from_numpy(ln), tolerance=tolerance,
                                 block_n=block_n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, golden.timestamp_match_counts(q[~np.isnan(q)], ts, ln, tolerance))


def _apply(corpus, ops):
    for op, vid, arg in ops:
        if op == "upsert":
            corpus.upsert_timestamps(vid, arg)
        else:
            corpus.remove_video(vid)


def test_match_timestamps_through_both_corpora():
    """The same inserts, re-uploads and removals through both corpora give
    the same host mirrors and verdicts; a port corpus loaded from the JAX
    mirrors (state.device_corpus_from_reference) agrees too."""
    rng = np.random.default_rng(9)
    cuts = {v: sorted(rng.choice(np.arange(100) * 0.04, 8, replace=False).round(6)
                      .tolist()) for v in range(1, 12)}
    cuts[12] = cuts[3]                      # a re-upload of removed 3
    ops = [("upsert", v, cuts[v]) for v in range(1, 12)]
    ops += [("remove", 3, None), ("remove", 7, None),
            ("upsert", 12, cuts[12]), ("upsert", 2, cuts[2][:3])]
    kw = dict(max_cuts=16, ts_initial_capacity=4)
    jc = JaxCorpus(**kw)
    tc = DeviceCorpus(device="cpu", **kw)
    _apply(jc, ops)
    _apply(tc, ops)
    for k in ("_ts", "_ts_len", "_ts_vid"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
    loaded = state.device_corpus_from_reference(
        state.reference_host_mirrors(jc), device="cpu")
    for v in (1, 2, 3, 5, 12):
        query = cuts[v][:6] + [99.0]
        for kwargs in ({}, {"exclude_video_id": v}, {"min_match": 3}):
            want = jc.match_timestamps(query, **kwargs)
            assert tc.match_timestamps(query, **kwargs) == want
            assert loaded.match_timestamps(query, **kwargs) == want
