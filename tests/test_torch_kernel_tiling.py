"""The arithmetic decomposition of kernels K3 and K4, modelled in numpy and
held against the port's plain versions, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
These models repeat, step by step, how each kernel splits its work, so
that a fault in the split (a band that misses a diagonal, a tie broken by
the wrong CTA, a ring slot overwritten too early) shows here without one:

- K3 (``csrc/fragment_search.cu``): offset bands of 128, 64-row query tiles
  whose first one starts where its window row 0 is a multiple of 64, a
  256-row ring of unpacked corpus rows that slides by 64 rows a tile and
  is read in 64-row pieces that never wrap, the threshold as
  dot >= 64 - 2 thr, validity checked for matched pairs only, a warp's
  16 x 64 block that matched whole counted once per band inside the valid
  rows and by interval ends at their edges, a per-band
  first-index argmax and the bands combined by the maximum 64-bit key.
- K4 (``csrc/corpus_scan_tc.cu``): contiguous per-CTA ranges of 256-row
  tiles walked in ascending order, query chunks of 128, the rows each
  thread holds, rows past N masked, per thread and query a running key
  (dot + 64) << 24 | (0xffffff - row offset in the range) kept by its
  maximum, and the per-(CTA, query) 64-bit key combine.

Tolerance: exact (integer counts and indices).
"""

import numpy as np
import pytest
import torch

from tvidz_tpu_torch.ops import align, hamming

_NO_KEY = (1 << 64) - 1
_ZERO_KEY = 0x7FFFFFFF                  # score 0 at d = 0


def _pm1(packed):
    """(..., 2) uint32 -> (..., 64) int64 ±1, MSB-first per word."""
    bits = np.unpackbits(packed.astype(">u4").view(np.uint8), axis=-1)
    return bits.astype(np.int64) * 2 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                            if a.dtype == np.uint32 else a)


# -- K3 -----------------------------------------------------------------------


def k3_model(qs, q_lens, corpus, lens, thr, band=128, tile=64, ring=256,
             stats=None):
    """(Q, V) offsets and scores as K3 computes them; ``stats`` counts the
    warp blocks counted pair by pair and those that matched whole."""
    stats = {"all_matched": 0, "pairwise": 0} if stats is None else stats
    nq, tq_pad, _ = qs.shape
    nv, tc, _ = corpus.shape
    win = -(-(tile + band - 1) // 64) * 64          # whole 64-row pieces
    thr = min(max(thr, -1), 64)
    q_pm1, c_pm1 = _pm1(qs), _pm1(corpus)
    nd = tq_pad + tc - 1
    keys = np.full((nq, nv), _ZERO_KEY, dtype=object)
    tl, jj = np.meshgrid(np.arange(tile), np.arange(win), indexing="ij")
    for q in range(nq):
        q_len = min(max(int(q_lens[q]), 0), tq_pad)
        for v in range(nv):
            c_len = min(max(int(lens[v]), 0), tc)
            for d0 in range(0, nd, band):
                o0 = d0 - (tq_pad - 1)
                t_begin, t_end = max(0, -(o0 + band - 1)), min(q_len, c_len - o0)
                cnt = np.zeros(band, np.int64)
                whole = {}          # (r0, c0) -> blocks matched whole inside
                # The ring holds (row j mod ring); a 64-row window piece must
                # not wrap, so the first tile starts where t0 + o0 is a
                # multiple of 64 (earlier rows are masked).
                slots = np.zeros((ring, 64), np.int64)
                t_first = t_begin - (t_begin + o0) % 64
                have = None
                for t0 in range(t_first, t_end, tile):
                    j0 = t0 + o0
                    assert j0 % 64 == 0 and all(
                        (j0 + p) % ring + 64 <= ring for p in range(0, win, 64))
                    t = t0 + np.arange(tile)
                    ok_t = (t >= 0) & (t < q_len)
                    a = np.zeros((tile, 64), np.int64)
                    a[ok_t] = q_pm1[q, t[ok_t]]
                    for j in range(j0 if have is None else max(j0, have), j0 + win):
                        slots[j % ring] = c_pm1[v, j] if 0 <= j < c_len else 0
                    have = j0 + win
                    w = slots[(j0 + np.arange(win)) % ring]
                    matched = a @ w.T >= 64 - 2 * thr
                    dd, tt, j = jj - tl, t0 + tl, j0 + jj
                    ok = (matched & (dd >= 0) & (dd < band) & (tt >= 0)
                          & (tt < q_len) & (j >= 0) & (j < c_len))
                    # Per warp and 64-row piece: a 16 x 64 block.
                    for r0, c0 in np.ndindex(tile // 16, win // 64):
                        r0, c0 = 16 * r0, 64 * c0
                        blk = matched[r0:r0 + 16, c0:c0 + 64]
                        if not blk.any():          # the warp vote's skip
                            continue
                        if blk.all():
                            stats["all_matched"] += 1
                            if (0 <= t0 + r0 and t0 + r0 + 16 <= q_len
                                    and 0 <= j0 + c0 and j0 + c0 + 64 <= c_len):
                                whole[r0, c0] = whole.get((r0, c0), 0) + 1
                                continue
                            # At an edge: counts by interval ends.
                            r_lo, r_hi = max(r0, -t0), min(r0 + 16, q_len - t0)
                            c_lo, c_hi = max(c0, -j0), min(c0 + 64, c_len - j0)
                            for d in range(max(0, c_lo - r_hi + 1),
                                           min(band - 1, c_hi - 1 - r_lo) + 1):
                                n = min(r_hi, c_hi - d) - max(r_lo, c_lo - d)
                                cnt[d] += max(n, 0)
                        else:
                            stats["pairwise"] += 1
                            sub = (slice(r0, r0 + 16), slice(c0, c0 + 64))
                            np.add.at(cnt, dd[sub][ok[sub]], 1)
                # Each whole block's trapezoid, added once per band.
                for (r0, c0), k in whole.items():
                    base = c0 - r0
                    for x in range(-15, 64):
                        if 0 <= base + x < band:
                            cnt[base + x] += k * (min(16, 64 - x) - max(0, -x))
                best = int(cnt.max())
                if best > 0:
                    d = d0 + int(np.argmax(cnt))        # first index
                    keys[q, v] = max(keys[q, v], (best << 32) | (0x7FFFFFFF - d))
    scores = np.array([[k >> 32 for k in row] for row in keys], np.int32)
    offs = np.array([[(0x7FFFFFFF - (k & 0xFFFFFFFF)) - (tq_pad - 1)
                      for k in row] for row in keys], np.int32)
    return offs, scores


def _k3_case(name, seed=3):
    """(qs, q_lens, corpus, lens, thr) of one named case."""
    rng = np.random.default_rng(seed)
    nq, tq_pad, nv, tc, thr = 2, 150, 5, 260, 10
    if name == "not_band_multiple":
        tq_pad, tc = 97, 171               # 97 + 171 - 1 = 267, not k * 128
    corpus = rng.integers(0, 2 ** 32, size=(nv, tc, 2), dtype=np.uint32)
    qs = rng.integers(0, 2 ** 32, size=(nq, tq_pad, 2), dtype=np.uint32)
    lens = np.full(nv, tc, np.int32)
    q_lens = np.full(nq, tq_pad, np.int32)
    if name == "periodic":
        # Period 20: query 0 ties at every 20th offset, across bands.
        corpus[1] = np.resize(corpus[1, :20], (tc, 2))
        qs[0] = np.resize(corpus[1, 3:23], (tq_pad, 2))
        q_lens[0] = 40                     # fits at offsets 3 .. 203
    elif name == "short_rows":
        q_lens[:] = (tq_pad - 41, 9)
        lens[2], lens[3] = tc // 3, 0
        qs[0, :60] = corpus[2, 40:100]
        qs[1, :9] = corpus[4, 250:259]
    elif name in ("thr0", "thr40"):
        thr = 0 if name == "thr0" else 40
        qs[0, :100] = corpus[3, 70:170]
        qs[0, ::3, 1] ^= np.uint32(1)
    elif name == "identical":
        corpus[:] = corpus[0, 0]
        qs[:] = corpus[0, 0]
        lens[4] = 17
        q_lens[1] = 33
    elif name in ("identical_thr40", "static_runs"):
        # Static scenes: runs of one repeated row inside random videos, and
        # a query holding such a run, so whole-block matches sit beside
        # blocks that match in part.
        thr = 40 if name == "identical_thr40" else thr
        still = corpus[0, 0]
        corpus[0, 30:200] = still
        corpus[2, :90] = still
        corpus[3, 150:] = still
        lens[3] = 230
        qs[0, 20:140] = still
        qs[1] = still
        q_lens[1] = 101
    elif name == "not_band_multiple":
        qs[1, :50] = corpus[0, 121:171]        # ends at the video's end
    return qs, q_lens, corpus, lens, thr


K3_CASES = ("periodic", "short_rows", "thr0", "thr40", "identical",
            "identical_thr40", "static_runs", "not_band_multiple")


@pytest.mark.parametrize("name", K3_CASES)
def test_k3_decomposition_equals_plain(name):
    qs, q_lens, corpus, lens, thr = _k3_case(name)
    offs, scores = k3_model(qs, q_lens, corpus, lens, thr)
    want_o, want_s = align.fragment_search_batch_plain(
        _t(qs), _t(q_lens), _t(corpus), _t(lens), thr)
    assert np.array_equal(offs, want_o.numpy())
    assert np.array_equal(scores, want_s.numpy())
    for q in range(qs.shape[0]):
        o, s = align.fragment_core(_t(qs[q]), int(q_lens[q]), _t(corpus),
                                   _t(lens), thr)
        assert np.array_equal(offs[q], o.numpy()) and np.array_equal(scores[q], s.numpy())


@pytest.mark.parametrize("band", [32, 64])
def test_k3_decomposition_narrow_bands(band):
    """Narrower bands put more band edges (and more tied maxima across
    them) into the same inputs."""
    qs, q_lens, corpus, lens, thr = _k3_case("periodic")
    offs, scores = k3_model(qs, q_lens, corpus, lens, thr, band=band)
    want_o, want_s = align.fragment_search_batch_plain(
        _t(qs), _t(q_lens), _t(corpus), _t(lens), thr)
    assert np.array_equal(offs, want_o.numpy())
    assert np.array_equal(scores, want_s.numpy())


@pytest.mark.parametrize("name,whole,in_part", [
    ("identical", True, True), ("static_runs", True, True),
    ("periodic", False, True)])
def test_k3_block_paths_are_taken(name, whole, in_part):
    """The cases reach the counting paths they are meant for: identical
    rows and static runs both (blocks at a video's or query's end match in
    part), random rows with a planted fragment only blocks that match in
    part."""
    stats = {"all_matched": 0, "pairwise": 0}
    k3_model(*_k3_case(name), stats=stats)
    assert (stats["all_matched"] > 0) == whole
    assert (stats["pairwise"] > 0) == in_part


def test_k3_periodic_case_ties_across_bands():
    """The periodic case really ties: query 0's maximum is reached at
    offsets in more than one band, and the answer is the first."""
    qs, q_lens, corpus, lens, thr = _k3_case("periodic")
    n = int(q_lens[0])
    s = align.align_scores(_t(qs[0, :n]), _t(corpus[1]), thr).numpy()
    offsets = np.flatnonzero(s == s.max()) - (n - 1)
    # The kernel's score row index is d = o + Tq_pad - 1.
    assert len({(int(o) + qs.shape[1] - 1) // 128 for o in offsets}) > 1
    offs, _ = k3_model(qs, q_lens, corpus, lens, thr)
    assert offs[0, 1] == offsets[0]


# -- K4 -----------------------------------------------------------------------


def k4_model(q, corpus, grid, tile=256, chunk=128):
    """(frame_min, q_min, q_arg) as K4 computes them on ``grid`` CTAs."""
    m, n = q.shape[0], corpus.shape[0]
    q_pm1, c_pm1 = _pm1(q), _pm1(corpus)
    tiles = -(-n // tile)
    ctas = min(tiles, grid)
    assert -(-tiles // ctas) * tile <= 0xFFFFFF      # a row offset in 24 bits
    # Row r of a tile belongs to thread (warp, g) = ((r % 64) // 16, r % 8):
    # per 64-row wgmma a thread holds rows 16 warp + g and 16 warp + g + 8.
    r = np.arange(tile)
    thread = ((r % 64) // 16) * 8 + r % 8
    frame_min = np.zeros(n, np.int64)
    keys = np.full(m, _NO_KEY, dtype=object)
    for c in range(ctas):
        lo, hi = tiles * c // ctas, tiles * (c + 1) // ctas
        range_base = lo * tile
        for q0 in range(0, m, chunk):
            qc = q_pm1[q0:q0 + chunk]
            # Running key per (query, thread): (dot + 64) << 24 |
            # (0xffffff - row offset in the range); 0 before any row.
            best = np.zeros((qc.shape[0], 32), np.int64)
            for tl in range(lo, hi):                    # ascending
                rows = tl * tile + r
                valid = rows < n
                block = np.zeros((tile, 64), np.int64)
                block[valid] = c_pm1[rows[valid]]
                dots = np.where(valid, qc @ block.T, -64)
                fm = (64 - dots.max(axis=0)[valid]) >> 1
                frame_min[rows[valid]] = fm if q0 == 0 else np.minimum(
                    frame_min[rows[valid]], fm)
                key = np.where(valid, ((dots + 64) << 24)
                               | (0xFFFFFF - (rows - range_base)), 0)
                for th in range(32):
                    best[:, th] = np.maximum(best[:, th],
                                             key[:, thread == th].max(axis=1))
            for i in range(qc.shape[0]):
                cand = [(((64 - ((int(k) >> 24) - 64)) >> 1) << 32)
                        | (range_base + 0xFFFFFF - (int(k) & 0xFFFFFF))
                        for k in best[i] if k != 0]
                keys[q0 + i] = min(keys[q0 + i], min(cand))
    q_min = np.array([k >> 32 for k in keys], np.int32)
    q_arg = np.array([k & 0xFFFFFFFF for k in keys], np.int32)
    return frame_min.astype(np.int32), q_min, q_arg


def _k4_case(name, seed=17):
    """(q, corpus, grid, chunk) of one named case."""
    rng = np.random.default_rng(seed)
    m, n, grid, chunk = 24, 3000, 3, 128
    if name == "m_above_chunk":
        m, chunk = 40, 16
    if name == "ragged_small":
        n, grid = 301, 5                  # two tiles, fewer than the grid
    corpus = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(m, 2), dtype=np.uint32)
    tiles = -(-n // 256)
    edge = 256 * (tiles // min(tiles, grid))         # CTA 0's range ends
    if name == "ties_in_range":
        corpus[[256 + 9, 9]] = q[0]                  # same thread, next tile
        corpus[[256 + 100, 256 + 3]] = q[1]          # same tile, two warps
        corpus[[700, 600, 650]] = q[2] ^ np.uint32(3)   # distance-4 ties
    elif name == "ties_across_ranges":
        corpus[[edge, edge - 1]] = q[0]
        corpus[[n - 5, edge + 1, 100]] = q[1]
        corpus[[edge + 256, edge - 256]] = q[2] ^ np.uint32(1)
    elif name == "all_tied":
        corpus[:] = corpus[0]
    elif name == "m_above_chunk":
        corpus[[2999, 5]] = q[33]
        q[20] = q[3]                                 # duplicate queries
    elif name == "ragged_small":
        corpus[-20:] = 0xFFFFFFFF                    # sentinel rows
        q[0] = 0xFFFFFFFF
    return q, corpus, grid, chunk


K4_CASES = ("ties_in_range", "ties_across_ranges", "all_tied",
            "m_above_chunk", "ragged_small")


@pytest.mark.parametrize("name", K4_CASES)
def test_k4_decomposition_equals_plain(name):
    q, corpus, grid, chunk = _k4_case(name)
    got = k4_model(q, corpus, grid, chunk=chunk)
    want = hamming.corpus_min_distance_plain(_t(q), _t(corpus))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    if name == "all_tied":
        assert int(got[2].max()) == 0
    if name == "ties_in_range":
        assert list(got[2][:3]) == [9, 256 + 3, 600]
    if name == "ties_across_ranges":
        edge = 256 * (-(-corpus.shape[0] // 256) // grid)
        assert list(got[2][:3]) == [edge - 1, 100, edge - 256]


@pytest.mark.parametrize("grid", [1, 2, 7, 64])
def test_k4_decomposition_any_grid(grid):
    """The answer does not depend on how many CTAs share the corpus."""
    q, corpus, _, chunk = _k4_case("ties_across_ranges")
    got = k4_model(q, corpus, grid, chunk=chunk)
    want = hamming.corpus_min_distance_plain(_t(q), _t(corpus))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
