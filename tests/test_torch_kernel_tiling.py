"""The arithmetic decomposition of kernels K1, K3 and K4, modelled in numpy
and held against the port's plain versions, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
These models repeat, step by step, how each kernel splits its work, so
that a fault in the split (a band that misses a diagonal, a tie broken by
the wrong CTA, a ring slot overwritten too early) shows here without one:

- K3 (``csrc/fragment_search.cu``) at W = 2 (the 64-bit pHash): offset
  bands of 128, 64-row query tiles whose first one starts where its window
  row 0 is a multiple of 64, a 256-row ring of unpacked corpus rows that
  slides by 64 rows a tile and is read in 64-row pieces that never wrap,
  the threshold as dot >= 32 W - 2 thr, validity checked for matched pairs
  only, a warp's 16 x 64 block that matched whole counted once per band
  inside the valid rows and by interval ends at their edges, a per-band
  first-index argmax and the bands combined by the maximum 64-bit key.
- K3's tiles form (W = 1 and 3 to 23; phash256's W = 8): the plan's CTAs
  (video, band of diagonals, group of queries; ``align.k3_tiles_plan``),
  corpus tiles of N rows from a multiple of N over the rows the band
  touches, zero past the video's length, each unpacked once a CTA; per
  tile the 64-row query tiles of each query that touch the band, in
  order, taken by two warpgroups in turn; a warp's 16 x N block gated on
  its largest dot and then by 16 x 64 quarters, one that matched whole
  adding its trapezoid clipped to the valid rows and one that matched in
  part adding each matched pair inside the band and the valid rows; per
  query the CTA's maximum at its first diagonal, the CTAs combined by the
  maximum 64-bit key.
- K4 (``csrc/corpus_scan_tc.cu``): contiguous per-CTA ranges of 256-row
  tiles walked in ascending order, query chunks of 128, the rows each
  thread holds, rows past N masked (dot -32 W), per thread and query a
  running key (dot + 32 W) / 2 << shift | (low - row offset in the range),
  shift = 32 - bits(32 W) and low = 2^shift - 1 (25 at W = 2, 23 at W = 8),
  kept by its maximum, and the per-(CTA, query) 64-bit key combine.

- The word-chunked walks of rows wider than one pass of shared memory
  (TVIDZ_HASH_SIZE=32; up to W = 128 at TVIDZ_DCT_SIZE=64): K3 past 23
  words (tiles from t_begin with no ring, each 64-row window piece's dot
  summed over chunks of 16 words, the gate on the whole dot), K4 past 37
  (each 64-row wgmma's dot summed over chunks of 16 words, the epilogue on
  the whole dot; a grid that grows past the resident CTAs where a range
  would hold more rows than the key's row field), K2 at every W but 2
  (256 rows a CTA, 16 queries' distances summed over chunks of 32 words,
  keys (distance << 8 | row)).
- K1 (``csrc/fingerprint_block.cu``): S segments of T frames cut into
  contiguous per-CTA ranges; a range starting inside a segment also
  computes its predecessor's mafd (no hash), a segment's frame 0 takes the
  carry; a ring of three frame buffers; mafd as an exact integer sum; per
  row, lanes holding one 4-byte word and one byte of columns with their R
  rows permuted, a select-free reduce-scatter shuffle tree, L folded in row
  by row and the warps' sums added in warp order; the carry at valid_t - 1.
  Its second form (every geometry but 90x160 and its like): row bands of
  ``fused.k1_band_rows(H, W)`` rows, each band walked over a frame range by
  one CTA from a slot that holds the band's enclosing 16-byte chunks (any
  base, words read by a funnel shift), thread items of four columns over
  interleaved row groups folded left-first (L · X, then · Rᵀ), each half of
  the 64 sums reduce-scattered over a warp, warps and then bands added in
  order; exact per-(frame, band) SADs give every mafd, so a range's first
  score needs no frame read twice.

Tolerance: exact (integer counts and indices; K1's scores and carries),
and K1's hashes within 2 bits of the plain version's (float32 sums in
another order, tests/test_torch_fused.py).
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from tvidz_tpu_torch.ops import align, fused, hamming, phash

_NO_KEY = (1 << 64) - 1
_ZERO_KEY = 0x7FFFFFFF                  # score 0 at d = 0


def _pm1(packed):
    """(..., W) uint32 -> (..., 32 W) int64 ±1, MSB-first per word."""
    bits = np.unpackbits(packed.astype(">u4").view(np.uint8), axis=-1)
    return bits.astype(np.int64) * 2 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                            if a.dtype == np.uint32 else a)


# -- K3 -----------------------------------------------------------------------


def k3_model(qs, q_lens, corpus, lens, thr, band=128, tile=64, ring=256,
             stats=None, word_chunk=None):
    """(Q, V) offsets and scores as K3 computes them; ``stats`` counts the
    warp blocks counted pair by pair and those that matched whole. With
    ``word_chunk`` (the chunked instance, W > 23): tiles start at t_begin
    with no ring, and each 64-row piece's dots are summed over chunks of
    that many words before the gate."""
    stats = {"all_matched": 0, "pairwise": 0} if stats is None else stats
    nq, tq_pad, words = qs.shape
    nv, tc, _ = corpus.shape
    bits = 32 * words
    win = -(-(tile + band - 1) // 64) * 64          # whole 64-row pieces
    thr = min(max(thr, -1), bits)
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
                slots = np.zeros((ring, bits), np.int64)
                t_first = t_begin - (t_begin + o0) % 64
                if word_chunk:
                    t_first = t_begin
                have = None
                for t0 in range(t_first, t_end, tile):
                    j0 = t0 + o0
                    t = t0 + np.arange(tile)
                    ok_t = (t >= 0) & (t < q_len)
                    a = np.zeros((tile, bits), np.int64)
                    a[ok_t] = q_pm1[q, t[ok_t]]
                    if word_chunk:
                        # No ring: each piece's window rows unpacked anew.
                        j = j0 + np.arange(win)
                        ok_j = (j >= 0) & (j < c_len)
                        w = np.zeros((win, bits), np.int64)
                        w[ok_j] = c_pm1[v, j[ok_j]]
                        dots = sum(a[:, c:c + 32 * word_chunk]
                                   @ w[:, c:c + 32 * word_chunk].T
                                   for c in range(0, bits, 32 * word_chunk))
                    else:
                        assert j0 % 64 == 0 and all(
                            (j0 + p) % ring + 64 <= ring for p in range(0, win, 64))
                        for j in range(j0 if have is None else max(j0, have),
                                       j0 + win):
                            slots[j % ring] = c_pm1[v, j] if 0 <= j < c_len else 0
                        have = j0 + win
                        w = slots[(j0 + np.arange(win)) % ring]
                        dots = a @ w.T
                    matched = dots >= bits - 2 * thr
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


def k3_tiles_walk(q_lens, tq_pad, lens, tc, rows, band, q_group):
    """K3's tiles form's CTAs in its grid, (v, d0, d1, queries, tiles),
    each tile (j0, items) with its items (query, t0) in the order the two
    warpgroups take them in turn: corpus tiles of ``rows`` rows from a
    multiple of ``rows`` over the rows the band's pairs touch, and per tile
    each query's 64-row tiles that touch the band."""
    nq, nd = len(q_lens), tq_pad + tc - 1
    for v, b, gq in np.ndindex(len(lens), -(-nd // band), -(-nq // q_group)):
        d0 = b * band
        d1 = min(nd, d0 + band)
        o0, o1 = d0 - (tq_pad - 1), d1 - tq_pad
        queries = range(gq * q_group, min(nq, (gq + 1) * q_group))
        c_len = min(max(int(lens[v]), 0), tc)
        ql = {q: min(max(int(q_lens[q]), 0), tq_pad) for q in queries}
        q_max = max(ql.values())
        j_lo, j_hi = max(0, o0), min(c_len, q_max + o1)
        if q_max == 0 or j_lo >= j_hi:
            continue
        tiles = []
        for j0 in range(j_lo - j_lo % rows, j_hi, rows):
            items = []
            for q in queries:
                t_lo, t_hi = max(0, j0 - o1), min(ql[q], j0 - o0 + rows)
                items += [(q, t0) for t0 in range(t_lo - t_lo % 64, t_hi, 64)]
            tiles.append((j0, items))
        yield v, d0, d1, list(queries), tiles


def k3_tiles_model(qs, q_lens, corpus, lens, thr, n_sm=132, plan=None,
                   stats=None):
    """(Q, V) offsets and scores as K3's tiles form computes them, with the
    plan ``align.k3_tiles_plan`` gives on ``n_sm`` SMs or ``plan`` = (band,
    q_group) given. ``stats`` counts pairs multiplied, corpus rows unpacked,
    items a warpgroup, and warp quarters (16 x 64) taken whole and pair by
    pair."""
    stats = {} if stats is None else stats
    for k in ("pairs", "unpacked", "whole", "pairwise", "items_wg0", "items_wg1"):
        stats.setdefault(k, 0)
    nq, tq_pad, words = qs.shape
    nv, tc, _ = corpus.shape
    bits = 32 * words
    thr = min(max(thr, -1), bits)
    thr_dot = bits - 2 * thr
    rows, band, qg, _, _, _ = align.k3_tiles_plan(nq, tq_pad, nv, tc, words, n_sm)
    if plan is not None:
        band, qg = plan
    # float32 products: exact, |dot| <= 32 W <= 736.
    q_pm1, c_pm1 = _pm1(qs).astype(np.float32), _pm1(corpus).astype(np.float32)
    ql = [min(max(int(n), 0), tq_pad) for n in q_lens]
    keys = np.full((nq, nv), _ZERO_KEY, dtype=object)
    rr, cc = np.meshgrid(np.arange(64), np.arange(rows), indexing="ij")
    for v, d0, d1, queries, tiles in k3_tiles_walk(q_lens, tq_pad, lens, tc,
                                                   rows, band, qg):
        c_len = min(max(int(lens[v]), 0), tc)
        cnt = {q: np.zeros(d1 - d0, np.int64) for q in queries}
        item = 0
        for j0, items in tiles:
            # The ring stage: rows j0 .. j0 + N - 1, zero past c_len.
            stage = np.zeros((rows, bits), np.float32)
            n = min(rows, c_len - j0)
            stage[:n] = c_pm1[v, j0:j0 + n]
            stats["unpacked"] += rows
            for q, t0 in items:
                stats[f"items_wg{item % 2}"] += 1
                item += 1
                a = np.zeros((64, bits), np.float32)
                m = max(0, min(64, ql[q] - t0))
                a[:m] = q_pm1[q, t0:t0 + m]
                matched = a @ stage.T >= thr_dot
                stats["pairs"] += 64 * rows
                base = j0 - t0 + (tq_pad - 1) - d0
                # Per warp, a 16 x N block by 16 x 64 quarters.
                for wq, p in np.ndindex(4, rows // 64):
                    r0, c0 = 16 * wq, 64 * p
                    blk = matched[r0:r0 + 16, c0:c0 + 64]
                    if not blk.any():              # the warp vote's skip
                        continue
                    if blk.all():
                        stats["whole"] += 1
                        r_hi = min(r0 + 16, ql[q] - t0)
                        c_hi = min(c0 + 64, c_len - j0)
                        for x in range(c0 - r_hi + 1, c_hi - r0):
                            k = min(r_hi, c_hi - x) - max(r0, c0 - x)
                            if 0 <= base + x < d1 - d0 and k > 0:
                                cnt[q][base + x] += k
                    else:
                        stats["pairwise"] += 1
                        sub = (slice(r0, r0 + 16), slice(c0, c0 + 64))
                        r, c = rr[sub], cc[sub]
                        dd = base + c - r
                        ok = (blk & (dd >= 0) & (dd < d1 - d0)
                              & (t0 + r < ql[q]) & (j0 + c < c_len))
                        np.add.at(cnt[q], dd[ok], 1)
        for q in queries:
            best = int(cnt[q].max())
            if best > 0:
                d = d0 + int(np.argmax(cnt[q]))         # first index
                keys[q, v] = max(keys[q, v], (best << 32) | (0x7FFFFFFF - d))
    scores = np.array([[k >> 32 for k in row] for row in keys], np.int32)
    offs = np.array([[(0x7FFFFFFF - (k & 0xFFFFFFFF)) - (tq_pad - 1)
                      for k in row] for row in keys], np.int32)
    return offs, scores


def _k3_case(name, seed=3, words=2):
    """(qs, q_lens, corpus, lens, thr) of one named case."""
    rng = np.random.default_rng(seed)
    nq, tq_pad, nv, tc, thr = 2, 150, 5, 260, 10
    if name == "not_band_multiple":
        tq_pad, tc = 97, 171               # 97 + 171 - 1 = 267, not k * 128
    corpus = rng.integers(0, 2 ** 32, size=(nv, tc, words), dtype=np.uint32)
    qs = rng.integers(0, 2 ** 32, size=(nq, tq_pad, words), dtype=np.uint32)
    lens = np.full(nv, tc, np.int32)
    q_lens = np.full(nq, tq_pad, np.int32)
    if name == "periodic":
        # Period 20: query 0 ties at every 20th offset, across bands.
        corpus[1] = np.resize(corpus[1, :20], (tc, words))
        qs[0] = np.resize(corpus[1, 3:23], (tq_pad, words))
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


@pytest.mark.parametrize("name,thr", [("periodic", 10), ("short_rows", 10),
                                      ("thr40", 40), ("thr40", 100),
                                      ("identical", 10), ("static_runs", 10)])
def test_k3_decomposition_equals_plain_w8(name, thr):
    """K3's tiles form at W = 8 (phash256): 256-term dots, the threshold at
    256 - 2 thr, the plan's own CTAs (one band, a query a CTA here)."""
    qs, q_lens, corpus, lens, _ = _k3_case(name, words=8)
    offs, scores = k3_tiles_model(qs, q_lens, corpus, lens, thr)
    want_o, want_s = align.fragment_search_batch_plain(
        _t(qs), _t(q_lens), _t(corpus), _t(lens), thr)
    assert np.array_equal(offs, want_o.numpy())
    assert np.array_equal(scores, want_s.numpy())


@pytest.mark.parametrize("words", [26, 32, 42, 128])
@pytest.mark.parametrize("name,thr", [("periodic", 10), ("short_rows", 10),
                                      ("thr40", 40), ("static_runs", 10),
                                      ("not_band_multiple", 10)])
def test_k3_chunked_decomposition_equals_plain(name, thr, words):
    """K3's word-chunked instance: tiles from t_begin, the dot of each
    piece summed over chunks of 16 words, the gate and the counts on the
    whole dot; whole-block matches (static runs) included."""
    qs, q_lens, corpus, lens, _ = _k3_case(name, words=words)
    stats = {"all_matched": 0, "pairwise": 0}
    offs, scores = k3_model(qs, q_lens, corpus, lens, thr, word_chunk=16,
                            stats=stats)
    want_o, want_s = align.fragment_search_batch_plain(
        _t(qs), _t(q_lens), _t(corpus), _t(lens), thr)
    assert np.array_equal(offs, want_o.numpy())
    assert np.array_equal(scores, want_s.numpy())
    if name == "static_runs":
        assert stats["all_matched"] > 0


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


@pytest.mark.parametrize("words,thr", [(8, 10), (8, 40), (3, 0), (23, 32 * 23)])
@pytest.mark.parametrize("name", K3_CASES)
def test_k3_tiles_decomposition_equals_plain(name, words, thr):
    """K3's tiles form on its own plan at W = 3, 8 and 23 (N = 256, 256,
    64): queries of different lengths padded to one Tq_pad, corpus lengths
    that are no multiple of N, identical rows and still runs, thresholds
    from 0 to 32 W."""
    qs, q_lens, corpus, lens, _ = _k3_case(name, words=words)
    offs, scores = k3_tiles_model(qs, q_lens, corpus, lens, thr)
    want_o, want_s = align.fragment_search_batch_plain(
        _t(qs), _t(q_lens), _t(corpus), _t(lens), thr)
    assert np.array_equal(offs, want_o.numpy())
    assert np.array_equal(scores, want_s.numpy())


@pytest.mark.parametrize("plan", [(100, 1), (37, 2), (409, 2)], ids=str)
@pytest.mark.parametrize("name", ["periodic", "short_rows", "static_runs",
                                  "not_band_multiple"])
def test_k3_tiles_split_plans_equal_plain(name, plan):
    """Plans of (band, queries a CTA) that split each diagonal row across
    CTAs (100 and 37 diagonals, which no tile aligns with) and group the
    queries, at W = 8."""
    qs, q_lens, corpus, lens, thr = _k3_case(name, words=8)
    offs, scores = k3_tiles_model(qs, q_lens, corpus, lens, thr, plan=plan)
    want_o, want_s = align.fragment_search_batch_plain(
        _t(qs), _t(q_lens), _t(corpus), _t(lens), thr)
    assert np.array_equal(offs, want_o.numpy())
    assert np.array_equal(scores, want_s.numpy())


@pytest.mark.parametrize("name", ["periodic", "identical", "static_runs"])
def test_k3_tiles_one_word_rows(name):
    """W = 1 (32-term dots) takes the tiles form too."""
    qs, q_lens, corpus, lens, _ = _k3_case(name, words=1)
    offs, scores = k3_tiles_model(qs, q_lens, corpus, lens, 4)
    want_o, want_s = align.fragment_search_batch_plain(
        _t(qs), _t(q_lens), _t(corpus), _t(lens), 4)
    assert np.array_equal(offs, want_o.numpy())
    assert np.array_equal(scores, want_s.numpy())


def test_k3_tiles_periodic_maxima_in_different_ctas():
    """The periodic case's tied maxima fall in different CTAs of a plan of
    100-diagonal bands, and the combine keeps the first."""
    qs, q_lens, corpus, lens, thr = _k3_case("periodic", words=8)
    n = int(q_lens[0])
    s = align.align_scores(_t(qs[0, :n]), _t(corpus[1]), thr).numpy()
    offsets = np.flatnonzero(s == s.max()) - (n - 1)
    assert len({(int(o) + qs.shape[1] - 1) // 100 for o in offsets}) > 1
    offs, _ = k3_tiles_model(qs, q_lens, corpus, lens, thr, plan=(100, 1))
    assert offs[0, 1] == offsets[0]


@pytest.mark.parametrize("name,whole,in_part", [
    ("identical", True, True), ("static_runs", True, True),
    ("periodic", False, True)])
def test_k3_tiles_block_paths_are_taken(name, whole, in_part):
    """The tiles form's counting paths: whole 16 x 64 quarters (identical
    rows, still runs) and quarters that match in part; the two warpgroups
    share the items to within one."""
    stats = {}
    qs, q_lens, corpus, lens, thr = _k3_case(name, words=8)
    k3_tiles_model(qs, q_lens, corpus, lens, thr, plan=(409, 2), stats=stats)
    assert (stats["whole"] > 0) == whole
    assert (stats["pairwise"] > 0) == in_part
    assert 0 <= stats["items_wg0"] - stats["items_wg1"] <= 1


def _cell_request(seed=15):
    """A request of the fragment-search cell: 4 span lengths (log-uniform
    in 256 .. 1,024) padded to one Tq_pad, and its two buckets (V, Tc)."""
    rng = np.random.default_rng(seed)
    q_lens = np.exp(rng.uniform(np.log(256), np.log(1024), 4)).astype(int)
    return q_lens, -(-int(q_lens.max()) // 64) * 64, ((4080, 4096), (64, 1024))


@pytest.mark.parametrize("seed", [15, 16, 17])
def test_k3_tiles_multiplies_each_pair_about_once_at_the_cell(seed):
    """At the cell's shapes the plan gives one CTA a video and every query
    (the catalog) or one a query (64 sources), one band of whole diagonal
    rows, shared memory within a block's; the pairs multiplied are at most
    1.15 times the pairs ``peaks.align_ops`` counts, and each corpus row is
    unpacked once a CTA."""
    q_lens, tq_pad, buckets = _cell_request(seed)
    multiplied = counted = 0
    for v, tc in buckets:
        rows, band, qg, bands, groups, smem = align.k3_tiles_plan(
            4, tq_pad, v, tc, 8, 132)
        assert (rows, band, bands) == (256, tq_pad + tc - 1, 1)
        assert (qg, groups) == ((4, 1) if v == 4080 else (1, 4))
        assert smem <= 232448 - 1024
        # Every video has Tc rows: one CTA per (video, group) stands for all.
        for _, _, _, _, tiles in k3_tiles_walk(q_lens, tq_pad, [tc], tc, rows,
                                               band, qg):
            assert [j0 for j0, _ in tiles] == list(range(0, tc, rows))
            multiplied += v * 64 * rows * sum(len(items) for _, items in tiles)
        counted += int(q_lens.sum()) * v * tc
    assert multiplied <= 1.15 * counted


def test_k3_tiles_plan_fits_and_covers():
    """For every W of the form and shapes from one query to 65,535, from
    one video to thousands and to 32,768-frame videos: the bands cover the
    diagonals, the groups the queries, shared memory fits a block, and the
    grid holds a CTA for every SM where the work allows."""
    for words in (1, 3, 7, 8, 9, 16, 17, 23):
        for q, tq_pad, v, tc in [(4, 1024, 4080, 4096), (4, 1024, 64, 1024),
                                 (1, 768, 1024, 1024), (4, 1024, 100, 32768),
                                 (3, 320, 37, 1024), (1, 64, 1, 256),
                                 (65535, 64, 3, 256), (1, 16512, 2, 4096)]:
            rows, band, qg, bands, groups, smem = align.k3_tiles_plan(
                q, tq_pad, v, tc, words, 132)
            nd = tq_pad + tc - 1
            assert rows == (256 if words <= 8 else 128 if words <= 16 else 64)
            assert band * bands >= nd > band * (bands - 1)
            assert qg * groups >= q > qg * (groups - 1)
            assert smem <= 232448 - 1024
            assert groups * v * bands >= 132 or (qg == 1 and band <= max(512, -(-nd // 2)))


def test_k3_form_by_word_width():
    """``align.k3_form`` mirrors the C entry point's choice by W."""
    assert align.k3_form(2) == "bands"
    assert [align.k3_form(w) for w in (1, 3, 8, 23)] == ["tiles"] * 4
    assert [align.k3_form(w) for w in (24, 32, 128)] == ["chunked"] * 3
    for bad in (0, align.K3_MAX_WORDS + 1):
        with pytest.raises(ValueError):
            align.k3_form(bad)


@pytest.mark.parametrize("words", [2, 8, 23, 32])
def test_k3_counts_each_launch_under_its_form(words, monkeypatch):
    """A launch through the wrapper counts once in ``K3.launches`` and once
    under its form (the C call itself stubbed: there is no card here), and
    passes the tiles form the band and query group of ``k3_tiles_plan``;
    ``reset_launch_counts`` clears both counts."""
    from tvidz_tpu_torch import backend

    calls = []
    monkeypatch.setattr(align.K3, "call", lambda fn, *a: calls.append((fn, a)))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(backend, "stream_ptr", lambda d: None)
    qs, q_lens, corpus, lens, thr = _k3_case("short_rows", words=words)
    before, forms = align.K3.launches, dict(align.K3.form_launches)
    align._fragment_search_cuda(_t(qs), _t(q_lens), _t(corpus), _t(lens), thr)
    form = align.k3_form(words)
    assert [fn for fn, _ in calls] == ["tvz_fragment_search"]
    assert align.K3.launches == before + 1
    plan = (align.k3_tiles_plan(*qs.shape[:2], *corpus.shape[:2], words, 132)[1:3]
            if form == "tiles" else (0, 0))
    assert tuple(calls[0][1][10:12]) == plan
    assert align.K3.form_launches[form] == forms.get(form, 0) + 1
    backend.reset_launch_counts()
    assert align.K3.launches == 0 and not align.K3.form_launches


# -- K4 -----------------------------------------------------------------------


def _key_form(words):
    """K4's KeyForm: (shift, low) of the running key at W words."""
    shift = 32 - (32 * words).bit_length()
    return shift, (1 << shift) - 1


def k4_grid(n, words, ctas, tile=256):
    """The grid K4 launches for an n-row corpus (grid_for): the resident
    CTAs ``ctas``, at most one a tile, and at least as many as keep every
    range's rows below the key's row field."""
    tiles = -(-n // tile)
    range_tiles = (_key_form(words)[1] - 1) // tile
    return max(min(tiles, ctas), -(-tiles // range_tiles))


def k4_model(q, corpus, grid, tile=256, chunk=128, word_chunk=None):
    """(frame_min, q_min, q_arg) as K4 computes them on ``grid`` CTAs; with
    ``word_chunk`` (the chunked instance, W > 37) each dot is summed over
    chunks of that many words before the epilogue."""
    m, n = q.shape[0], corpus.shape[0]
    bits = 32 * q.shape[1]
    shift, low = _key_form(q.shape[1])
    q_pm1, c_pm1 = _pm1(q), _pm1(corpus)
    tiles = -(-n // tile)
    ctas = min(tiles, grid)
    assert -(-tiles // ctas) * tile < low            # a row offset below low
    step = 32 * (word_chunk or q.shape[1])
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
            # Running key per (query, thread); 0 before any row.
            best = np.zeros((qc.shape[0], 32), np.int64)
            for tl in range(lo, hi):                    # ascending
                rows = tl * tile + r
                valid = rows < n
                block = np.zeros((tile, bits), np.int64)
                block[valid] = c_pm1[rows[valid]]
                dots = np.where(valid, sum(qc[:, c:c + step] @ block[:, c:c + step].T
                                           for c in range(0, bits, step)), -bits)
                fm = (bits - dots.max(axis=0)[valid]) >> 1
                frame_min[rows[valid]] = fm if q0 == 0 else np.minimum(
                    frame_min[rows[valid]], fm)
                key = np.where(valid, (((dots + bits) >> 1) << shift)
                               | (low - (rows - range_base)), 0)
                assert key.max() < 1 << 32
                for th in range(32):
                    best[:, th] = np.maximum(best[:, th],
                                             key[:, thread == th].max(axis=1))
            for i in range(qc.shape[0]):
                cand = [((bits - (int(k) >> shift)) << 32)
                        | (range_base + low - (int(k) & low))
                        for k in best[i] if k != 0]
                keys[q0 + i] = min(keys[q0 + i], min(cand))
    q_min = np.array([k >> 32 for k in keys], np.int32)
    q_arg = np.array([k & 0xFFFFFFFF for k in keys], np.int32)
    return frame_min.astype(np.int32), q_min, q_arg


def _k4_case(name, seed=17, words=2):
    """(q, corpus, grid, chunk) of one named case."""
    rng = np.random.default_rng(seed)
    m, n, grid, chunk = 24, 3000, 3, 128
    if name == "m_above_chunk":
        m, chunk = 40, 16
    if name == "ragged_small":
        n, grid = 301, 5                  # two tiles, fewer than the grid
    corpus = rng.integers(0, 2 ** 32, size=(n, words), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(m, words), dtype=np.uint32)
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


@pytest.mark.parametrize("words", [2, 8])
@pytest.mark.parametrize("name", K4_CASES)
def test_k4_decomposition_equals_plain(name, words):
    q, corpus, grid, chunk = _k4_case(name, words=words)
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


def test_k4_key_forms():
    """The key keeps (dot + 32 W) / 2 above the row offset at every W a
    configuration reaches (to 128) and at the kernel's limit, with at least
    one 256-row tile in the row field, and the W = 2 key is the production
    one, (dot + 64) << 24 above a 25-bit row field."""
    assert _key_form(2) == (25, (1 << 25) - 1)
    assert _key_form(8) == (23, (1 << 23) - 1)
    assert _key_form(128) == (19, (1 << 19) - 1)
    for words in [*range(1, 129), hamming.K4_MAX_WORDS]:
        shift, low = _key_form(words)
        assert (32 * words) << shift < 1 << 32 and low - 1 >= 256


@pytest.mark.parametrize("words,n,ctas", [(2, 1 << 27, 396), (128, 1 << 27, 132),
                                          (128, 1 << 27, 396), (4096, 1 << 24, 132)])
def test_k4_grid_keeps_ranges_below_the_key(words, n, ctas):
    """At wide W on a large corpus a range of the resident grid would hold
    more rows than the key's row field (W = 128, 2^27 rows over 132 CTAs:
    1M rows against 524,287): the grid grows, and every range fits."""
    grid = k4_grid(n, words, ctas)
    tiles = -(-n // 256)
    assert -(-tiles // grid) * 256 < _key_form(words)[1]
    assert grid == min(tiles, ctas) or -(-tiles // ctas) * 256 >= _key_form(words)[1]
    if (words, ctas) == (128, 132):
        assert grid > ctas


@pytest.mark.parametrize("words", [42, 128])
@pytest.mark.parametrize("name", K4_CASES)
def test_k4_chunked_decomposition_equals_plain(name, words):
    """K4's word-chunked instance: dots summed over chunks of 16 words,
    the epilogue (frame_min, keys) on the whole dot, ties at the range
    edges included."""
    q, corpus, grid, chunk = _k4_case(name, words=words)
    got = k4_model(q, corpus, grid, chunk=chunk, word_chunk=16)
    want = hamming.corpus_min_distance_plain(_t(q), _t(corpus))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    if name == "ties_across_ranges":
        edge = 256 * (-(-corpus.shape[0] // 256) // grid)
        assert list(got[2][:3]) == [edge - 1, 100, edge - 256]


def k2_chunked_model(q, corpus, rows=256, q_chunk=16, word_chunk=32):
    """(frame_min, q_min, q_arg) as K2's chunked instance (every W but 2)
    computes them:
    CTAs of ``rows`` rows, ``q_chunk`` queries' distances summed over
    chunks of ``word_chunk`` words, per (CTA, query) the warp minimum of
    (distance << 8 | row in the CTA), the CTAs combined by the minimum of
    (distance << 32 | row)."""
    m, n = q.shape[0], corpus.shape[0]
    frame_min = np.full(n, 1 << 30, np.int64)
    keys = np.full(m, _NO_KEY, dtype=object)
    popc = np.vectorize(lambda x: bin(int(x)).count("1"))
    for base in range(0, n, rows):
        c = corpus[base:base + rows].astype(np.uint64)
        for q0 in range(0, m, q_chunk):
            qc = q[q0:q0 + q_chunk].astype(np.uint64)
            d = np.zeros((qc.shape[0], c.shape[0]), np.int64)
            for w0 in range(0, q.shape[1], word_chunk):
                x = qc[:, None, w0:w0 + word_chunk] ^ c[None, :, w0:w0 + word_chunk]
                d += popc(x).sum(axis=-1)
            frame_min[base:base + c.shape[0]] = np.minimum(
                frame_min[base:base + c.shape[0]], d.min(axis=0))
            local = (d << 8) | np.arange(c.shape[0])[None, :]
            for i, lk in enumerate(local.min(axis=1)):
                g = ((int(lk) >> 8) << 32) | (base + (int(lk) & 0xFF))
                keys[q0 + i] = min(keys[q0 + i], g)
    return (frame_min.astype(np.int32),
            np.array([k >> 32 for k in keys], np.int32),
            np.array([k & 0xFFFFFFFF for k in keys], np.int32))


@pytest.mark.parametrize("words", [1, 3, 8, 42, 128])
def test_k2_chunked_decomposition_equals_plain(words):
    rng = np.random.default_rng(23 + words)
    q = rng.integers(0, 2 ** 32, size=(20, words), dtype=np.uint32)
    corpus = rng.integers(0, 2 ** 32, size=(600, words), dtype=np.uint32)
    corpus[[511, 256, 3]] = q[1]                     # ties across CTAs
    corpus[[300, 299]] = q[17] ^ np.uint32(1)        # in the second chunk of queries
    got = k2_chunked_model(q, corpus)
    want = hamming.corpus_min_distance_plain(_t(q), _t(corpus))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert (got[2][1], got[2][17]) == (3, 299)


@pytest.mark.parametrize("words", [2, 3, 8])
@pytest.mark.parametrize("grid", [1, 2, 7, 64])
def test_k4_decomposition_any_grid(grid, words):
    """The answer does not depend on how many CTAs share the corpus."""
    q, corpus, _, chunk = _k4_case("ties_across_ranges", words=words)
    got = k4_model(q, corpus, grid, chunk=chunk)
    want = hamming.corpus_min_distance_plain(_t(q), _t(corpus))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


# -- K1 -----------------------------------------------------------------------

_LANES = np.arange(32)


def k1_plan(s, t, grid):
    """Per CTA of a K1 launch over S segments of T frames: (lo, hi, k0,
    the source of frame k0's predecessor: "carry" or "load")."""
    n = s * t
    plan = []
    for c in range(min(grid, n)):
        lo, hi = n * c // min(grid, n), n * (c + 1) // min(grid, n)
        k0 = lo - 1 if lo % t else lo
        plan.append((lo, hi, k0, "carry" if k0 % t == 0 else "load"))
    return plan


def _fma(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _project(frame, left, right):
    """(64,) float32 low coefficients of one (H, W) frame as K1 sums them."""
    h_, w_ = frame.shape
    perm = _LANES >> 2
    cols = [4 * _LANES + c for c in range(4)] + [128 + _LANES]
    # rw[c][lane, q] = R[q ^ perm][col], 0 past W.
    rw = [np.where((col < w_)[:, None],
                   right[(np.arange(8)[None, :] ^ perm[:, None]),
                         np.minimum(col, w_ - 1)[:, None]], np.float32(0))
          for col in cols]
    left_t = left.T
    part = np.zeros((8, 64), np.float32)
    for warp in range(8):
        low0 = np.zeros(32, np.float32)
        low1 = np.zeros(32, np.float32)
        for h in range(warp, h_, 8):
            x = [np.where(col < w_, frame[h, np.minimum(col, w_ - 1)], 0)
                 .astype(np.float32) for col in cols]
            a = (x[0][:, None] * rw[0]).astype(np.float32)
            for c in range(1, 5):
                a = _fma(x[c][:, None], rw[c], a)
            for off, half in ((16, 4), (8, 2)):
                a = (a[:, :half] + a[_LANES ^ off, half:2 * half]).astype(np.float32)
            d = (a[:, 0] + a[_LANES ^ 4, 1]).astype(np.float32)
            d = (d + d[_LANES ^ 2]).astype(np.float32)
            d = (d + d[_LANES ^ 1]).astype(np.float32)
            j = _LANES & 3
            low0 = _fma(left_t[h, 2 * j], d, low0)
            low1 = _fma(left_t[h, 2 * j + 1], d, low1)
        part[warp, 2 * (_LANES & 3) * 8 + perm] = low0
        part[warp, (2 * (_LANES & 3) + 1) * 8 + perm] = low1
    low = part[0].copy()
    for warp in range(1, 8):
        low = (low + part[warp]).astype(np.float32)
    return low


def k1_ranges(n, ranges):
    """K1's second form: the (lo, hi) frame ranges of a launch with
    ``ranges`` ranges of each band (a range's first predecessor band is the
    carry's at a segment's frame 0, else frame lo - 1's, loaded)."""
    r = min(ranges, n)
    return [(n * c // r, n * (c + 1) // r) for c in range(r)]


def k1_bands(h, w, band_rows=None):
    """[(h0, rows)] of K1's second form: bands of ``fused.k1_band_rows``
    rows (the last may be shorter); ``band_rows`` overrides it, to model
    several bands at the tests' small geometries."""
    rows = band_rows or fused.k1_band_rows(h, w)
    return [(h0, min(rows, h - h0)) for h0 in range(0, h, rows)]


def _slot(flat, start, nbytes):
    """(slot, head) as one bulk copy lands bytes [start, start + nbytes) of
    ``flat`` (16-byte aligned at index 0): the 16-byte chunks holding them,
    then 48 bytes the copy does not write (stale: 0xA5 here)."""
    a, e = start & ~15, (start + nbytes + 15) & ~15
    return np.concatenate([flat[a:e], np.full(48, 0xA5, np.uint8)]), start & 15


def _words_at(slot, offs):
    """The little-endian word at each byte offset of ``offs`` (any
    alignment): two aligned words and a funnel shift."""
    s32 = slot.view("<u4").astype(np.uint64)
    lo, hi = s32[offs >> 2], s32[(offs >> 2) + 1]
    return (((hi << np.uint64(32)) | lo) >> (np.uint64(8) * (offs & 3).astype(np.uint64))
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _bytes_of(words):
    return words.view(np.uint8).reshape(-1, 4)


def _band_sums(cur, cur_head, pred, pred_head, left_band, right, w):
    """(64,) float32 sums of L[:, band] · X[band] · Rᵀ and the exact SAD of
    one band, as K1's second form computes them: thread item (g, cw) takes
    columns 4cw..4cw+3 of rows g, g + G, ... (G = 256 // words, at least
    1; items past 256 go round again); u[j][c] = L[j][h] x summed by FMA in
    row order; per half, v[j][qq] = sum_c u[j][c] R[4 half + qq][c] by FMA
    in column order; reduce-scattered over each warp's 32 lanes and added
    to the rounds' running sum; the warps added in order."""
    rows = left_band.shape[1]
    ncw = -(-w // 4)
    groups = max(1, 256 // ncw)
    items = groups * ncw
    lanes = np.arange(32)
    acc = np.zeros((2, 8, 32), np.float32)
    sad = 0
    for base in range(0, items, 256):
        it = base + np.arange(256)
        has = it < items
        g = np.where(has, it // ncw, 0)
        c0 = np.where(has, 4 * (it - g * ncw), 0)
        valid = np.where(has, np.minimum(4, w - c0), 0)
        mask = np.where(valid > 0, (0xFFFFFFFF >> (8 * (4 - np.maximum(valid, 1)))),
                        0).astype(np.uint32)
        u = np.zeros((256, 8, 4), np.float32)
        for step in range(-(-rows // groups)):
            hh = g + step * groups
            act = has & (hh < rows)
            hc = np.where(act, hh, 0)
            wc = _words_at(cur, cur_head + hc * w + c0) & mask
            wp = _words_at(pred, pred_head + hc * w + c0) & mask
            diff = np.abs(_bytes_of(wc).astype(np.int64) - _bytes_of(wp).astype(np.int64))
            sad += int(diff[act].sum())
            x = _bytes_of(wc).astype(np.float32)
            lt = left_band[:, hc].T
            new = _fma(lt[:, :, None], x[:, None, :], u)
            u = np.where(act[:, None, None], new, u)
        for half in range(2):
            v = np.zeros((256, 8, 4), np.float32)
            for c in range(4):
                ok = c < valid
                col = np.where(ok, c0 + c, 0)
                r = np.where(ok[:, None], right[4 * half:4 * half + 4, col].T, np.float32(0))
                new = _fma(u[:, :, c][:, :, None], r[:, None, :], v)
                v = np.where(ok[:, None, None], new, v)
            x = v.reshape(8, 32, 32)
            for off in (16, 8, 4, 2, 1):
                x = (x + x[:, lanes ^ off]).astype(np.float32)
            acc[half] = (acc[half] + x[:, 0]).astype(np.float32)
    red = np.zeros((8, 64), np.float32)
    for half in range(2):
        # lane l holds (j, qq) = (l >> 2, l & 3) of the half
        red[:, (lanes >> 2) * 8 + 4 * half + (lanes & 3)] = acc[half]
    band = red[0].copy()
    for warp in range(1, 8):
        band = (band + red[warp]).astype(np.float32)
    return band, sad


def k1_bands_model(lumas, carries, valid_ts, left, right, ranges, band_rows=None,
                   base_offset=0, trace=None):
    """(scores (S, T), fps (S, T, 2) uint32, new carries) as K1's second
    form computes them with ``ranges`` frame ranges of each band: CTA
    (band, range) walks its band of the range's frames, the predecessor's
    band kept (a segment's frame 0: the carry's band); each segment's
    frames lie at byte ``base_offset`` of a buffer of stale bytes; per
    (frame, band) 64 sums and a SAD, written once, combined in band order;
    a frame's score from its own and its predecessor's masked mafd. With
    ``trace`` (a list), appends (frame, band, predecessor source)."""
    s_, t_, h_, w_ = lumas.shape
    n, hw = s_ * t_, h_ * w_
    bands = k1_bands(h_, w_, band_rows)
    rng = np.random.default_rng(5)
    flats = [np.concatenate([rng.integers(0, 256, base_offset, dtype=np.uint8),
                             x.reshape(-1), rng.integers(0, 256, 64, dtype=np.uint8)])
             for x in lumas]
    part = np.full((n, len(bands), 64), np.nan, np.float32)
    sad = np.full((n, len(bands)), -1, np.int64)
    new_frames = [np.full((h_, w_), np.nan, np.float32) for _ in range(s_)]

    def carry_slot(seg, h0, rows):
        band = carries[seg][0][h0:h0 + rows].astype(np.uint8).reshape(-1)
        pad = (-band.size) % 16 + 48
        return np.concatenate([band, np.full(pad, 0xA5, np.uint8)]), 0

    for lo, hi in k1_ranges(n, ranges):
        for b, (h0, rows) in enumerate(bands):
            nbytes = rows * w_
            seg, t = divmod(lo, t_)
            pred = (carry_slot(seg, h0, rows) if t == 0 else
                    _slot(flats[seg], base_offset + (t - 1) * hw + h0 * w_, nbytes))
            for k in range(lo, hi):
                seg, t = divmod(k, t_)
                if k > lo and t == 0:
                    pred = carry_slot(seg, h0, rows)
                if trace is not None:
                    trace.append((k, b, "carry" if t == 0 else
                                  "load" if k == lo else "ring"))
                cur = _slot(flats[seg], base_offset + t * hw + h0 * w_, nbytes)
                assert sad[k, b] == -1, "a (frame, band) computed twice"
                part[k, b], sad[k, b] = _band_sums(*cur, *pred, left[:, h0:h0 + rows],
                                                   right, w_)
                if t == valid_ts[seg] - 1:
                    new_frames[seg][h0:h0 + rows] = (
                        cur[0][cur[1]:cur[1] + nbytes].reshape(rows, w_))
                pred = cur
    assert (sad >= 0).all()
    low = part[:, 0].copy()
    for b in range(1, len(bands)):
        low = (low + part[:, b]).astype(np.float32)
    scores = np.zeros((s_, t_), np.float32)
    mafd = np.zeros(n, np.float32)
    new = [None] * s_
    for k in range(n):
        seg, t = divmod(k, t_)
        fresh, carried = not carries[seg][2], np.float32(carries[seg][1])
        start = t == 0 and fresh
        m = np.float32(0) if start else np.float32(sad[k].sum()) / np.float32(hw)
        mafd[k] = m
        pm = carried if t == 0 else mafd[k - 1]
        sc = np.minimum(m, np.abs(m - pm)) / np.float32(100)
        scores[seg, t] = 0 if start else np.clip(sc, 0, 1)
        if t == valid_ts[seg] - 1:
            new[seg] = (new_frames[seg], m, True)
    bits = phash.median_threshold_bits(torch.from_numpy(low), 8)
    fps = phash.words_to_numpy(phash.pack_bits_i32(bits)).reshape(s_, t_, 2)
    return scores, fps, new


def _k1_ring_model(lumas, carries, valid_ts, left, right, grid):
    """K1's first form (``k1_plan``): each CTA's range, a ring of three
    frames, a range starting inside a segment also computing its
    predecessor's mafd."""
    s_, t_, h_, w_ = lumas.shape
    hw = np.float32(h_ * w_)
    scores = np.full((s_, t_), np.nan, np.float32)
    lows = np.full((s_, t_, 64), np.nan, np.float32)
    new = [None] * s_
    for lo, hi, k0, _ in k1_plan(s_, t_, grid):
        seg, t = divmod(k0, t_)
        ring = [carries[seg][0].astype(np.uint8) if t == 0 else lumas[seg, t - 1],
                lumas[seg, t], None]
        fresh, carried = not carries[seg][2], np.float32(carries[seg][1])
        prev_m = np.float32(0)
        for i, k in enumerate(range(k0, hi)):
            pred, cur = ring[i % 3], ring[(i + 1) % 3]
            if i > 0:
                t += 1
                if t == t_:
                    seg, t = seg + 1, 0
                    pred = carries[seg][0].astype(np.uint8)
                    fresh, carried = not carries[seg][2], np.float32(carries[seg][1])
            if k + 1 < hi:
                s1, t1 = divmod(k + 1, t_)
                ring[(i + 2) % 3] = lumas[s1, t1]
            total = int(np.abs(cur.astype(np.int32) - pred.astype(np.int32)).sum())
            start = t == 0 and fresh
            m = np.float32(0) if start else np.float32(total) / hw
            if k >= lo:
                lows[seg, t] = _project(cur, left, right)
                pm = carried if t == 0 else prev_m
                sc = np.minimum(m, np.abs(m - pm)) / np.float32(100)
                scores[seg, t] = 0 if start else np.clip(sc, 0, 1)
                if t == valid_ts[seg] - 1:
                    new[seg] = (cur.astype(np.float32), m, True)
            prev_m = m
    bits = phash.median_threshold_bits(torch.from_numpy(lows.reshape(-1, 64)), 8)
    fps = phash.words_to_numpy(phash.pack_bits_i32(bits)).reshape(s_, t_, 2)
    return scores, fps, new


def k1_model(lumas, carries, valid_ts, left, right, grid, **kw):
    """(scores (S, T), fps (S, T, 2) uint32, new carries) as K1 computes
    them in the form ``fused.k1_form`` picks for the geometry: the first on
    ``grid`` CTAs, the second on ``grid`` frame ranges of each band;
    carries are (frame, mafd, has_prev)."""
    if fused.k1_form(*lumas.shape[2:]) == 0:
        return _k1_ring_model(lumas, carries, valid_ts, left, right, grid)
    return k1_bands_model(lumas, carries, valid_ts, left, right, grid, **kw)


def _k1_case(h, w, seed=23, s=3, t=5):
    """(lumas (S, T, H, W), carries, valid_ts): stream 0 fresh, 1 and 2
    mid-stream (carried from a block before), one with a short block."""
    rng = np.random.default_rng(seed)
    lumas = rng.integers(0, 256, size=(s, t, h, w), dtype=np.uint8)
    lumas[1, 2:] = lumas[1, 1]                         # a still: mafd 0
    carries = [(np.zeros((h, w), np.float32), np.float32(0), False)]
    for j in range(1, s):
        carries.append((rng.integers(0, 256, size=(h, w)).astype(np.float32),
                        np.float32(rng.uniform(0, 80)), True))
    return lumas, carries, [t, 2, t][:s]


def _torch_carry(c):
    return fused.FingerprintCarry(scene=fused.SceneCarry(
        prev_frame=torch.from_numpy(c[0]), prev_mafd=torch.tensor(c[1]),
        has_prev=torch.tensor(c[2])))


K1_GEOMETRIES = [(12, 40), (6, 136), (8, 160),
                 # the second form: W > 160, W % 4, H W % 16, any alignment
                 (9, 47), (5, 70), (3, 200), (7, 33), (32, 508), (180, 320),
                 # 321 column words: a second round of items
                 (6, 1283)]


@pytest.mark.parametrize("h,w,form", [
    (90, 160, 0), (8, 8, 0), (12, 40, 0), (400, 160, 0), (91, 163, 1),
    (33, 47, 1), (720, 1280, 1), (180, 320, 1), (90, 162, 1), (2000, 160, 1),
    (2160, 3840, 1), (1, 1, 1)])
def test_k1_form_by_geometry(h, w, form):
    """The production 90x160 keeps the first form; every geometry whose
    three frames do not fit in shared memory or whose rows the lanes cannot
    split (W > 160, W % 4, H W % 16) takes the second, up to 4K."""
    assert fused.k1_form(h, w) == form


@pytest.mark.parametrize("h,w", [(4321, 7681), (2, 8000)])
def test_k1_refuses_what_neither_form_holds(h, w):
    with pytest.raises(ValueError, match="fingerprint-block kernel"):
        fused.k1_form(h, w)


@pytest.mark.parametrize("s,t,grid", [(1, 128, 128), (1, 128, 100),
                                      (3, 5, 4), (3, 5, 15), (4, 7, 9),
                                      (1, 1 << 17, 396)])
def test_k1_plan_covers_every_frame_once(s, t, grid):
    """The ranges cover the S*T frames once, in order; a range takes its
    first frame's predecessor from the carry exactly at a segment's frame
    0, else it starts one frame early (that frame's mafd only)."""
    plan = k1_plan(s, t, grid)
    assert plan[0][0] == 0 and plan[-1][1] == s * t
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    assert all(hi > lo for lo, hi, _, _ in plan)
    for lo, hi, k0, src in plan:
        assert k0 == (lo if lo % t == 0 else lo - 1)
        assert (src == "carry") == (k0 % t == 0)


@pytest.mark.parametrize("h,w", K1_GEOMETRIES)
@pytest.mark.parametrize("grid", [1, 4, 15])
def test_k1_decomposition_equals_plain(h, w, grid):
    """Per stream, scores and carries equal the plain version's exactly and
    hashes are within 2 bits of them, for a grid whose ranges start at, in
    and across segments."""
    lumas, carries, valid = _k1_case(h, w)
    sc, fp, new = k1_model(lumas, carries, valid, *phash.hash_operators_np(h, w),
                           grid)
    left, right = phash.hash_operators(h, w, torch.device("cpu"))
    for j in range(lumas.shape[0]):
        ps, pf, pc = fused.fingerprint_block_plain(
            torch.from_numpy(lumas[j]), _torch_carry(carries[j]), left, right,
            valid_t=valid[j])
        assert np.array_equal(sc[j], ps.numpy())
        diff = np.unpackbits((fp[j] ^ phash.words_to_numpy(pf)).view(np.uint8),
                             axis=-1).sum(-1)
        assert diff.max() <= 2, diff
        assert np.array_equal(new[j][0], pc.scene.prev_frame.numpy())
        assert new[j][1] == pc.scene.prev_mafd.item() and bool(pc.scene.has_prev)


@pytest.mark.parametrize("h,w", K1_GEOMETRIES)
def test_k1_decomposition_does_not_depend_on_the_grid(h, w):
    """A frame's hash and score are the same bits whether its CTA's range
    holds it alone, starts at it or runs through it, and whether the
    segments are launched together or one at a time (the batch and the
    whole stream equal lone and chained launches)."""
    lumas, carries, valid = _k1_case(h, w)
    ops = phash.hash_operators_np(h, w)
    want = k1_model(lumas, carries, valid, *ops, 1)
    for grid in (2, 7, 15):
        got = k1_model(lumas, carries, valid, *ops, grid)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for j in range(lumas.shape[0]):
        lone = k1_model(lumas[j:j + 1], carries[j:j + 1], valid[j:j + 1], *ops, 3)
        assert np.array_equal(lone[0][0], want[0][j])
        assert np.array_equal(lone[1][0], want[1][j])


# -- K1's second form: row bands over CTAs ---------------------------------------


@pytest.mark.parametrize("h,w", [(180, 320), (720, 1280), (91, 163), (33, 47),
                                 (1080, 1920), (1171, 7188), (2000, 160), (1, 1)])
def test_k1_band_partition_depends_only_on_the_geometry(h, w):
    """The bands are a function of (H, W): they cover the rows once, in
    order, at most one shorter band last, and a CTA's ring of three bands
    with Lᵀ's rows stays within the budget that lets two CTAs share an SM
    (the kernel's smem_bytes, with its header and the slots' padding)."""
    bands = k1_bands(h, w)
    assert bands == k1_bands(h, w) and bands[0][0] == 0
    assert all(a[0] + a[1] == b[0] for a, b in zip(bands, bands[1:]))
    assert bands[-1][0] + bands[-1][1] == h
    rows = bands[0][1]
    assert all(r == rows for _, r in bands[:-1]) and 1 <= bands[-1][1] <= rows
    smem = 2560 + 32 * rows + 3 * (-(-rows * w // 16) * 16 + 48)
    assert 3 * rows * w + 32 * rows <= fused._BAND_BUDGET or rows == 1
    assert 2 * (smem + 1024) <= 233472          # two CTAs on one SM


@pytest.mark.parametrize("s,t,ranges", [(1, 128, 128), (1, 128, 9), (3, 5, 4),
                                        (4, 7, 9), (1, 16384, 132)])
def test_k1_ranges_cover_every_frame_once(s, t, ranges):
    """The second form's ranges cover the S*T frames once, in order, each
    band walking the same ranges."""
    plan = k1_ranges(s * t, ranges)
    assert plan[0][0] == 0 and plan[-1][1] == s * t
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    assert all(hi > lo for lo, hi in plan)


@pytest.mark.parametrize("h,w,band_rows", [(9, 47, None), (9, 47, 2), (40, 2000, None),
                                           (7, 33, 3)])
def test_k1_frame_hash_does_not_depend_on_how_it_is_fed(h, w, band_rows):
    """One frame's hash and score are the same bits whether its frames go in
    as one segment of T = n, as S = 4 segments of n / 4 chained by their
    carries, or as S = 1, T = n on another number of ranges."""
    rng = np.random.default_rng(h * w)
    n = 8
    frames = rng.integers(0, 256, size=(n, h, w), dtype=np.uint8)
    ops = phash.hash_operators_np(h, w)
    fresh = (np.zeros((h, w), np.float32), np.float32(0), False)
    one = k1_model(frames[None], [fresh], [n], *ops, 3, band_rows=band_rows)
    other = k1_model(frames[None], [fresh], [n], *ops, 8, band_rows=band_rows)
    assert np.array_equal(one[0], other[0]) and np.array_equal(one[1], other[1])
    carries, scores, fps = [fresh], [], []
    for j in range(4):
        c = carries[-1]
        got = k1_model(frames[None, 2 * j:2 * j + 2], [c], [2], *ops, 2,
                       band_rows=band_rows)
        scores.append(got[0][0])
        fps.append(got[1][0])
        carries.append(got[2][0])
    assert np.array_equal(np.concatenate(scores), one[0][0])
    assert np.array_equal(np.concatenate(fps), one[1][0])
    batch = k1_model(frames.reshape(4, 2, h, w), carries[:4], [2] * 4, *ops, 5,
                     band_rows=band_rows)
    assert np.array_equal(batch[0].reshape(-1), one[0][0])
    assert np.array_equal(batch[1].reshape(n, 2), one[1][0])


@pytest.mark.parametrize("offset", [0, 1, 3, 15])
def test_k1_band_words_at_any_base(offset):
    """W = 163 from a base at byte ``offset``: every band's slot (the 16-byte
    chunks that hold it, its first byte at the head) gives each item's word
    of every row, the bytes past W masked, equal to the frame's pixels."""
    rng = np.random.default_rng(offset)
    h, w, rows = 9, 163, 4
    frame = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    flat = np.concatenate([rng.integers(0, 256, offset, dtype=np.uint8),
                           frame.reshape(-1), rng.integers(0, 256, 64, dtype=np.uint8)])
    for h0, nrows in k1_bands(h, w, rows):
        slot, head = _slot(flat, offset + h0 * w, nrows * w)
        assert head == (offset + h0 * w) % 16 and slot.size % 16 == 0
        for c0 in range(0, w, 4):
            valid = min(4, w - c0)
            mask = np.uint32(0xFFFFFFFF >> (8 * (4 - valid)))
            got = _words_at(slot, head + np.arange(nrows) * w + c0) & mask
            want = np.zeros((nrows, 4), np.uint8)
            want[:, :valid] = frame[h0:h0 + nrows, c0:c0 + valid]
            assert np.array_equal(_bytes_of(got), want)


@pytest.mark.parametrize("h,w,band_rows", [(9, 163, None), (9, 163, 4), (33, 47, 8)])
def test_k1_misaligned_base_equals_aligned(h, w, band_rows):
    """The dispatcher's batch at 91x163 puts blocks at byte offset 3: the
    model fed from offset 3 (head and tail bytes in partial 16-byte chunks)
    gives the bits it gives from offset 0."""
    lumas, carries, valid = _k1_case(h, w)
    ops = phash.hash_operators_np(h, w)
    want = k1_model(lumas, carries, valid, *ops, 4, band_rows=band_rows)
    got = k1_model(lumas, carries, valid, *ops, 4, band_rows=band_rows, base_offset=3)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]


@pytest.mark.parametrize("ranges", [4, 6, 15])
def test_k1_range_starting_mid_segment_takes_band_sads(ranges):
    """Ranges that start inside a segment, over bands whose last is shorter
    (9 rows in bands of 4): each range loads only its first frame's
    predecessor band (no frame before it) and keeps the rest on chip; each
    (frame, band) is computed once; the first score's predecessor mafd
    comes from the other range's per-band SADs, and every score and carry
    equals the plain version's."""
    h, w = 9, 47
    lumas, carries, valid = _k1_case(h, w)
    s_, t_ = lumas.shape[:2]
    trace = []
    sc, fp, new = k1_model(lumas, carries, valid, *phash.hash_operators_np(h, w),
                           ranges, band_rows=4, trace=trace)
    assert sorted((k, b) for k, b, _ in trace) == [
        (k, b) for k in range(s_ * t_) for b in range(3)]
    starts = {lo for lo, _ in k1_ranges(s_ * t_, ranges)}
    assert any(lo % t_ for lo in starts)
    for k, _, src in trace:
        assert src == ("carry" if k % t_ == 0 else "load" if k in starts else "ring")
    left, right = phash.hash_operators(h, w, torch.device("cpu"))
    for j in range(s_):
        ps, pf, pc = fused.fingerprint_block_plain(
            torch.from_numpy(lumas[j]), _torch_carry(carries[j]), left, right,
            valid_t=valid[j])
        assert np.array_equal(sc[j], ps.numpy())
        assert np.array_equal(new[j][0], pc.scene.prev_frame.numpy())
        assert new[j][1] == pc.scene.prev_mafd.item()
