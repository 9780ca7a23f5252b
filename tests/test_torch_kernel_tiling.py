"""The arithmetic decomposition of kernels K1, K3 and K4, modelled in numpy
and held against the port's plain versions, on the CPU.

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

- K1 (``csrc/fingerprint_block.cu``): S segments of T frames cut into
  contiguous per-CTA ranges; a range starting inside a segment also
  computes its predecessor's mafd (no hash), a segment's frame 0 takes the
  carry; a ring of three frame buffers; mafd as an exact integer sum; per
  row, lanes holding one 4-byte word and one byte of columns with their R
  rows permuted, a select-free reduce-scatter shuffle tree, L folded in row
  by row and the warps' sums added in warp order; the carry at valid_t - 1.

Tolerance: exact (integer counts and indices; K1's scores and carries),
and K1's hashes within 2 bits of the plain version's (float32 sums in
another order, tests/test_torch_fused.py).
"""

import numpy as np
import pytest
import torch

from tvidz_tpu_torch.ops import align, fused, hamming, phash

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


def k1_model(lumas, carries, valid_ts, left, right, grid):
    """(scores (S, T), fps (S, T, 2) uint32, new carries) as K1 computes
    them on ``grid`` CTAs; carries are (frame, mafd, has_prev)."""
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


K1_GEOMETRIES = [(12, 40), (6, 136), (8, 160)]


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
