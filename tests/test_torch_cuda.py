"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device (a CUDA kernel has no CPU mode). The file
imports no jax, so on a machine without it run:

    TVIDZ_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda -q

(``TVIDZ_TEST_TPU=1`` keeps tests/conftest.py from importing jax.)
Tolerances as in test_torch_fused.py: scores 1e-6, hashes 2 bits per frame,
median/pack and the scan exact.
"""

import numpy as np
import pytest
import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.decode import synthetic
from tvidz_tpu_torch.ops import align, fused, golden, hamming, phash

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return backend.resolve_device("cuda")


def test_fingerprint_block_kernel_matches_plain(dev):
    luma, _ = synthetic.synthetic_video(2 * 128, 90, 160, cut_frames=(3, 150),
                                        seed=4)
    left, right = phash.hash_operators(90, 160, dev)
    ck = fused.initial_fingerprint_carry(90, 160, dev)
    cp = fused.initial_fingerprint_carry(90, 160, dev)
    before = fused.K1.launches
    for s, vt in ((0, None), (128, 100)):
        x = torch.from_numpy(luma[s:s + 128]).to(dev)
        sk, fk, ck = fused.fingerprint_block(x, ck, left, right, valid_t=vt)
        sp, fp, cp = fused.fingerprint_block_plain(x, cp, left, right, valid_t=vt)
        torch.cuda.synchronize()
        assert (sk - sp).abs().max().item() <= 1e-6
        x_or = phash.words_to_numpy(fk) ^ phash.words_to_numpy(fp)
        assert np.unpackbits(x_or.view(np.uint8), axis=-1).sum(-1).max() <= 2
        assert torch.equal(ck.scene.prev_frame, cp.scene.prev_frame)
        assert abs(ck.scene.prev_mafd.item() - cp.scene.prev_mafd.item()) <= 1e-6
    assert fused.K1.launches == before + 2


def test_median_pack_kernel_is_exact_with_ties(dev):
    low = torch.round(torch.randn(2048, 64, device=dev) * 3)
    low[:8] = 2.0
    assert torch.equal(fused.median_pack_cuda(low),
                       phash.pack_bits_i32(phash.median_threshold_bits(low, 8)))


def _bits(a, b):
    x = phash.words_to_numpy(a) ^ phash.words_to_numpy(b)
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def test_batched_streams_are_one_launch_bit_equal_to_lone_launches(dev):
    """The dispatcher's pass: four streams (fresh, mid-stream, one real
    frame, a short block) in one K1 launch; each equals a lone launch of
    it bit for bit and the plain version within the tolerances."""
    rng = np.random.default_rng(8)
    left, right = phash.hash_operators(90, 160, dev)
    x = torch.from_numpy(rng.integers(0, 256, size=(2, 4, 128, 90, 160),
                                      dtype=np.uint8)).to(dev)
    fresh = [fused.initial_fingerprint_carry(90, 160, dev) for _ in range(4)]
    _, _, warm = fused.fingerprint_blocks_batched(list(x[0]), fresh, [128] * 4,
                                                  left, right)
    carries, valid = [fresh[0], *warm[1:]], [128, 1, 60, 128]
    before = fused.K1.launches
    sb, fb, cb = fused.fingerprint_blocks_batched(list(x[1]), carries, valid,
                                                  left, right)
    assert fused.K1.launches == before + 1
    sp, fp, cp = fused.fingerprint_blocks_batched_plain(list(x[1]), carries,
                                                        valid, left, right)
    for j in range(4):
        s1, f1, c1 = fused.fingerprint_block(x[1, j], carries[j], left, right,
                                             valid_t=valid[j])
        torch.cuda.synchronize()
        assert torch.equal(sb[j], s1) and torch.equal(fb[j], f1)
        assert all(torch.equal(a, b) for a, b in zip(cb[j].scene, c1.scene))
        assert (sb[j] - sp[j]).abs().max().item() <= 1e-6
        assert _bits(fb[j], fp[j]).max() <= 2
        assert torch.equal(cb[j].scene.prev_frame, cp[j].scene.prev_frame)


def test_forward_streams_is_one_launch_per_pass(dev):
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel

    model = FingerprintModel(device=dev)
    lumas = [model.example_payload() for _ in range(3)]
    before = fused.K1.launches
    model.forward_streams(lumas, [model.init_carry() for _ in range(3)],
                          [128, 128, 7])
    assert fused.K1.launches == before + 1


@pytest.mark.parametrize("n", [1000 + 33, 128])
def test_whole_stream_is_one_launch_bit_equal_to_chained_launches(dev, n):
    luma, _ = synthetic.synthetic_video(n, 90, 160, cut_frames=(10, n // 2),
                                        seed=5)
    x = torch.from_numpy(luma).to(dev)
    before = fused.K1.launches
    ss, fs = fused.fingerprint_stream(x)
    assert fused.K1.launches == before + 1
    left, right = phash.hash_operators(90, 160, dev)
    carry = fused.initial_fingerprint_carry(90, 160, dev)
    parts = []
    for s in range(0, n, 128):
        sc, fp, carry = fused.fingerprint_block(x[s:s + 128], carry, left, right)
        parts.append((sc, fp))
    torch.cuda.synchronize()
    assert torch.equal(ss, torch.cat([p[0] for p in parts]))
    assert torch.equal(fs, torch.cat([p[1] for p in parts]))
    sp, fp = fused.fingerprint_stream_plain(x)
    assert (ss - sp).abs().max().item() <= 1e-6 and _bits(fs, fp).max() <= 2


@pytest.mark.parametrize("h,w,t", [(36, 64, 16), (72, 136, 1), (8, 160, 3)])
def test_kernel_other_geometries_match_plain(dev, h, w, t):
    """Widths below 160 (whole words only, and a partial byte column) and
    one-frame and three-frame blocks: three streams of two blocks each,
    batched, against the plain version."""
    rng = np.random.default_rng(9)
    left, right = phash.hash_operators(h, w, dev)
    x = torch.from_numpy(rng.integers(0, 256, size=(2, 3, t, h, w),
                                      dtype=np.uint8)).to(dev)
    ck = [fused.initial_fingerprint_carry(h, w, dev) for _ in range(3)]
    cp = list(ck)
    for r in range(2):
        valid = [t, max(1, t - 1), t]
        sk, fk, ck = fused.fingerprint_blocks_batched(list(x[r]), ck, valid, left, right)
        sp, fp, cp = fused.fingerprint_blocks_batched_plain(list(x[r]), cp, valid,
                                                            left, right)
        torch.cuda.synchronize()
        assert (sk - sp).abs().max().item() <= 1e-6
        assert _bits(fk.reshape(-1, 2), fp.reshape(-1, 2)).max() <= 2
        for a, b in zip(ck, cp):
            assert torch.equal(a.scene.prev_frame, b.scene.prev_frame)
            # The carried mafd is unscaled: K1 divides the exact sum, the
            # plain torch.mean multiplies it by a rounded reciprocal on
            # CUDA; one float32 ulp, 2^-23 relative.
            np.testing.assert_allclose(a.scene.prev_mafd.cpu().numpy(),
                                       b.scene.prev_mafd.cpu().numpy(),
                                       rtol=2 ** -23, atol=0)


def test_kernel_refuses_what_it_cannot_take(dev):
    """A CUDA tensor the kernel cannot take raises; nothing falls back to
    the plain version. Since K1 takes any scene geometry, that is a width
    neither form holds, or a misaligned block at the first form's."""
    left, right = phash.hash_operators(2, 8000, dev)
    carry = fused.initial_fingerprint_carry(2, 8000, dev)
    x = torch.zeros((8, 2, 8000), dtype=torch.uint8, device=dev)
    before = fused.K1.launches
    with pytest.raises(ValueError, match="fingerprint-block kernel"):
        fused.fingerprint_block(x, carry, left, right)
    left, right = phash.hash_operators(90, 160, dev)
    carry = fused.initial_fingerprint_carry(90, 160, dev)
    x = torch.zeros((8 * 14400 + 1,), dtype=torch.uint8, device=dev)[1:].view(8, 90, 160)
    with pytest.raises(ValueError, match="aligned"):
        fused.fingerprint_block(x, carry, left, right)
    assert fused.K1.launches == before


def test_corpus_scan_kernel_matches_plain(dev):
    rng = np.random.default_rng(6)
    corpus = rng.integers(0, 2 ** 32, size=(70_001, 2), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(40, 2), dtype=np.uint32)
    corpus[-50:] = 0xFFFFFFFF
    corpus[[1023, 1024, 5000]] = q[0]
    q[1] = 0xFFFFFFFF
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    got = hamming.corpus_min_distance(t(q), t(corpus))
    want = hamming.corpus_min_distance_plain(t(q), t(corpus))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2][0]) == 1023 and int(got[2][1]) == 70_001 - 50


@pytest.mark.parametrize("v,tc,tq_pad", [(37, 1024, 320), (9, 256, 1536)])
def test_fragment_search_kernel_matches_plain(dev, v, tc, tq_pad):
    """K3 == the plain version on every (q, v) offset and score: planted
    fragments (one damaged, one in a periodic row whose equal maxima must
    resolve to the first offset), a short and an empty row, a random query
    (its zero rows report -(Tq_pad-1)), V not a multiple of 8, two
    thresholds, a query longer than the bucket; each batch row == its
    single call."""
    rng = np.random.default_rng(9)
    corpus = rng.integers(0, 2 ** 32, size=(v, tc, 2), dtype=np.uint32)
    lens = np.full(v, tc, np.int32)
    lens[4], lens[7] = tc // 2, 0
    corpus[4] = np.resize(corpus[4, :50], (tc, 2))   # period 50: tied maxima
    qs = rng.integers(0, 2 ** 32, size=(3, tq_pad, 2), dtype=np.uint32)
    q_lens = np.asarray([min(tq_pad, tc // 4), min(tq_pad - 1, tc // 2 - 3),
                         tq_pad], np.int32)
    qs[0, :q_lens[0]] = corpus[4, 3:3 + q_lens[0]]
    qs[1, :q_lens[1]] = corpus[v - 1, 3:3 + q_lens[1]]
    qs[1, ::3, 0] ^= np.uint32(0b101)
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32  # noqa: E731
                                   else a).to(dev)
    before = align.K3.launches
    for thr in (0, 6, 40):
        got = align.fragment_search_batch(t(qs), t(q_lens), t(corpus), t(lens), thr)
        want = align.fragment_search_batch_plain(t(qs), t(q_lens), t(corpus),
                                                 t(lens), thr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if thr == 40:
            continue        # nearly every pair matches: no zero rows
        one = align.fragment_search(t(qs[1]), int(q_lens[1]), t(corpus),
                                    t(lens), thr)
        assert torch.equal(one[0], got[0][1]) and torch.equal(one[1], got[1][1])
        assert int(got[1][0, 4]) == q_lens[0] and int(got[0][0, 4]) == 3
        assert (got[0][2][got[1][2] == 0] == -(tq_pad - 1)).all()
    assert align.K3.launches == before + 5


@pytest.mark.parametrize("runs", [False, True], ids=["identical", "static_runs"])
@pytest.mark.parametrize("thr", [0, 10, 33])
def test_fragment_search_kernel_dense_bucket(dev, thr, runs):
    """A bucket of identical rows (a static scene): every valid pair
    matches, so every diagonal counts its overlap; a short and an empty
    video, a query shorter than its padding. With ``runs`` the still rows
    are runs inside random videos, so warp blocks that match whole sit
    beside blocks that match in part."""
    row = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    corpus = np.tile(row, (6, 700, 1))
    lens = np.asarray([700, 700, 650, 3, 0, 700], np.int32)
    qs = np.tile(row, (2, 320, 1))
    qs[1, 5] ^= np.uint32(0xF)                       # 4 bits off: thr decides
    q_lens = np.asarray([320, 250], np.int32)
    if runs:
        rng = np.random.default_rng(thr)
        noise = rng.integers(0, 2 ** 32, size=corpus.shape, dtype=np.uint32)
        keep = np.zeros(corpus.shape[:2], bool)
        keep[0, 100:517] = keep[1, :333] = keep[2, 301:] = keep[5, 77:78] = True
        corpus = np.where(keep[..., None], corpus, noise)
        qs[0, :40] = rng.integers(0, 2 ** 32, size=(40, 2), dtype=np.uint32)
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32  # noqa: E731
                                   else a).to(dev)
    got = align.fragment_search_batch(t(qs), t(q_lens), t(corpus), t(lens), thr)
    want = align.fragment_search_batch_plain(t(qs), t(q_lens), t(corpus),
                                             t(lens), thr)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if not runs:
        assert int(got[1][0, 0]) == 320 and int(got[1][0, 4]) == 0


def _range_edges(dev, n, words=2):
    """Rows where the ranges of K4's CTAs 1 and grid / 2 begin, for the
    grid each argmin mode launches on this card at ``words``: CTA c walks
    the 256-row tiles [tiles c / grid, tiles (c + 1) / grid) in ascending
    order."""
    tiles = -(-n // 256)
    grids = {hamming.corpus_scan_tc_grid(mode, n, dev, words)
             for mode in ("full", "full_cols", "twophase", "query_nearest")}
    assert all(1 <= g <= tiles for g in grids)
    return sorted({256 * (tiles * c // g) for g in grids if g > 1
                   for c in (1, g // 2)})


def _scan_case(dev, m, n, seed=12, words=2):
    """(q, corpus, expected q_arg of the planted rows) with ties: a lower
    copy in a far tile, in the adjacent tile, in another warp of its tile;
    a copy in the same row of the next tile (the same thread, later in its
    range); copies on both sides of each CTA range edge; sentinel rows and
    a distance-4 tie."""
    rng = np.random.default_rng(seed)
    corpus = rng.integers(0, 2 ** 32, size=(n, words), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(m, words), dtype=np.uint32)
    corpus[-300:] = 0xFFFFFFFF
    q[1] = 0xFFFFFFFF
    plants = {0: [256 * 200 + 3, 256 * 2 + 250], 2: [256 * 40, 256 * 39 + 255],
              3: [256 * 7 + 130, 256 * 7 + 2], 4: [9000, 4001],
              5: [256 * 11 + 7, 256 * 10 + 7]}
    for i, edge in enumerate(_range_edges(dev, n, words)):
        plants[6 + i] = [edge, edge - 1]
    want = {}
    for k, rows in plants.items():
        if k < m and max(rows) < n - 300:       # a small corpus gets fewer
            corpus[rows] = q[k] ^ np.uint32(3 if k == 4 else 0)
            want[k] = min(rows)
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    return t(q), t(corpus), want


@pytest.mark.parametrize("m,n", [(128, 70_001), (37, 65_536), (16, 1000),
                                 (128, 1), (1024, 70_001), (16384, 4096),
                                 (128, 3000)])
@pytest.mark.parametrize("mode", hamming.MODES)
def test_tensor_core_scan_matches_plain(dev, mode, m, n):
    """Every K4 mode == the plain XOR scan,
    first-index ties included: M not a multiple of 16 or above one query
    chunk (128), N not a multiple of the tile, N = 1, N below one CTA's
    range."""
    q, corpus, planted = _scan_case(dev, m, n)
    want = hamming.corpus_min_distance_plain(q, corpus)
    before = hamming.K4.launches
    got = hamming.corpus_scan_tc(q, corpus, mode)
    assert hamming.K4.launches == before + 1
    pm1 = hamming.corpus_scan_pm1_plain(q, corpus, mode)
    for g, p, w in zip(got, pm1, want):
        assert (g is None) == (p is None)
        if g is not None:
            assert torch.equal(g, w) and torch.equal(p, w)
    if got[2] is not None:
        assert {k: int(got[2][k]) for k in planted} == planted
        if n > 300:
            assert int(got[2][1]) == n - 300
        if 4 in planted:
            assert int(got[1][4]) == 4
    # A second call on the same stream finds K4's workspace reset.
    again = hamming.corpus_scan_tc(q, corpus, mode)
    assert all(a is None or torch.equal(a, w) for a, w in zip(again, want))


def test_tensor_core_scan_all_tied(dev):
    """One repeated row: every query ties with every row, the argmin is 0."""
    q, corpus, _ = _scan_case(dev, 128, 70_001)
    tied = corpus[1000:1001].repeat(1 << 16, 1)
    for mode in ("full", "twophase", "query_nearest"):
        _, q_min, q_arg = hamming.corpus_scan_tc(q, tied, mode)
        assert int(q_arg.max()) == 0
        assert torch.equal(q_min, hamming.corpus_min_distance_plain(q, tied)[1])


def test_k2_frame_min_switch_matches_plain(dev):
    q, corpus, _ = _scan_case(dev, 128, 70_001)
    before = hamming.K2.launches
    got = hamming.corpus_frame_min_xor(q, corpus)
    assert hamming.K2.launches == before + 1
    assert torch.equal(got, hamming.corpus_min_distance_plain(q, corpus)[0])


# -- any scene geometry (K1's second form), any word width, any query count --

ODD_GEOMETRIES = [(91, 163), (33, 47), (720, 1280), (8, 8), (180, 320),
                  (90, 162), (90, 160)]


@pytest.mark.parametrize("h,w", ODD_GEOMETRIES)
def test_kernel_any_geometry_matches_plain(dev, h, w):
    """K1 at the reference's edge geometries and the env var's reach:
    chained blocks within the tolerances of the plain version (carried
    mafd within one ulp), the whole stream bit-equal to the chained
    launches, hashes within 2 bits of golden.phash."""
    rng = np.random.default_rng(h + w)
    t = 128 if h * w < 500_000 else 32
    luma = rng.integers(0, 256, size=(2 * t + 7, h, w), dtype=np.uint8)
    x = torch.from_numpy(luma).to(dev)
    left, right = phash.hash_operators(h, w, dev)
    ck = fused.initial_fingerprint_carry(h, w, dev)
    cp = fused.initial_fingerprint_carry(h, w, dev)
    chained = []
    for s in range(0, x.shape[0], t):
        sk, fk, ck = fused.fingerprint_block(x[s:s + t], ck, left, right)
        sp, fp, cp = fused.fingerprint_block_plain(x[s:s + t], cp, left, right)
        torch.cuda.synchronize()
        chained.append((sk, fk))
        assert (sk - sp).abs().max().item() <= 1e-6
        assert _bits(fk, fp).max() <= 2
        assert torch.equal(ck.scene.prev_frame, cp.scene.prev_frame)
        np.testing.assert_allclose(ck.scene.prev_mafd.cpu().numpy(),
                                   cp.scene.prev_mafd.cpu().numpy(),
                                   rtol=2 ** -23, atol=0)
    ss, fs = fused.fingerprint_stream(x)
    assert torch.equal(ss, torch.cat([c[0] for c in chained]))
    assert torch.equal(fs, torch.cat([c[1] for c in chained]))
    want = np.stack([golden.phash(f) for f in luma[:4]])
    assert _bits(fs[:4], torch.from_numpy(want.view(np.int32))).max() <= 2


def test_odd_geometry_batch_is_one_launch_equal_to_lone_launches(dev):
    """The dispatcher's pass at 91x163 (the second form): one launch, each
    stream bit-equal to a lone launch, misaligned blocks taken."""
    rng = np.random.default_rng(5)
    h, w = 91, 163
    left, right = phash.hash_operators(h, w, dev)
    flat = torch.from_numpy(rng.integers(0, 256, size=(4 * 64 * h * w + 3,),
                                         dtype=np.uint8)).to(dev)
    blocks = [flat[3 + k * 64 * h * w:3 + (k + 1) * 64 * h * w].view(64, h, w)
              for k in range(4)]
    carries = [fused.initial_fingerprint_carry(h, w, dev) for _ in range(4)]
    _, _, mid = fused.fingerprint_block(blocks[0], carries[0], left, right)
    carries[2] = mid
    valid = [64, 1, 33, 64]
    before = fused.K1.launches
    sb, fb, cb = fused.fingerprint_blocks_batched(blocks, carries, valid, left, right)
    assert fused.K1.launches == before + 1
    for j in range(4):
        s1, f1, c1 = fused.fingerprint_block(blocks[j], carries[j], left, right,
                                             valid_t=valid[j])
        assert torch.equal(sb[j], s1) and torch.equal(fb[j], f1)
        assert all(torch.equal(a, b) for a, b in zip(cb[j].scene, c1.scene))


@pytest.mark.parametrize("words", [1, 3, 8])
@pytest.mark.parametrize("m,n", [(128, 70_001), (37, 3000)])
def test_scans_any_width_match_plain(dev, words, m, n):
    """Every K4 mode and K2's two entry points at W words == the plain XOR
    scan, ties at the range edges of the grid K4 reports for W included."""
    q, corpus, planted = _scan_case(dev, m, n, words=words)
    want = hamming.corpus_min_distance_plain(q, corpus)
    for mode in hamming.MODES:
        got = hamming.corpus_scan_tc(q, corpus, mode)
        assert all(g is None or torch.equal(g, w) for g, w in zip(got, want)), mode
        if got[2] is not None:
            assert {k: int(got[2][k]) for k in planted} == planted
    assert all(torch.equal(g, w) for g, w in zip(
        hamming.corpus_min_distance(q, corpus), want))
    assert torch.equal(hamming.corpus_frame_min_xor(q, corpus), want[0])


@pytest.mark.parametrize("words", [2, 8])
@pytest.mark.parametrize("m", [16_385, 40_000])
def test_scans_past_one_launch_match_plain(dev, words, m):
    """More queries than a launch takes: chunks of 16,384, one launch each,
    combined exactly."""
    q, corpus, _ = _scan_case(dev, m, 4096, words=words)
    want = hamming.corpus_min_distance_plain(q, corpus)
    chunks = -(-m // 16_384)
    before = hamming.K4.launches, hamming.K2.launches
    for mode in ("frame_min", "query_nearest", "full"):
        got = hamming.corpus_scan_tc(q, corpus, mode)
        assert all(g is None or torch.equal(g, w) for g, w in zip(got, want)), mode
    got = hamming.corpus_min_distance(q, corpus)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert hamming.K4.launches == before[0] + 3 * chunks
    assert hamming.K2.launches == before[1] + chunks


@pytest.mark.parametrize("thr", [0, 40, 100])
def test_fragment_search_kernel_w8_matches_plain(dev, thr):
    rng = np.random.default_rng(thr)
    v, tc, tq_pad, words = 37, 1024, 320, 8
    corpus = rng.integers(0, 2 ** 32, size=(v, tc, words), dtype=np.uint32)
    lens = np.full(v, tc, np.int32)
    lens[3], lens[4] = 100, 0
    corpus[5] = np.resize(corpus[5, :50], (tc, words))
    qs = rng.integers(0, 2 ** 32, size=(3, tq_pad, words), dtype=np.uint32)
    qlens = np.asarray([320, 200, 77], np.int32)
    qs[0, :300] = corpus[9, 500:800]
    qs[1, :200] = corpus[5, 20:220]
    qs[0, ::4, 6] ^= np.uint32(0b1011)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)  # noqa: E731
                                   if a.dtype == np.uint32 else a).to(dev)
    args = [t(a) for a in (qs, qlens, corpus, lens)]
    ko, ks = align.fragment_search_batch(*args, thr)
    po, ps = align.fragment_search_batch_plain(*args, thr)
    assert torch.equal(ko, po) and torch.equal(ks, ps)
    dense = t(np.broadcast_to(corpus[0, 0], corpus.shape).copy())
    dq = t(np.broadcast_to(corpus[0, 0], qs.shape).copy())
    got = align.fragment_search_batch(dq, args[1], dense, args[3], thr)
    want = align.fragment_search_batch_plain(dq, args[1], dense, args[3], thr)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_phash256_analyze_on_the_card(dev, monkeypatch):
    """A model under phash256 on the card: the family's composition (no K1
    launch), the same cuts and fingerprints within 8 bits of the CPU's."""
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel

    monkeypatch.setenv("TVIDZ_HASH_ALGO", "phash256")
    luma, _ = synthetic.synthetic_video(300, 90, 160, cut_frames=(40, 200), seed=6)
    pts = np.arange(300) / 25.0
    before = fused.K1.launches
    cuts, fps = FingerprintModel(Config(), device=dev).analyze_array(luma, pts)
    assert fused.K1.launches == before
    ccuts, cfps = FingerprintModel(Config(), device="cpu").analyze_array(luma, pts)
    assert cuts == ccuts == [1.6, 8.0] and fps.shape == (300, 8)
    assert np.unpackbits((fps ^ cfps).view(np.uint8), axis=-1).sum(-1).max() <= 8


def test_scan_wider_after_narrower_widths(dev):
    """Widths whose shared memory needs an opt-in, asked in turn (8, 5, 8):
    a narrower one never lowers the limit under a wider one's launch."""
    for words in (8, 5, 8, 37):
        q, corpus, _ = _scan_case(dev, 130, 3000, words=words)
        want = hamming.corpus_min_distance_plain(q, corpus)
        for mode in ("query_nearest", "frame_min"):
            got = hamming.corpus_scan_tc(q, corpus, mode)
            assert all(g is None or torch.equal(g, w) for g, w in zip(got, want))


# -- the word-chunked walks (TVIDZ_HASH_SIZE >= 32; 128 words at dct_size 64) ---

WIDER_WORDS = [26, 32, 42, 128]


@pytest.mark.parametrize("words", WIDER_WORDS)
@pytest.mark.parametrize("m,n", [(128, 70_001), (37, 3000)])
def test_scans_wider_words_match_plain(dev, words, m, n):
    """K4's five modes and K2's two entry points past one pass of their
    shared memory == the plain XOR scan, ties at K4's range edges."""
    q, corpus, planted = _scan_case(dev, m, n, words=words)
    want = hamming.corpus_min_distance_plain(q, corpus)
    for mode in hamming.MODES:
        got = hamming.corpus_scan_tc(q, corpus, mode)
        assert all(g is None or torch.equal(g, w) for g, w in zip(got, want)), mode
        if got[2] is not None:
            assert {k: int(got[2][k]) for k in planted} == planted
    assert all(torch.equal(g, w) for g, w in zip(
        hamming.corpus_min_distance(q, corpus), want))
    assert torch.equal(hamming.corpus_frame_min_xor(q, corpus), want[0])


def test_scan_grid_asked_for_widths_in_turn(dev):
    """The grid asked at W = 128, 8, 42 and 2 in turn, then each launched:
    no width's shared-memory opt-in is lowered by a later one."""
    grids = {w: hamming.corpus_scan_tc_grid("query_nearest", 3000, dev, w)
             for w in (128, 8, 42, 2)}
    assert all(g >= 1 for g in grids.values())
    for words in (128, 8, 42, 2):
        q, corpus, _ = _scan_case(dev, 130, 3000, words=words)
        want = hamming.corpus_min_distance_plain(q, corpus)
        got = hamming.corpus_scan_tc(q, corpus, "query_nearest")
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("words", WIDER_WORDS)
@pytest.mark.parametrize("thr", [0, 10, 40])
def test_fragment_search_kernel_wider_words_match_plain(dev, words, thr):
    rng = np.random.default_rng(words + thr)
    v, tc, tq_pad = 21, 400, 200
    corpus = rng.integers(0, 2 ** 32, size=(v, tc, words), dtype=np.uint32)
    lens = np.full(v, tc, np.int32)
    lens[3], lens[4] = 100, 0
    corpus[5] = np.resize(corpus[5, :50], (tc, words))
    corpus[7, 40:300] = corpus[7, 40]                 # a still scene
    qs = rng.integers(0, 2 ** 32, size=(2, tq_pad, words), dtype=np.uint32)
    qlens = np.asarray([200, 77], np.int32)
    qs[0, :190] = corpus[9, 100:290]
    qs[0, ::4, 6] ^= np.uint32(0b1011)
    qs[1, :77] = corpus[5, 20:97]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)  # noqa: E731
                                   if a.dtype == np.uint32 else a).to(dev)
    args = [t(a) for a in (qs, qlens, corpus, lens)]
    ko, ks = align.fragment_search_batch(*args, thr)
    po, ps = align.fragment_search_batch_plain(*args, thr)
    assert torch.equal(ko, po) and torch.equal(ks, ps)
    if thr == 10:
        assert (int(ks[0, 9]), int(ko[0, 9])) == (190, 100)


def test_median_pack_is_the_coefficient_tail(dev):
    """K1's median-pack entry == the plain coefficient tail on projected
    coefficients and on planted median ties, one K1 launch a call."""
    rng = np.random.default_rng(12)
    luma = rng.integers(0, 256, (64, 90, 160), dtype=np.uint8)
    real = torch.from_numpy(phash.phash_project_host(luma)).to(dev)
    ties = torch.round(torch.randn(512, 64, device=dev) * 2)
    ties[:4] = 1.0
    ties[4:8, :33] = 5.5
    low = torch.cat([real, ties])
    before = fused.K1.launches
    got = phash.phash_from_coeffs_batched(low)
    assert fused.K1.launches == before + 1
    assert torch.equal(got, phash.phash_from_coeffs_plain(low, 8))
    want = np.stack([golden.phash(f) for f in luma])
    assert np.array_equal(phash.words_to_numpy(got[:64]), want)


def test_forward_batch_is_one_launch_equal_to_plain(dev):
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel

    model = FingerprintModel(Config(), device=dev)
    clips = torch.randint(0, 256, (8, 128, 90, 160), dtype=torch.uint8, device=dev)
    before = fused.K1.launches
    scores, fps = model.forward_batch(clips)
    assert fused.K1.launches == before + 1
    init = fused.initial_fingerprint_carry(90, 160, dev)
    ps, pf, _ = fused.fingerprint_blocks_batched_plain(
        list(clips), [init] * 8, [128] * 8, model.left, model.right)
    assert (scores - ps).abs().max().item() <= 1e-6
    assert _bits(fps.reshape(-1, 2), pf.reshape(-1, 2)).max() <= 2
    assert not scores[:, 0].any()


def test_fingerprint_streams_on_the_card(dev, tmp_path):
    """Three uploads through the engine on the card (transfer pump, pinned
    resolve): each equals its lone analyze bit for bit, one K1 launch a
    pass."""
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel
    from tvidz_tpu_torch.pipeline.multistream import fingerprint_streams

    paths = []
    for i, n in enumerate((300, 129, 260)):
        paths.append(str(tmp_path / f"s{i}.y4m"))
        write_synthetic_y4m(paths[-1], num_frames=n, height=180, width=320,
                            cut_frames=(n // 3,), seed=50 + i)
    model = FingerprintModel(Config(), device=dev)
    before = fused.K1.launches
    results, stats = fingerprint_streams(paths, model=model, max_active=3)
    assert fused.K1.launches - before == stats.dispatches
    for r in results:
        cuts, fps = model.analyze_path(r.path)
        assert r.error is None and r.scene_cuts == cuts
        assert np.array_equal(r.fingerprints, fps)


# -- the mesh: four cells of cuda:0, or of four cards -----------------------------

# Each mesh case runs on four cells of the card ("one_card") and on four
# cards ("cards", skipped where fewer are visible).
MESH_CELLS = pytest.mark.parametrize("cards", [False, True],
                                     ids=["one_card", "cards"])


@pytest.fixture
def mesh_of(dev, cards):
    """(data, corpus) -> a mesh of four cells: cuda:0 four times, or
    cuda:0..3 (the tensors' devices then differ from cell to cell)."""
    from tvidz_tpu_torch.parallel.mesh import make_mesh

    if cards and torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")

    def make(data=1, corpus=4):
        devices = ([torch.device("cuda", i) for i in range(4)] if cards
                   else [dev] * 4)
        return make_mesh(4, data, corpus, devices=devices)
    return make


@MESH_CELLS
def test_mesh_scans_equal_single_card_k4(dev, mesh_of):
    """``sharded_frame_min`` / ``sharded_nearest`` over four shards: one K4
    launch a shard, results equal one launch over the whole corpus, with
    exact copies and a distance-2 tie on both sides of every shard edge."""
    from tvidz_tpu_torch.parallel import sharded_search as ss

    mesh, n, m = mesh_of(), 4 * 65_536, 128
    rng = np.random.default_rng(81)
    q = rng.integers(0, 2**32, size=(m, 2), dtype=np.uint32)
    c = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    for j, edge in enumerate((65_536, 131_072, 196_608)):
        c[edge - 1] = c[edge] = q[j]
        c[edge - 2] = c[edge + 1] = q[10 + j] ^ np.uint32(3)
    qt = torch.from_numpy(q.view(np.int32)).to(dev)
    ct = torch.from_numpy(c.view(np.int32)).to(dev)
    before = hamming.K4.launches
    fmin = ss.sharded_frame_min(qt, ct, mesh)
    q_min, q_arg = ss.sharded_nearest(qt, ct, mesh)
    assert hamming.K4.launches == before + 8
    assert torch.equal(fmin, hamming.corpus_frame_min(qt, ct))
    want_min, want_arg = hamming.corpus_query_nearest(qt, ct)
    assert torch.equal(q_min, want_min) and torch.equal(q_arg, want_arg)
    assert q_arg[:3].tolist() == [65_535, 131_071, 196_607]
    assert q_arg[10:13].tolist() == [65_534, 131_070, 196_606]


@MESH_CELLS
def test_mesh_fragment_batch_equals_single_card_k3(dev, mesh_of):
    """The 2-D batch on a (data 2, corpus 2) mesh: one K3 launch a tile,
    equal to one launch over the whole batch, a query of length 0 (a
    padding row) included."""
    from tvidz_tpu_torch.parallel import sharded_search as ss

    mesh = mesh_of(2, 2)
    rng = np.random.default_rng(82)
    v, tc, tq = 8, 256, 128
    corpus = rng.integers(1, 2**32 - 1, size=(v, tc, 2), dtype=np.uint32)
    lens = rng.integers(140, tc + 1, size=v).astype(np.int32)
    qs = np.full((4, tq, 2), 0xFFFFFFFF, np.uint32)
    qlens = np.asarray([100, 0, 64, 17], np.int32)
    for i, ln in enumerate(qlens):
        qs[i, :ln] = corpus[(3 * i) % v, 20:20 + ln]
    args = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
            for a in (qs, qlens, corpus, lens)]
    before = align.K3.launches
    offs, scores = ss.sharded_fragment_search_batch(*args, mesh, hamming_threshold=10)
    assert align.K3.launches == before + 4
    want = align.fragment_search_batch(*args, hamming_threshold=10)
    assert torch.equal(offs, want[0]) and torch.equal(scores, want[1])
    assert scores[1].max().item() == 0 and scores[0, 0].item() == 100


@MESH_CELLS
def test_mesh_corpus_equals_device_corpus_on_the_card(dev, mesh_of):
    """A MeshCorpus on four cells answers every query as the single-card
    DeviceCorpus does: K4 once a shard for each verdict scan,
    K3 once a tile and bucket for the 2-D fragment batch."""
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
    from tvidz_tpu_torch.parallel.mesh_corpus import MeshCorpus

    rng = np.random.default_rng(83)
    kw = dict(ts_initial_capacity=64, fp_initial_capacity=8192, hamming_threshold=10)
    corpora = (MeshCorpus(mesh_of(), **kw), MeshCorpus(mesh_of(2, 2), **kw),
               DeviceCorpus(device=dev, **kw))
    seqs = {v: rng.integers(0, 2**32, size=(int(n), 2), dtype=np.uint32)
            for v, n in zip(range(1, 41), rng.integers(50, 600, size=40))}
    for v, s in seqs.items():
        for c in corpora:
            c.upsert_timestamps(v, [round(0.04 * (v + k), 6) for k in range(4)])
            c.append_fingerprints(v, s)
    q = np.concatenate([seqs[7][:20], seqs[30][5:25]])
    frags = [seqs[3][10:60], seqs[22][100:300], np.zeros((0, 2), np.uint32)]
    before = (hamming.K4.launches, align.K3.launches)
    for call in (lambda c: c.match_timestamps([0.28, 0.32, 0.36]),
                 lambda c: c.search_fingerprints(q),
                 lambda c: c.nearest_video_counts(q),
                 lambda c: c.locate_fragments(frags, top_k=3)):
        answers = [call(c) for c in corpora]
        assert answers[0] == answers[1] == answers[2], answers
    k4, k3 = hamming.K4.launches - before[0], align.K3.launches - before[1]
    buckets = sum(bu is not None and bu.count > 0 for bu in corpora[2]._al_buckets)
    # K4: 4 + 4 (mesh 1) + 2 + 2 (mesh 2) + 2 (single card).
    assert k4 == 14
    # K3: one tile per shard (mesh 1), per data x corpus tile (mesh 2), one.
    assert k3 == buckets * (4 + 4 + 1)


@MESH_CELLS
def test_step_equals_per_clip_single_card_path(dev, mesh_of):
    """``multichip_analysis_step`` on a (data 2, corpus 2) mesh: one K1
    launch a data row (on its own card with four), K4 once per (clip, shard); equal to each
    clip's K1 stream, its timestamp counts and its K4 frame_min."""
    from tvidz_tpu_torch.ops import timestamps
    from tvidz_tpu_torch.parallel import step

    mesh = mesh_of(2, 2)
    rng = np.random.default_rng(84)
    b, nt, t = 4, 2, 128
    luma, _ = synthetic.synthetic_video(b * nt * t, 90, 160,
                                        cut_frames=(40, 300, 700, 900), seed=9)
    clips = luma.reshape(b, nt, t, 90, 160)
    pts = np.tile(np.arange(nt * t) / 25.0, (b, 1))
    corpus_ts = np.full((64, 16), np.nan, np.float32)
    corpus_ts[33, :2] = [round(40 / 25.0, 6), 1.0]
    corpus_len = np.full(64, 2, np.int32)
    corpus_fp = rng.integers(0, 2**32, size=(4096, 2), dtype=np.uint32)
    args = step.place_step_inputs(mesh, clips, pts, corpus_ts, corpus_len, corpus_fp)
    before = (fused.K1.launches, hamming.K4.launches)
    out = step.multichip_analysis_step(*args, mesh=mesh, max_cuts=8)
    assert fused.K1.launches - before[0] == 2
    assert hamming.K4.launches - before[1] == b * 2
    ct = torch.from_numpy(corpus_fp.view(np.int32)).to(dev)
    for i in range(b):
        sc, fp = fused.fingerprint_stream(torch.from_numpy(luma[i * nt * t:(i + 1) * nt * t]).to(dev))
        assert (out.scores[i] - sc).abs().max().item() <= 1e-6
        assert torch.equal(out.fingerprints[i], fp)
        cut = step._extract_cut_ts(sc[None], torch.from_numpy(
            np.round(pts[i], 6).astype(np.float32)).to(dev)[None], 0.3, 8)[0]
        assert torch.equal(out.ts_counts[i], timestamps.timestamp_match_counts(
            cut, torch.from_numpy(corpus_ts).to(dev), torch.from_numpy(corpus_len).to(dev)))
        assert torch.equal(out.fp_min_dist[i], hamming.corpus_frame_min(fp, ct))
    assert out.ts_counts[0, 33].item() == 1


# -- multi-host: ranks of a torch.distributed group ----------------------------------
# Two ranks on one card share it over gloo (NCCL refuses them); with two or
# more cards, one rank per card over NCCL (these cases skip under two cards).


def _nccl_world():
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards: NCCL takes one rank per card")
    return n


def test_multihost_dryrun_two_ranks_share_the_card(dev, tmp_path):
    from tvidz_tpu_torch.parallel import dryrun

    s = dryrun.parent(2, "cuda", 2, large=False, out_dir=str(tmp_path))
    assert s["ok"], s["failures"]
    assert s["backend"] == "gloo" and s["mesh"] == {"data": 1, "corpus": 4}
    for counts in s["launches"]:
        assert counts["corpus_scan_tc"] > 0 and counts["fragment_search"] > 0


@pytest.mark.parametrize("large", [False, True], ids=["small", "large"])
def test_multihost_dryrun_nccl_one_card_per_rank(dev, tmp_path, large):
    """Every card a rank: the ranks' answers identical, and (large) equal to
    a single-card DeviceCorpus of the same 2^24 rows."""
    from tvidz_tpu_torch.parallel import dryrun

    n = _nccl_world()
    s = dryrun.parent(n, "cuda", 1, large=large, out_dir=str(tmp_path),
                      one_card_per_rank=True)
    assert s["ok"], s["failures"]
    assert s["backend"] == "nccl" and s["mesh"] == {"data": 1, "corpus": n}
    for counts in s["launches"]:
        assert counts["corpus_scan_tc"] > 0 and counts["fragment_search"] > 0


def test_multihost_served_nccl_one_card_per_rank(dev):
    import json
    import os
    import subprocess
    import sys

    _nccl_world()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "tvidz_tpu_torch.service.integration_multihost",
         "--device", "cuda", "--quick", "--one-card-per-rank"],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-1000:])
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    for rank in summary["ranks"]:
        assert rank["kernel_launches"]["fragment_search"] > 0
        assert rank["kernel_launches"]["fingerprint_block"] > 0
