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
from tvidz_tpu_torch.ops import align, fused, hamming, phash

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
    the plain version."""
    left, right = phash.hash_operators(90, 150, dev)
    carry = fused.initial_fingerprint_carry(90, 150, dev)
    x = torch.zeros((8, 90, 150), dtype=torch.uint8, device=dev)
    before = fused.K1.launches
    with pytest.raises(ValueError, match="W <= 160"):
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


def _range_edges(dev, n):
    """Rows where the ranges of K4's CTAs 1 and grid / 2 begin, for the
    grid each argmin mode launches on this card: CTA c walks the 256-row
    tiles [tiles c / grid, tiles (c + 1) / grid) in ascending order."""
    tiles = -(-n // 256)
    grids = {hamming.corpus_scan_tc_grid(mode, n, dev)
             for mode in ("full", "full_cols", "twophase", "query_nearest")}
    assert all(1 <= g <= tiles for g in grids)
    return sorted({256 * (tiles * c // g) for g in grids if g > 1
                   for c in (1, g // 2)})


def _scan_case(dev, m, n, seed=12):
    """(q, corpus, expected q_arg of the planted rows) with ties: a lower
    copy in a far tile, in the adjacent tile, in another warp of its tile;
    a copy in the same row of the next tile (the same thread, later in its
    range); copies on both sides of each CTA range edge; sentinel rows and
    a distance-4 tie."""
    rng = np.random.default_rng(seed)
    corpus = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(m, 2), dtype=np.uint32)
    corpus[-300:] = 0xFFFFFFFF
    q[1] = 0xFFFFFFFF
    plants = {0: [256 * 200 + 3, 256 * 2 + 250], 2: [256 * 40, 256 * 39 + 255],
              3: [256 * 7 + 130, 256 * 7 + 2], 4: [9000, 4001],
              5: [256 * 11 + 7, 256 * 10 + 7]}
    for i, edge in enumerate(_range_edges(dev, n)):
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
