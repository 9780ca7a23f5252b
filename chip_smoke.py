#!/usr/bin/env python3
"""Quickest proof that tvidz_tpu_torch runs on the GPU: build its kernels,
check each against its plain PyTorch version (K1 on chained blocks, on the
dispatcher's batch of streams and on a whole stream, each one launch; K3,
K4's five modes and K2's frame_min-only switch exactly, ties across K4's
CTA ranges included), drive
``ingest`` / ``analyze`` / ``search`` through the port's CLI, the two
corpus scans (``search_fingerprints``, ``nearest_video_counts``), the
inspector service (uploads over the fake S3 -> SQS path, SSE, fragment and
video search) and a short ``bench`` against a 2^20-fingerprint corpus, and
time it. Launch counts are zeroed before and read after each of those paths.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OLD_ROOT

``--against`` runs only the race of this tree against another checkout of
the repo (``git archive <commit> | tar -x -C OLD_ROOT``; in a directory
``.gitignore`` lists): four fresh processes, old, new, new, old, each
timing K1, K3 and K4 at the race shapes (torch.profiler device time and
CUDA events) and one analyze of a 1024-frame upload; K3's and K4's outputs
held equal across the trees, K1's within its tolerances.

Needs one CUDA card and ``nvcc``; exits non-zero without them, and on any
failed phase. Each phase prints one line; the line before the last is
``nvidia-smi``'s card name and power limit, and the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import sqlite3
import subprocess
import sys
import tempfile
import time

SEED = 20260
FRAMES, HEIGHT, WIDTH = 128, 90, 160        # the main path's block
SCAN_M, SCAN_N = 128, 1 << 20               # queries x corpus rows
# K3 shapes (Q, Tq_pad, V, Tc): the reference's fragment config
# (align_pallas.py:39, 2^20 corpus fingerprints), the smoke store's own
# bucket, and 8 queries against it.
FRAG_A, FRAG_B, FRAG_C = (1, 768, 1024, 1024), (1, 768, 256, 4096), (8, 768, 256, 4096)
FRAG_THR = 10           # the service's hamming threshold (config.match)
FILLER_VIDEOS, FILLER_FP_VIDEOS, FILLER_FP_FRAMES = 8192, 256, 4096
K1_STREAMS = 4          # the dispatcher's pass in k1_vs_plain
K1_STREAM_FRAMES = 4096 + 77                # a ragged whole stream
K1_VALUE_FRAMES = 512 * 256                 # the bench's single-dispatch pass
SCORE_TOL = 1e-6        # mafd sums are integer-exact: bit-equal expected
HASH_BITS_TOL = 2       # f32 sums in another order (tests/test_ops_phash.py)
# The carried mafd is unscaled (up to 255). K1 divides the exact sum by
# H*W; the plain version's torch.mean multiplies it by a rounded 1/(H*W)
# on CUDA, which may land one float32 ulp away.
MAFD_ULPS_TOL = 1


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(kernel_fn, plain_fn, reps: int):
    """(kernel ms, plain ms) per call, measured plain, kernel, kernel, plain
    after a warm-up, each the mean of ``reps`` back-to-back calls."""
    for _ in range(3):
        kernel_fn()
        plain_fn()
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _trace(fn, reps: int) -> dict:
    """{device item: (us, count)} of one torch.profiler window of ``reps``
    calls, recorded after a warm-up window of as many (a window's first
    launches are the ones the tracer misses)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0}


# Device items a window recorded in fewer than half its calls, by name:
# not the calls' work (the profiler's own, such as its buffer requests).
SET_ASIDE = set()


def device_ms_by_kernel(fn, reps: int, tries: int = 6) -> dict:
    """Device ms per call of each kernel, copy and memset ``fn`` runs, by
    name, from torch.profiler. Unlike ``cuda_ms`` it leaves out the gaps
    while the host issues launches, which dominate calls this short. A
    window of ``reps`` calls may miss some launches (on the H100, 20-call
    windows recorded 19 and 18 of a kernel's 20), so an item that ran k
    times per call in all but a tenth of the calls (at least one) costs k
    times its mean per launch; an item seen in fewer than half the calls
    is set aside (``SET_ASIDE``); a window that lost more of an item is
    dropped. A window counts only when another one recorded the same items
    as many times per call, and the result is the mean of those two.
    Fails after ``tries`` windows with no such pair."""
    import torch

    fn()                                 # one-time work stays out
    torch.cuda.synchronize()
    seen, t = [], {}
    for _ in range(tries):
        t = _trace(fn, reps)
        work = {}
        for key, (us, count) in t.items():
            per_call = round(count / reps)
            if not per_call:
                SET_ASIDE.add(key[:60])
            elif per_call * (reps - max(1, reps // 10)) <= count <= per_call * reps:
                work[key] = (us / count * per_call, per_call)
            else:
                work = {}                # this window lost launches
                break
        if not work:
            continue
        launches = {k: n for k, (_, n) in work.items()}
        for w in seen:
            if {k: n for k, (_, n) in w.items()} == launches:
                return {k[:60]: (us + w[k][0]) / 2 / 1e3
                        for k, (us, _) in work.items()}
        seen.append(work)
    raise SmokeFailure(
        f"torch.profiler recorded no two matching windows of device work in "
        f"{tries} tries of {reps} calls; the last window's items and counts: "
        f"{sorted((k[:50], c) for k, (_, c) in t.items())}")


def device_ms(fn, reps: int) -> float:
    """Device time per call: ``device_ms_by_kernel`` summed."""
    return sum(device_ms_by_kernel(fn, reps).values())


def device_busy(prof, wall_s: float) -> dict:
    """Device busy time, idle share over ``wall_s`` and the top five items
    of a device-activity-only torch.profiler trace (with CPU ops traced too,
    each op would carry its kernels' device time again)."""
    ops = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                  if e.self_device_time_total > 0), reverse=True)
    busy_us = sum(us for us, _ in ops)
    if busy_us == 0:                     # the profiler recorded nothing
        return {"device_busy_ms": None, "device_idle_share": None,
                "device_top_ops_ms": [], "device_trace": "empty: not measured"}
    return {"device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / (wall_s * 1e6),
            "device_top_ops_ms": [[k[:80], us / 1e3] for us, k in ops[:5]]}


def popcount_rows(x):
    import numpy as np

    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1).sum(-1)


def mafd_ulps(got, want) -> float:
    """|got - want| in float32 ulps of ``want`` (two carried mafd tensors)."""
    import numpy as np

    a, b = np.float32(got.item()), np.float32(want.item())
    return float(abs(a - b) / np.spacing(abs(b)))


def read_launches(expected, what: str) -> dict:
    """Every kernel's launch count since the last reset; fails if a kernel
    the path should run never launched."""
    from tvidz_tpu_torch import backend

    launches = {k.name: k.launches for k in backend.KERNELS}
    missing = sorted(n for n in expected if launches[n] == 0)
    check(not missing, f"{what}: kernels of the path never launched: "
                       f"{missing} ({launches})")
    return launches


# The least time the card could take, from its peak rates: NVIDIA H100
# SXM data-sheet peaks at 700 W. A Hamming distance between 64-bit
# fingerprints is bounded as the card's fastest form of it, a 64-term ±1
# int8 dot product on the tensor cores, whichever kernel computes it.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_TC_OPS_PER_S = 1979e12


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by) for moving ``nbytes`` once and doing ``ops``."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_bound(frames: int):
    """K1 over ``frames`` frames: the frames, the carry frame in and out,
    scores and hashes; per frame the factored DCT (2*8*H*W + 2*8*8*H) and
    mafd (3*H*W) in fp32."""
    return bound(
        frames * HEIGHT * WIDTH + 2 * 4 * HEIGHT * WIDTH + frames * 12,
        frames * (2 * 8 * HEIGHT * WIDTH + 2 * 64 * HEIGHT + 3 * HEIGHT * WIDTH),
        FP32_OPS_PER_S)


# -- phase 3: K1 -----------------------------------------------------------------


def check_fingerprint_block(dev):
    import numpy as np
    import torch

    from tvidz_tpu_torch.decode import synthetic
    from tvidz_tpu_torch.ops import fused, phash

    rng = np.random.default_rng(SEED)
    left, right = phash.hash_operators(HEIGHT, WIDTH, dev)
    random_luma = rng.integers(0, 256, size=(3 * FRAMES + 50, HEIGHT, WIDTH),
                               dtype=np.uint8)
    synth_luma, _ = synthetic.synthetic_video(
        3 * FRAMES + 50, HEIGHT, WIDTH, cut_frames=(40, 200, 300), seed=SEED)
    max_err, max_bits, differing, frames, ulps = 0.0, 0, 0, 0, 0.0
    for luma in (random_luma, synth_luma):
        ck = fused.initial_fingerprint_carry(HEIGHT, WIDTH, dev)
        cp = fused.initial_fingerprint_carry(HEIGHT, WIDTH, dev)
        for s in range(0, luma.shape[0], FRAMES):
            blk = luma[s:s + FRAMES]
            t = blk.shape[0]
            if t < FRAMES:
                blk = np.concatenate([blk, np.repeat(blk[-1:], FRAMES - t, 0)])
            x = torch.from_numpy(blk).to(dev)
            vt = t if t < FRAMES else None
            sk, fk, ck = fused.fingerprint_block(x, ck, left, right, valid_t=vt)
            sp, fp, cp = fused.fingerprint_block_plain(x, cp, left, right, valid_t=vt)
            torch.cuda.synchronize()
            check(torch.isfinite(sk).all().item(), "K1 scores not finite")
            max_err = max(max_err, (sk[:t] - sp[:t]).abs().max().item())
            bits = popcount_rows(phash.words_to_numpy(fk[:t])
                                 ^ phash.words_to_numpy(fp[:t]))
            max_bits = max(max_bits, int(bits.max()))
            differing += int((bits > 0).sum())
            frames += t
            check(torch.equal(ck.scene.prev_frame, cp.scene.prev_frame)
                  and bool(ck.scene.has_prev) and bool(cp.scene.has_prev),
                  "K1 carry frame differs from the plain version")
            ulps = max(ulps, mafd_ulps(ck.scene.prev_mafd, cp.scene.prev_mafd))
    check(max_err <= SCORE_TOL, f"K1 scores differ by {max_err} > {SCORE_TOL}")
    check(max_bits <= HASH_BITS_TOL,
          f"K1 hashes differ by {max_bits} bits > {HASH_BITS_TOL}")
    check(ulps <= MAFD_ULPS_TOL,
          f"K1 carried mafd {ulps} ulps from the plain version's")

    batch = check_k1_batch(dev, rng, left, right)
    stream = check_k1_stream(dev, rng)
    max_err = max(max_err, batch["score_max_abs_err"], stream["score_max_abs_err"])
    ulps = max(ulps, batch["carry_mafd_max_ulps"])

    # Median + pack from identical coefficients must be bit-exact, ties
    # included: coarse quantization plants many equal values per row.
    low = np.round(rng.normal(0, 4, size=(4096, 64))).astype(np.float32)
    low[:64] = 1.0                      # all equal: no bit set
    low_t = torch.from_numpy(low).to(dev)
    got = fused.median_pack_cuda(low_t)
    want = phash.pack_bits_i32(phash.median_threshold_bits(low_t, 8))
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K1 median/pack differs from the plain version")
    phase("k1_vs_plain", shape=[FRAMES, HEIGHT, WIDTH], frames=frames,
          score_max_abs_err=max_err, score_tol=SCORE_TOL,
          hash_max_bit_diff=max_bits, hash_bits_tol=HASH_BITS_TOL,
          carry_mafd_max_ulps=ulps, carry_mafd_ulps_tol=MAFD_ULPS_TOL,
          frames_not_bit_identical=differing, median_pack_rows_exact=low.shape[0],
          batch=batch, stream=stream)
    return max_err


def hash_bits(a, b):
    """Differing bits per frame between two (N, 2) int32 hash tensors."""
    from tvidz_tpu_torch.ops import phash

    return popcount_rows(phash.words_to_numpy(a) ^ phash.words_to_numpy(b))


def one_launch(fn, what: str):
    """``fn()``'s result; fails unless it launched K1 exactly once."""
    from tvidz_tpu_torch.ops import fused

    before = fused.K1.launches
    out = fn()
    check(fused.K1.launches == before + 1,
          f"{what}: {fused.K1.launches - before} K1 launches, not 1")
    return out


def check_k1_batch(dev, rng, left, right) -> dict:
    """K1 over the dispatcher's pass: K1_STREAMS blocks, each with its own
    carry (fresh, mid-stream, from a random frame) and valid_t, in one
    launch; each stream within the tolerances of the plain version and bit
    for bit a lone launch of it."""
    import numpy as np
    import torch

    from tvidz_tpu_torch.ops import fused

    k = K1_STREAMS
    x = torch.from_numpy(rng.integers(0, 256, size=(2, k, FRAMES, HEIGHT, WIDTH),
                                      dtype=np.uint8)).to(dev)
    carries = [fused.initial_fingerprint_carry(HEIGHT, WIDTH, dev) for _ in range(k)]
    # Round 0 puts every stream mid-stream except the first, which stays
    # fresh for round 1.
    _, _, warm = fused.fingerprint_blocks_batched_plain(
        list(x[0]), carries, [FRAMES] * k, left, right)
    carries = [carries[0], *warm[1:]]
    valid = [FRAMES, 1, 77, FRAMES][:k]
    sb, fb, cb = one_launch(lambda: fused.fingerprint_blocks_batched(
        list(x[1]), carries, valid, left, right), "K1 batch")
    sp, fp, cp = fused.fingerprint_blocks_batched_plain(
        list(x[1]), carries, valid, left, right)
    err, bits, ulps = 0.0, 0, 0.0
    for j in range(k):
        s1, f1, c1 = fused.fingerprint_block(x[1, j], carries[j], left, right,
                                             valid_t=valid[j])
        torch.cuda.synchronize()
        check(torch.equal(sb[j], s1) and torch.equal(fb[j], f1)
              and all(torch.equal(a, b) for a, b in zip(cb[j].scene, c1.scene)),
              f"K1 batch stream {j} differs from a lone launch of it")
        check(torch.equal(cb[j].scene.prev_frame, cp[j].scene.prev_frame)
              and bool(cb[j].scene.has_prev),
              f"K1 batch stream {j}: carry frame differs from the plain version")
        err = max(err, (sb[j] - sp[j]).abs().max().item())
        ulps = max(ulps, mafd_ulps(cb[j].scene.prev_mafd, cp[j].scene.prev_mafd))
        bits = max(bits, int(hash_bits(fb[j], fp[j]).max()))
    check(err <= SCORE_TOL and bits <= HASH_BITS_TOL and ulps <= MAFD_ULPS_TOL,
          f"K1 batch: scores {err}, hash bits {bits}, carried mafd {ulps} ulps")
    return {"streams": k, "valid_t": valid, "score_max_abs_err": err,
            "hash_max_bit_diff": bits, "carry_mafd_max_ulps": ulps,
            "bit_equal_to_lone_launches": True}


def check_k1_stream(dev, rng) -> dict:
    """K1 over a whole ragged stream of K1_STREAM_FRAMES frames in one launch
    (``fingerprint_stream``): within the tolerances of the plain version,
    and bit for bit the chained launches of its FRAMES-frame blocks."""
    import numpy as np
    import torch

    from tvidz_tpu_torch.decode import synthetic
    from tvidz_tpu_torch.ops import fused, phash

    n = K1_STREAM_FRAMES
    luma, _ = synthetic.synthetic_video(n, HEIGHT, WIDTH,
                                        cut_frames=(100, 1500, 4000), seed=SEED)
    luma[::3] = rng.integers(0, 256, size=luma[::3].shape, dtype=np.uint8)
    x = torch.from_numpy(luma).to(dev)
    ss, fs = one_launch(lambda: fused.fingerprint_stream(x), "K1 stream")
    sp, fp = fused.fingerprint_stream_plain(x)
    left, right = phash.hash_operators(HEIGHT, WIDTH, dev)
    carry = fused.initial_fingerprint_carry(HEIGHT, WIDTH, dev)
    chained = []
    for s in range(0, n, FRAMES):
        sc, fpk, carry = fused.fingerprint_block(x[s:s + FRAMES], carry, left, right)
        chained.append((sc, fpk))
    torch.cuda.synchronize()
    check(torch.isfinite(ss).all().item() and ss.shape == (n,) and fs.shape == (n, 2),
          f"K1 stream: shapes {tuple(ss.shape)}, {tuple(fs.shape)}")
    check(torch.equal(ss, torch.cat([c[0] for c in chained]))
          and torch.equal(fs, torch.cat([c[1] for c in chained])),
          "K1 stream differs from its chained block launches")
    err = (ss - sp).abs().max().item()
    bits = hash_bits(fs, fp)
    check(err <= SCORE_TOL and int(bits.max()) <= HASH_BITS_TOL,
          f"K1 stream: scores {err}, hash bits {int(bits.max())}")
    return {"frames": n, "score_max_abs_err": err,
            "hash_max_bit_diff": int(bits.max()),
            "frames_not_bit_identical": int((bits > 0).sum()),
            "bit_equal_to_chained_launches": True}


# -- phase 4: K2 -----------------------------------------------------------------


# query -> rows holding an exact copy, the lower row expected as the argmin
TILE_TIES = {13: (256 * 3000 + 17, 256 * 5 + 200),
             15: (256 * 101, 256 * 100 + 255),
             19: (256 * 50 + 200, 256 * 50 + 10)}
GATE_TIE = (600_000, 300_001)                   # q[17] ^ 3 in both words: 4
# K4 gives each CTA a contiguous range of 256-row tiles, walked in
# ascending order: a copy in the same row of the next tile (the same
# thread, later in its range); and (``planted``) copies on both sides of
# range edges of the grid each argmin mode launches on this card.
THREAD_TIE = {20: (256 * 2001 + 77, 256 * 2000 + 77)}
ARGMIN_MODES = ("full", "full_cols", "twophase", "query_nearest")


def planted(dev) -> tuple:
    """(query -> rows holding an exact copy, the lower one the argmin;
    {mode: K4's grid for SCAN_N rows}): TILE_TIES, THREAD_TIE and ties
    across the range edges of CTAs 1 and grid / 2 of each argmin mode's
    grid."""
    from tvidz_tpu_torch.ops import hamming

    tiles = SCAN_N // 256
    grids = {mode: hamming.corpus_scan_tc_grid(mode, SCAN_N, dev)
             for mode in hamming.MODES}
    check(all(1 < g <= tiles for g in grids.values()),
          f"K4 grids {grids} for {tiles} tiles: no range edge to plant at")
    edges = sorted({256 * (tiles * c // g) for g in (grids[m] for m in ARGMIN_MODES)
                    for c in (1, g // 2)})
    return {**TILE_TIES, **THREAD_TIE,
            **{21 + i: (e, e - 1) for i, e in enumerate(edges)}}, grids


def scan_inputs(dev, ties):
    """(q, corpus) at (SCAN_M, SCAN_N), seeded, with sentinel rows, exact
    and near ties, and a copy of q[k] at each row of ``ties[k]``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 1)
    corpus = rng.integers(0, 2 ** 32, size=(SCAN_N, 2), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(SCAN_M, 2), dtype=np.uint32)
    corpus[-4096:] = 0xFFFFFFFF                     # sentinel padding rows
    corpus[[1000, 500_000]] = q[3]                  # exact hits, a tie
    corpus[[70_000, 900_000, 900_001]] = q[5] ^ np.uint32(1)   # dist-2 ties
    corpus[[2048 * 7 + 1023, 2048 * 7 + 1024]] = q[9]  # across a CTA edge
    q[11] = 0xFFFFFFFF                              # nearest are sentinels
    # Copies of q[k] at ``ties[k]`` (TILE_TIES, THREAD_TIE, ``planted``'s
    # range edges); a dist-4 tie.
    for k, rows in ties.items():
        corpus[list(rows)] = q[k]
    corpus[list(GATE_TIE)] = q[17] ^ np.uint32(3)
    to = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    return to(q), to(corpus)


def check_planted(name, ties, q_min, q_arg, n=SCAN_N):
    """The planted answers of ``scan_inputs(dev, ties)`` (M > max(ties))."""
    check(int(q_min[3]) == 0 and int(q_arg[3]) == 1000, f"{name} missed the planted tie")
    check(int(q_min[5]) == 2 and int(q_arg[5]) == 70_000, f"{name} missed a dist-2 tie")
    check(int(q_arg[9]) == 2048 * 7 + 1023, f"{name} tie across a CTA edge")
    for k, rows in ties.items():
        check(int(q_min[k]) == 0 and int(q_arg[k]) == min(rows),
              f"{name} tie of q[{k}] across tiles: {int(q_arg[k])} != {min(rows)}")
    check(int(q_min[17]) == 4 and int(q_arg[17]) == min(GATE_TIE),
          f"{name} dist-4 tie behind the gate: {int(q_min[17])}, {int(q_arg[17])}")
    if n == SCAN_N:
        check(int(q_min[11]) == 0 and int(q_arg[11]) == SCAN_N - 4096,
              f"{name} sentinel rows not scanned like the reference")


def check_corpus_scan(dev):
    import torch

    from tvidz_tpu_torch.ops import hamming

    ties, _ = planted(dev)
    q, corpus = scan_inputs(dev, ties)
    fk, mk, ak = hamming.corpus_min_distance(q, corpus)
    fp, mp, ap = hamming.corpus_min_distance_plain(q, corpus)
    mk2, ak2 = hamming.corpus_min_distance(q, corpus, frame_min=False)[1:]
    fk2 = hamming.corpus_frame_min_xor(q, corpus)
    torch.cuda.synchronize()
    err = max((fk - fp).abs().max().item(), (mk - mp).abs().max().item(),
              (ak - ap).abs().max().item(), (fk2 - fp).abs().max().item())
    check(err == 0 and torch.equal(mk2, mp) and torch.equal(ak2, ap)
          and torch.equal(fk2, fp),
          f"K2 differs from the plain version (max abs err {err})")
    check_planted("K2", ties, mk, ak)
    phase("k2_vs_plain", m=SCAN_M, n=SCAN_N, max_abs_err=err,
          outputs_exact=True, frame_min_only_exact=True)
    return float(err)


def more_queries(q, m):
    """``q`` followed by seeded random queries, ``m`` rows in all."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 5)
    extra = rng.integers(0, 2 ** 32, size=(m - q.shape[0], 2), dtype=np.uint32)
    return torch.cat([q, torch.from_numpy(extra.view(np.int32)).to(q.device)])


def check_scan_modes(dev):
    """Every K4 mode and K2's frame_min-only switch against the plain XOR
    scan, exactly: at M=128, N=2^20 with the planted ties; at M=37; at N
    not a multiple of K4's 256-row tile; at M=1024 (a whole video) and
    M=16384 (the largest); at N=1 and at N below one CTA's range; on a
    corpus of one repeated row (every query ties with every row: the
    argmin must be row 0)."""
    import torch

    from tvidz_tpu_torch.ops import hamming

    ties, grids = planted(dev)
    q, corpus = scan_inputs(dev, ties)
    cases = [("m128", q, corpus), ("m37", q[:37], corpus),
             ("n_ragged", q, corpus[:SCAN_N - 101]),
             ("m1024", more_queries(q, 1024), corpus),
             ("m16384", more_queries(q, 16384), corpus[:1 << 16]),
             ("n1", q, corpus[:1]), ("n3000", q, corpus[:3000]),
             ("all_tied", q, corpus[1000:1001].repeat(1 << 16, 1))]
    err, checked = 0, []
    for name, qq, cc in cases:
        want = hamming.corpus_min_distance_plain(qq, cc)
        got = {f"k4_{mode}": hamming.corpus_scan_tc(qq, cc, mode)
               for mode in hamming.MODES}
        got["k2_frame_min"] = (hamming.corpus_frame_min_xor(qq, cc), None, None)
        torch.cuda.synchronize()
        for variant, outs in got.items():
            for o, w in zip(outs, want):
                if o is not None:
                    err = max(err, (o - w).abs().max().item())
                    check(torch.equal(o, w),
                          f"{variant} differs from the plain version at {name}")
        if name in ("m128", "m37", "n_ragged", "m1024"):
            for mode in ARGMIN_MODES:
                check_planted(f"k4 {mode} ({name})", ties,
                              *got[f"k4_{mode}"][1:], n=cc.shape[0])
        if name == "all_tied":
            check(int(want[2].max()) == 0, "all-tied corpus: plain argmin not 0")
        checked.append({"case": name, "m": qq.shape[0], "n": cc.shape[0]})
    # The ±1 plain version agrees with the XOR one on the main case.
    pm1 = hamming.corpus_scan_pm1_plain(q, corpus, "full")
    want = hamming.corpus_min_distance_plain(q, corpus)
    check(all(torch.equal(a, b) for a, b in zip(pm1, want)),
          "the ±1 plain version differs from the XOR plain version")
    phase("k4_vs_plain", modes=list(hamming.MODES), also=["k2_frame_min"],
          max_abs_err=err, exact=True, cases=checked, grids_at_2_20=grids,
          range_edge_ties={k: v for k, v in ties.items() if k > 20})
    return float(err)


# -- phase 5: K3 -----------------------------------------------------------------


def fragment_inputs(dev, shape, seed):
    """Seeded (queries, q_lens, corpus, lens) at ``shape`` = (Q, Tq_pad, V,
    Tc) as device int32 views, with, per query q: a fragment of video
    7 + (31 q mod (V - 7)) taken at offset 100 + q with 3-bit damage on every
    4th frame; video 5 cut short; video 6 empty. Video 7 repeats a 50-frame
    period, so a query taken from it scores its maximum at every offset
    congruent to its start modulo 50 (ties across tiles), and the answer is
    the first of them. Returns the expected
    (video, offset, q_len) per query too."""
    import numpy as np
    import torch

    qn, tq_pad, v, tc = shape
    rng = np.random.default_rng(seed)
    corpus = rng.integers(0, 2 ** 32, size=(v, tc, 2), dtype=np.uint32)
    lens = np.full(v, tc, np.int32)
    lens[5], lens[6] = tc // 3, 0
    corpus[7] = np.resize(corpus[7, :50], (tc, 2))
    qs = rng.integers(0, 2 ** 32, size=(qn, tq_pad, 2), dtype=np.uint32)
    q_lens = np.asarray([tq_pad - 37 * q for q in range(qn)], np.int32)
    plants = []
    for q in range(qn):
        row, off, n = 7 + (31 * q) % (v - 7), 100 + q, int(q_lens[q])
        qs[q, :n] = corpus[row, off:off + n]
        qs[q, :n:4, 0] ^= np.uint32(0b111)
        plants.append((row, off % 50 if row == 7 else off, n))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)  # noqa: E731
                                    if a.dtype == np.uint32 else a).to(dev)
    return (to(qs), to(q_lens), to(corpus), to(lens)), plants


def check_fragment_search(dev):
    import torch

    from tvidz_tpu_torch.ops import align

    err, checked = 0, []
    for name, shape, seed in (("a", FRAG_A, SEED + 3), ("b", FRAG_B, SEED + 4),
                              ("c", FRAG_C, SEED + 4)):
        (qs, q_lens, corpus, lens), plants = fragment_inputs(dev, shape, seed)
        cases = [(corpus, lens)]
        if name == "a":                          # V not a multiple of 8
            cases.append((corpus[:1021], lens[:1021]))
        for c, ln in cases:
            ko, ks = align.fragment_search_batch(qs, q_lens, c, ln, FRAG_THR)
            po, ps = align.fragment_search_batch_plain(qs, q_lens, c, ln,
                                                       FRAG_THR)
            torch.cuda.synchronize()
            err = max(err, (ko - po).abs().max().item(),
                      (ks - ps).abs().max().item())
            check(torch.equal(ko, po) and torch.equal(ks, ps),
                  f"K3 differs from the plain version at ({name}) V={c.shape[0]}")
            zero = ks == 0
            check(zero.any().item() and (ko[zero] == -(shape[1] - 1)).all().item(),
                  f"K3 all-zero rows at ({name}) do not report -(Tq_pad-1)")
            check(int(ks[:, 6].max()) == 0, f"K3 matched an empty row at ({name})")
        for q, (row, off, n) in enumerate(plants):
            check(int(ks[q, row]) == n and int(ko[q, row]) == off,
                  f"K3 missed the planted fragment of query {q} at ({name}): "
                  f"{int(ko[q, row])}, {int(ks[q, row])} != {off}, {n}")
        if name == "c":                          # each row == a single call
            for q in range(shape[0]):
                so, ss = align.fragment_search(qs[q], q_lens[q:q + 1], corpus,
                                               lens, FRAG_THR)
                check(torch.equal(so, ko[q]) and torch.equal(ss, ks[q]),
                      f"K3 batch row {q} differs from its single call")
        checked.append({"shape": name, "q_tq_pad_v_tc": list(shape),
                        "max_score": int(ks.max())})
    # At shape (a): thresholds 0 and 40 (nearly every pair matches), a
    # bucket of identical rows queried with that row (every pair matches),
    # and still runs inside random videos (blocks that match whole beside
    # blocks that match in part), at thresholds 10 and 40.
    (qs, q_lens, corpus, lens), _ = fragment_inputs(dev, FRAG_A, SEED + 3)
    dense_c, dense_q = dense_inputs(corpus, qs)
    runs_c, runs_q = still_runs(corpus, qs)
    for name, q_, c_, thr in (("thr0", qs, corpus, 0), ("thr40", qs, corpus, 40),
                              ("dense", dense_q, dense_c, FRAG_THR),
                              ("still_runs", runs_q, runs_c, FRAG_THR),
                              ("still_runs_thr40", runs_q, runs_c, 40)):
        got = align.fragment_search_batch(q_, q_lens, c_, lens, thr)
        want = align.fragment_search_batch_plain(q_, q_lens, c_, lens, thr)
        torch.cuda.synchronize()
        err = max(err, *((g - w).abs().max().item() for g, w in zip(got, want)))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K3 differs from the plain version at (a) {name}")
        if name == "dense":
            check(int(got[1][0, 0]) == int(q_lens[0]) and int(got[1][0, 6]) == 0,
                  f"K3 dense bucket: {got[1][0, :8].tolist()}")
        checked.append({"shape": f"a_{name}", "threshold": thr,
                        "max_score": int(got[1].max())})
    phase("k3_vs_plain", threshold=FRAG_THR, max_abs_err=err, exact=True,
          shapes=checked)
    return float(err)


def dense_inputs(corpus, qs):
    """A bucket of ``corpus``'s shape holding one row everywhere, and
    ``qs``'s shape of the same row: every valid pair matches (a static or
    black scene)."""
    row = corpus[0, 0]
    return (row.expand(corpus.shape).contiguous(),
            row.expand(qs.shape).contiguous())


def still_runs(corpus, qs):
    """``corpus`` and ``qs`` with runs of one row (a still scene) of
    seeded lengths and places in every fourth video and in each query."""
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    corpus, qs = corpus.clone(), qs.clone()
    row = corpus[0, 0].clone()
    for v in range(0, corpus.shape[0], 4):
        a = int(rng.integers(0, corpus.shape[1]))
        corpus[v, a:a + int(rng.integers(1, 700))] = row
    for q in range(qs.shape[0]):
        a = int(rng.integers(0, qs.shape[1]))
        qs[q, a:a + int(rng.integers(1, 500))] = row
    return corpus, qs


# -- the race against another tree (--against) ----------------------------------

# (label, M, N): K4 at M=128 against the smoke corpus (2^20) and 2^24
# random rows, and at M=1024 (a whole video, ``search_fingerprints``).
RACE_K4 = (("m128_2^20", 128, SCAN_N), ("m128_2^24", 128, 1 << 24),
           ("m1024_2^20", 1024, SCAN_N))
# K1 at the main path's block and at the bench's single-dispatch pass,
# through ``fused.fingerprint_block`` (which both trees have; each takes any
# T), from a mid-stream carry.
RACE_K1 = (("t128", FRAMES), ("t2^17", K1_VALUE_FRAMES))
# K3 at the three parity shapes and on the bucket of identical rows.
RACE_K3 = (("a", FRAG_A), ("b", FRAG_B), ("c", FRAG_C), ("a_dense", FRAG_A))


def digest(outs) -> str:
    """A short hash of a kernel's outputs, to hold two trees equal."""
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure_arm(root: str, dump: str) -> dict:
    """One arm of the race, in a fresh process: the port found at ``root``
    builds its kernels, analyzes a short upload and then a 1024-frame one
    against a prefilled 2^20-fingerprint store (``time_analyze``), then
    times K1 (``RACE_K1``), K4 (every mode, ``RACE_K4``) and K3
    (``RACE_K3``): device ms from torch.profiler and per-call ms from CUDA
    events, with a digest of each output. K1's outputs are also saved to
    ``dump`` (an .npz), to be held across trees by its tolerances."""
    import torch

    import tvidz_tpu_torch
    from tvidz_tpu_torch import backend, cli
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.ops import align, fused, hamming, phash

    pkg = os.path.dirname(os.path.realpath(tvidz_tpu_torch.__file__))
    check(pkg == os.path.join(os.path.realpath(root), "tvidz_tpu_torch"),
          f"arm for {root} imported the port from {pkg}")
    dev = backend.resolve_device("cuda")
    backend.build_all()
    arm = {"root": root, "kernels": [k.repo_source for k in backend.KERNELS]}
    work = tempfile.mkdtemp(prefix="tvidz_chip_race_")
    os.environ["TVIDZ_TMP_DIR"] = os.path.join(work, "tmp")
    os.makedirs(os.environ["TVIDZ_TMP_DIR"])
    try:
        db = os.path.join(work, "corpus.db")
        prefill_store(db)
        # A short upload first, so that the process's first CUDA calls
        # (library loads, the machine's cold file cache) are not timed.
        warm = os.path.join(work, "warm", "warm.y4m")
        os.makedirs(os.path.dirname(warm))
        write_synthetic_y4m(warm, num_frames=256, height=180, width=320,
                            cut_frames=(100,), seed=9)
        analyzer, _, _ = cli._local_session(f"sqlite:///{db}", "cuda")
        with contextlib.redirect_stdout(io.StringIO()):
            check(analyzer.analyze(os.path.dirname(warm), "warm.y4m").status
                  == "done", "race arm: the warm-up analyze failed")
        arm["analyze"] = time_analyze(work, f"sqlite:///{db}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def timed(fn, reps):
        outs = fn()
        return {"device_ms": device_ms(fn, reps), "ms": cuda_ms(fn, reps),
                "digest": digest(outs)}

    rows, k1_out = {}, {}
    left, right = phash.hash_operators(HEIGHT, WIDTH, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    for label, frames in RACE_K1:
        x = torch.randint(0, 256, (frames, HEIGHT, WIDTH), dtype=torch.uint8,
                          device=dev, generator=gen)
        # A carry from the block before: the call continues a stream.
        _, _, carry = fused.fingerprint_block(x[:FRAMES], fused.initial_fingerprint_carry(
            HEIGHT, WIDTH, dev), left, right)
        sc, fp, c = fused.fingerprint_block(x, carry, left, right)
        fn = lambda: fused.fingerprint_block(x, carry, left, right)[:2]  # noqa: E731
        k1_out.update({f"{label}_scores": sc, f"{label}_fps": fp,
                       f"{label}_frame": c.scene.prev_frame,
                       f"{label}_mafd": c.scene.prev_mafd})
        rows[f"K1 {label}"] = timed(fn, 20 if frames == FRAMES else 5)
        del x
    import numpy as np

    np.savez(dump, **{k: v.cpu().numpy() for k, v in k1_out.items()})
    q, corpus = scan_inputs(dev, {**TILE_TIES, **THREAD_TIE})
    gen.manual_seed(SEED + 6)
    big = torch.randint(-2 ** 31, 2 ** 31, (1 << 24, 2), dtype=torch.int32,
                        device=dev, generator=gen)
    for label, m, n in RACE_K4:
        cc = corpus if n == SCAN_N else big
        qq = more_queries(q, m) if m > q.shape[0] else q
        for mode in hamming.MODES:
            rows[f"K4 {mode} {label}"] = timed(
                lambda: hamming.corpus_scan_tc(qq, cc, mode),
                20 if n == SCAN_N else 5)
    del big
    for name, shape in RACE_K3:
        (qs, ql, c, ln), _ = fragment_inputs(dev, shape, SEED + 3)
        if name == "a_dense":
            c, qs = dense_inputs(c, qs)
        rows[f"K3 {name}"] = timed(
            lambda: align.fragment_search_batch(qs, ql, c, ln, FRAG_THR), 5)
    arm["rows"] = rows
    return arm


def k1_across(old: dict, new: dict) -> dict:
    """K1's outputs of an old and a new arm held by K1's tolerances (the
    reduction order differs between the trees, so not by digest)."""
    import numpy as np

    out = {}
    for label, _ in RACE_K1:
        err = float(np.abs(old[f"{label}_scores"] - new[f"{label}_scores"]).max())
        bits = popcount_rows(old[f"{label}_fps"].view(np.uint32)
                             ^ new[f"{label}_fps"].view(np.uint32))
        check(err <= SCORE_TOL and int(bits.max()) <= HASH_BITS_TOL
              and np.array_equal(old[f"{label}_frame"], new[f"{label}_frame"])
              and abs(float(old[f"{label}_mafd"]) - float(new[f"{label}_mafd"]))
              <= SCORE_TOL,
              f"race: K1 {label} differs between the trees beyond its "
              f"tolerances (scores {err}, bits {int(bits.max())})")
        out[label] = {"score_max_abs_err": err, "hash_max_bit_diff": int(bits.max()),
                      "frames_not_bit_identical": int((bits > 0).sum()),
                      "carry_frame_equal": True}
    return out


def race_against(old_root: str, smi: str) -> None:
    """This tree against the one at ``old_root``: four fresh processes in
    turns (old, new, new, old), each ``measure_arm``; K3 and K4 outputs
    equal across all four, K1's equal within each tree and within K1's
    tolerances across them; old and new each the mean of their two arms."""
    import numpy as np

    new_root = os.path.dirname(os.path.abspath(__file__))
    arms, dumps = [], []
    work = tempfile.mkdtemp(prefix="tvidz_chip_race_k1_")
    try:
        for i, root in enumerate((old_root, new_root, new_root, old_root)):
            dump = os.path.join(work, f"arm{i}.npz")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure", root,
                 "--dump", dump], capture_output=True, text=True, timeout=900)
            check(proc.returncode == 0, f"race arm {root} failed (exit "
                                        f"{proc.returncode}): {proc.stderr[-3000:]}")
            arms.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            with np.load(dump) as z:
                dumps.append({k: z[k] for k in z.files})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mean = lambda a, b: (a + b) / 2  # noqa: E731
    rows = []
    for key in arms[0]["rows"]:
        got = [arm["rows"][key] for arm in arms]
        # K1: each tree repeats itself; across trees, k1_across below.
        same = ((got[0], got[3]), (got[1], got[2])) if key.startswith("K1 ") \
            else ((got[0], got[1], got[2], got[3]),)
        check(all(len({g["digest"] for g in grp}) == 1 for grp in same),
              f"race: {key} differs between runs that should agree")
        old_dev = mean(got[0]["device_ms"], got[3]["device_ms"])
        new_dev = mean(got[1]["device_ms"], got[2]["device_ms"])
        rows.append({"case": key, "old_device_ms": old_dev,
                     "new_device_ms": new_dev, "old_over_new": old_dev / new_dev,
                     "old_ms": mean(got[0]["ms"], got[3]["ms"]),
                     "new_ms": mean(got[1]["ms"], got[2]["ms"]),
                     "device_ms_by_arm": [g["device_ms"] for g in got]})
    k1 = k1_across(dumps[0], dumps[1])
    analyze = [{"tree": "old" if i in (0, 3) else "new",
                "frames_per_s": a["analyze"]["analyze_frames_per_s"],
                "stages": a["analyze"]["analyze_stages"],
                "traced_device_busy_ms": a["analyze"]["device_busy_ms"],
                "traced_idle_share": a["analyze"]["device_idle_share"]}
               for i, a in enumerate(arms)]
    phase("race", card=smi, old=old_root, new=new_root,
          order=["old", "new", "new", "old"], rows=rows, k1_old_vs_new=k1,
          analyze=analyze,
          kernels={"old": arms[0]["kernels"], "new": arms[1]["kernels"]})


# -- phase 6: the main path --------------------------------------------------------


def prefill_store(db_path: str) -> int:
    """A realistic corpus, seeded: FILLER_VIDEOS videos with timestamps and
    FILLER_FP_VIDEOS x FILLER_FP_FRAMES (= 2^20) random fingerprints,
    written in one transaction into the store's own schema."""
    import numpy as np

    from tvidz_tpu_torch.corpus.store import Store

    Store(f"sqlite:///{db_path}").close()          # creates the schema
    rng = np.random.default_rng(SEED + 2)
    con = sqlite3.connect(db_path)
    with con:
        con.executemany(
            "INSERT INTO videos (id, filename, upload_time) VALUES (?, ?, ?)",
            [(i + 1, f"filler_{i:05d}.mp4", "2026-01-01T00:00:00")
             for i in range(FILLER_VIDEOS)])
        rows = []
        for i in range(FILLER_VIDEOS):
            k = np.sort(rng.choice(15000, size=int(rng.integers(4, 40)),
                                   replace=False))
            # Off the 1/25 s frame grid, so no filler timestamp can equal a
            # test video's cut.
            rows.append((i + 1, json.dumps([round(x * 0.04 + 0.013, 6)
                                            for x in k.tolist()])))
        con.executemany(
            "INSERT INTO video_timestamps (video_id, timestamps) VALUES (?, ?)",
            rows)
        con.executemany(
            "INSERT INTO video_fingerprints (video_id, words, fingerprints) "
            "VALUES (?, 2, ?)",
            [(i + 1, rng.integers(0, 2 ** 32, size=(FILLER_FP_FRAMES, 2),
                                  dtype=np.uint32).tobytes())
             for i in range(FILLER_FP_VIDEOS)])
    con.close()
    return FILLER_FP_VIDEOS * FILLER_FP_FRAMES


def run_cli(cli, argv):
    """(exit code, the JSON lines it printed) of one in-process CLI call;
    ``search`` prints one indented JSON document instead."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*argv, "--device", "cuda"])
    if argv[0] == "search":
        return rc, [json.loads(buf.getvalue())]
    return rc, [json.loads(x) for x in buf.getvalue().splitlines()
                if x.startswith("{")]


def drive_main_path(work: str):
    from tvidz_tpu_torch import backend, cli
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.ops import align, fused, hamming

    def video(sub, name, seed, n, cuts):
        os.makedirs(os.path.join(work, sub), exist_ok=True)
        path = os.path.join(work, sub, name)
        _, expected = write_synthetic_y4m(path, num_frames=n, height=180,
                                          width=320, cut_frames=cuts,
                                          seed=seed)
        return path, expected

    alpha, alpha_cuts = video("orig", "alpha.y4m", 1, 300, (60, 150, 240))
    video("orig", "beta.y4m", 2, 260, (50, 170))
    renamed = os.path.join(work, "copy", "renamed.y4m")
    os.makedirs(os.path.dirname(renamed))
    shutil.copy(alpha, renamed)
    gamma, gamma_cuts = video("fresh", "gamma.y4m", 3, 280, (70, 200))
    delta, delta_cuts = video("fresh", "delta.y4m", 4, 300, (45, 130, 210))

    db = os.path.join(work, "corpus.db")
    t0 = time.perf_counter()
    n_fp = prefill_store(db)
    url = f"sqlite:///{db}"
    phase("store_prefill", videos=FILLER_VIDEOS, fingerprints=n_fp,
          seconds=time.perf_counter() - t0)

    sessions = []
    local_session = cli._local_session

    def recording_session(*a, **k):
        sessions.append(local_session(*a, **k))
        return sessions[-1]

    cli._local_session = recording_session
    backend.reset_launch_counts()
    try:
        rc, out = run_cli(cli, ["ingest", os.path.join(work, "orig"),
                                "--db", url])
        check(rc == 0 and out[-1]["ingested"] == 2
              and all(r["duplicates"] == [] for r in out[:-1]),
              f"ingest: {out}")
        check(out[-1]["corpus_fingerprints"] == n_fp + 560,
              f"ingest corpus size: {out[-1]}")
        rc, (res,) = run_cli(cli, ["analyze", renamed, "--db", url,
                                   "--compact"])
        check(rc == 0 and res["duplicates"] == ["alpha.y4m"],
              f"renamed copy verdict: {res}")
        rc, (fresh,) = run_cli(cli, ["analyze", gamma, "--db", url,
                                     "--compact"])
        check(rc == 0 and fresh["duplicates"] == []
              and fresh["scene_cuts"] == gamma_cuts, f"fresh video: {fresh}")
        os.environ["TVIDZ_SCENE_NATIVE"] = "0"
        try:
            rc, (dev_cut,) = run_cli(cli, ["analyze", delta, "--db", url,
                                           "--compact"])
        finally:
            del os.environ["TVIDZ_SCENE_NATIVE"]
        check(rc == 0 and dev_cut["scene_cuts"] == delta_cuts
              and dev_cut["duplicates"] == [],
              f"K1-scored cuts {dev_cut} != planted {delta_cuts}")
        rc, (found,) = run_cli(cli, ["search", renamed, "--db", url])
        check(rc == 0 and found["best_alignments"][0]["filename"] == "alpha.y4m"
              and found["best_alignments"][0]["offset_frames"] == 0
              and found["best_alignments"][0]["match_count"] == 300
              and found["fingerprint_matches"][0]["filename"] == "alpha.y4m",
              f"search of the renamed copy: {found['best_alignments']}")
    finally:
        cli._local_session = local_session
    launches = read_launches(
        {fused.K1.name, align.K3.name, hamming.K4.name}, "CLI main path")
    _analyzer, store, corpus = sessions[-1]
    check(corpus._fp_dev.device.type == "cuda"
          and corpus._ts_dev.device.type == "cuda",
          "corpus tensors are not on the GPU")
    phase("main_path", launches=launches, renamed_copy=res["duplicates"],
          fresh_duplicates=fresh["duplicates"],
          search_top_alignment=found["best_alignments"][0],
          k1_scored_cuts=dev_cut["scene_cuts"], planted_cuts=delta_cuts,
          corpus_fingerprints=corpus.num_fingerprints,
          alpha_cuts=alpha_cuts)

    # The two corpus scans on the smoke corpus, each with its own counts:
    # alpha's first 128 fingerprints find alpha.
    alpha_id = found["best_alignments"][0]["video_id"]
    query = store.get_fingerprints(alpha_id)[:128]
    scans = {}
    for name, call in (
            ("search_fingerprints", lambda: dict(corpus.search_fingerprints(query))),
            ("nearest_video_counts", lambda: corpus.nearest_video_counts(query))):
        backend.reset_launch_counts()
        got = call()
        scans[name] = {"alpha": got.get(alpha_id),
                       "launches": read_launches({hamming.K4.name}, name)}
        check(got.get(alpha_id, 0) >= 128 if name == "search_fingerprints"
              else got.get(alpha_id) == 128, f"{name} on the smoke corpus: {got}")
    phase("corpus_scans", alpha_video_id=alpha_id, **scans)
    return {"cli": launches, **{k: v["launches"] for k, v in scans.items()}}, url


def drive_service(work: str, url: str, smi: str) -> dict:
    """The port's InspectorApp in process on the card over the fake S3 ->
    SQS path, shared dispatcher on, poller running, on the prefilled store:
    an original and a fresh video uploaded concurrently, then a renamed copy
    (early exit off) with its SSE stream read to 'done'; then
    /search/fragment, /search/fragments and /search/video. Launch counts are
    zeroed just before and read just after."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.corpus.store import Store
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.ops import align, fused, hamming
    from tvidz_tpu_torch.service import fakes
    from tvidz_tpu_torch.service.app import create_app

    cfg = Config()
    cfg.service.sse_poll_s = 0.02
    check(cfg.pipeline.shared_dispatcher, "the default config runs no dispatcher")
    sqs, s3 = fakes.FakeSQS(), fakes.FakeS3(os.path.join(work, "s3"))
    sqs.create_queue(cfg.service.sqs_queue)
    s3.create_bucket(cfg.service.s3_bucket)
    s3.configure_notification(sqs, cfg.service.sqs_queue)
    paths = {}
    for name, seed, n, cuts in (("omega.y4m", 11, 400, (80, 210, 330)),
                                ("psi.y4m", 12, 360, (90, 250))):
        paths[name] = os.path.join(work, "svc", name)
        os.makedirs(os.path.dirname(paths[name]), exist_ok=True)
        write_synthetic_y4m(paths[name], num_frames=n, height=180, width=320,
                            cut_frames=cuts, seed=seed)
    paths["omega-copy.y4m"] = paths["omega.y4m"]

    t0 = time.perf_counter()
    app = create_app(config=cfg, store=Store(url), s3=s3, sqs=sqs,
                     device="cuda")
    boot_s = time.perf_counter() - t0
    client = app.wsgi.test_client()
    walls = {}

    def upload(name):
        walls[name] = time.perf_counter()
        s3.put_file(cfg.service.s3_bucket, name, paths[name])

    def verdict(name, timeout=300):
        deadline = time.time() + timeout
        while time.time() < deadline:
            data = client.get(f"/status/{name}").get_json()
            if data.get("status") in ("done", "error"):
                walls[name] = time.perf_counter() - walls[name]
                return data
            time.sleep(0.02)
        raise SmokeFailure(f"service: no verdict for {name} in {timeout} s")

    backend.reset_launch_counts()
    try:
        app.start_poller()
        upload("omega.y4m")
        upload("psi.y4m")
        omega, psi = verdict("omega.y4m"), verdict("psi.y4m")
        check(omega["status"] == "done" and omega["duplicates"] == []
              and psi["status"] == "done" and psi["duplicates"] == [],
              f"service: original {omega}, fresh {psi}")
        app.config.pipeline.early_exit = False
        frames = []

        def read_sse():
            for chunk in client.stream("/status/stream/omega-copy.y4m"):
                frames.append(json.loads(chunk.decode()[len("data: "):]))

        sse = threading.Thread(target=read_sse, daemon=True)
        sse.start()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            upload("omega-copy.y4m")
            copy = verdict("omega-copy.y4m")
            torch.cuda.synchronize()
        traced = device_busy(prof, walls["omega-copy.y4m"])
        sse.join(timeout=60)
        check(copy["status"] == "done" and copy["duplicates"] == ["omega.y4m"],
              f"service: renamed copy {copy}")
        check(not sse.is_alive() and frames and frames[-1]["status"] == "done"
              and frames[-1]["duplicates"] == ["omega.y4m"],
              f"service: SSE stream did not end on done: {frames[-1:]}")
        # Every upload block went through the dispatcher: one K1 launch a
        # pass. The passes here hold about one block each, so this does not
        # tell a launch a pass from one a block; k1_vs_plain's batch does.
        upload_k1, passes = fused.K1.launches, app.block_dispatcher.passes
        check(upload_k1 == passes > 0,
              f"service: {upload_k1} K1 launches in {passes} dispatcher passes")

        span = {"filename": "omega-copy.y4m", "start_frame": 50, "num_frames": 300}
        t0 = time.perf_counter()
        frag = client.post("/search/fragment", json_body=span).get_json()
        fragment_s = time.perf_counter() - t0
        top = frag["matches"][0]
        check(top["filename"] == "omega.y4m" and top["offset_frames"] == 50
              and top["match_count"] == 300, f"/search/fragment: {frag}")
        batch = client.post("/search/fragments", json_body={"queries": [
            span, {"filename": "omega-copy.y4m", "start_frame": 200,
                   "num_frames": 120}]}).get_json()["results"]
        check(batch[0]["matches"] == frag["matches"]
              and batch[1]["matches"][0]["filename"] == "omega.y4m"
              and batch[1]["matches"][0]["offset_frames"] == 200,
              f"/search/fragments: {batch}")
        with open(paths["omega.y4m"], "rb") as f:
            body = f.read()
        t0 = time.perf_counter()
        found = client.post("/search/video?filename=omega-copy.y4m&top_k=3",
                            data=body).get_json()
        video_s = time.perf_counter() - t0
        best = found["best_alignments"][0]
        check(best["filename"] == "omega.y4m" and best["offset_frames"] == 0
              and best["match_count"] == 400
              and found["fingerprint_matches"][0]["filename"] == "omega.y4m",
              f"/search/video: {found['best_alignments']}")
        metrics = client.get("/metrics").get_json()
    finally:
        app.stop()
    launches = read_launches(
        {fused.K1.name, align.K3.name, hamming.K4.name}, "service path")
    disp = metrics["block_dispatcher"]
    check(disp["passes"] > 0, f"service: the dispatcher ran no pass: {disp}")
    check(app.corpus._fp_dev.device.type == "cuda"
          and all(bu.dev.device.type == "cuda" for bu in app.corpus._al_buckets
                  if bu is not None and bu.dev is not None),
          "service corpus is not on the GPU")
    phase("service", card=smi, launches=launches, verdicts={
        "omega.y4m": omega["duplicates"], "psi.y4m": psi["duplicates"],
        "omega-copy.y4m": copy["duplicates"]}, sse_frames=len(frames),
        fragment_top=top, video_top=best, boot_s=boot_s,
        upload_to_verdict_s=walls, copy_upload_traced=traced,
        search_fragment_s=fragment_s,
        upload_k1_launches=upload_k1, dispatcher_passes=passes,
        search_video_s=video_s, dispatcher=disp,
        stage_timings=metrics["stage_timings"],
        sync_bytes=metrics["corpus_footprint"]["sync_bytes"])
    return launches


def drive_bench(smi: str) -> dict:
    """The port's ``bench`` entry point at reduced passes (``--sizes smoke``:
    the leg shapes of the full run, fewer repetitions), through its CLI;
    launch counts zeroed just before and read just after."""
    from tvidz_tpu_torch import backend, cli
    from tvidz_tpu_torch.ops import align, fused, hamming

    legs = "fingerprint,verdict,timestamp,fragment"
    backend.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--sizes", "smoke", "--legs", legs])
    launches = read_launches({fused.K1.name, hamming.K2.name, align.K3.name,
                              hamming.K4.name}, "bench")
    card, record = buf.getvalue().strip().splitlines()[-2:]
    rec = json.loads(record)
    check(rc == 0 and card == smi, f"bench: exit {rc}, card line {card!r}")
    keys = ("value", "verdict_1m_device_ms", "verdict_16m_device_ms",
            "verdict_compares_per_sec", "frame_evidence_1m_device_ms",
            "frame_evidence_16m_device_ms", "fragment_search_1m_p50_ms")
    check(all(rec[k] is not None and rec[k] > 0 for k in keys),
          f"bench: a key was not measured: {rec}")
    check(all(r["agree"] for r in rec["race"]), "bench: a race variant disagreed")
    phase("bench", card=card, launches=launches,
          **{k: rec[k] for k in keys + ("timestamp_match_p50_ms",
                                       "fingerprint_per_block_frames_per_sec")},
          race=[[r["variant"], r["n"], r["device_ms"], r["wall_p50_ms"]]
                for r in rec["race"]])
    return launches


def time_analyze(work: str, url: str) -> dict:
    """End-to-end frames/s of one 1024-frame analyze (decode included) on a
    fresh session, with the analyzer's stage times; then a second fresh
    upload analyzed under torch.profiler for the device's busy time and
    idle share (tracing off for the frames/s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tvidz_tpu_torch import cli
    from tvidz_tpu_torch.decode import write_synthetic_y4m

    n = 1024
    paths = []
    os.makedirs(os.path.join(work, "fresh"), exist_ok=True)
    for name, seed, cuts in (("epsilon", 5, (100, 500, 900)),
                             ("zeta", 6, (110, 520, 910))):
        paths.append(os.path.join(work, "fresh", f"{name}.y4m"))
        write_synthetic_y4m(paths[-1], num_frames=n, height=180, width=320,
                            cut_frames=cuts, seed=seed)
    analyzer, _store, _corpus = cli._local_session(url, "cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        res = analyzer.analyze(os.path.dirname(paths[0]),
                               os.path.basename(paths[0]))
        seconds = time.perf_counter() - t0
    check(res.status == "done" and res.duplicates == [], f"timed analyze: {res}")
    stages = analyzer.timer.summary()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            res = analyzer.analyze(os.path.dirname(paths[1]),
                                   os.path.basename(paths[1]))
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
    check(res.status == "done" and res.duplicates == [], f"traced analyze: {res}")
    return {"analyze_frames_per_s": n / seconds, "analyze_stages": stages,
            "traced_analyze_s": traced_s, **device_busy(prof, traced_s)}


def time_kernels(dev) -> dict:
    """K1-K4 at the main path's shapes (K1 also at the bench's 2^17-frame
    single-dispatch shape): per call by CUDA events, interleaved
    with the plain version where one is timed, and the kernels on the
    device from torch.profiler. The plain versions' device time is not
    taken: with thousands of small launches a call, their windows lose
    launches (on the H100 they read 0.4-0.6 of an unwarmed window's)."""
    import torch

    from tvidz_tpu_torch.ops import align, fused, hamming, phash

    left, right = phash.hash_operators(HEIGHT, WIDTH, dev)
    x = torch.randint(0, 256, (FRAMES, HEIGHT, WIDTH), dtype=torch.uint8,
                      device=dev)
    carry = fused.initial_fingerprint_carry(HEIGHT, WIDTH, dev)
    k1 = lambda: fused.fingerprint_block(x, carry, left, right)  # noqa: E731
    k1_plain = lambda: fused.fingerprint_block_plain(  # noqa: E731
        x, carry, left, right)
    k1_ms, k1_plain_ms = interleaved_ms(k1, k1_plain, 20)
    # The bench's single-dispatch shape: one launch over 512 x 256 frames.
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    xs = torch.randint(0, 256, (K1_VALUE_FRAMES, HEIGHT, WIDTH),
                       dtype=torch.uint8, device=dev, generator=gen)
    k1s = lambda: fused.fingerprint_block(xs, carry, left, right)  # noqa: E731
    k1s_plain = lambda: fused.fingerprint_block_plain(  # noqa: E731
        xs, carry, left, right)
    k1s_ms, k1s_plain_ms = interleaved_ms(k1s, k1s_plain, 3)
    k1_stream = {"frames": K1_VALUE_FRAMES, "ms": k1s_ms,
                 "plain_ms": k1s_plain_ms, "device_ms": device_ms(k1s, 5),
                 "frames_per_s": K1_VALUE_FRAMES / k1s_ms * 1e3,
                 "grid": fused.fingerprint_grid(K1_VALUE_FRAMES, HEIGHT, WIDTH)}
    del xs
    q, corpus = scan_inputs(dev, planted(dev)[0])
    k2 = lambda: hamming.corpus_min_distance(q, corpus, frame_min=False)  # noqa: E731
    k2_plain = lambda: hamming.corpus_min_distance_plain(  # noqa: E731
        q, corpus, False)
    k2_ms, k2_plain_ms = interleaved_ms(k2, k2_plain, 10)
    k2_fmin = lambda: hamming.corpus_frame_min_xor(q, corpus)  # noqa: E731
    # K4: each mode per call and on the device; the plain ±1 version
    # beside the two modes on the main path (interleaved with them).
    k4_times = {}
    for mode in hamming.MODES:
        k4 = lambda mode=mode: hamming.corpus_scan_tc(q, corpus, mode)  # noqa: E731
        k4_plain = lambda mode=mode: hamming.corpus_scan_pm1_plain(  # noqa: E731
            q, corpus, mode)
        t = {"device_ms": device_ms(k4, 20)}
        if mode in ("frame_min", "query_nearest"):
            t["ms"], t["plain_ms"] = interleaved_ms(k4, k4_plain, 5)
        else:
            k4()
            t["ms"] = cuda_ms(k4, 20)
        k4_times[mode] = t
    k3_times = {}
    for name, shape in (("a", FRAG_A), ("b", FRAG_B)):
        (qs, ql, c, ln), _ = fragment_inputs(dev, shape, SEED + 3)
        k3 = lambda: align.fragment_search_batch(qs, ql, c, ln, FRAG_THR)  # noqa: E731
        k3_plain = lambda: align.fragment_search_batch_plain(  # noqa: E731
            qs, ql, c, ln, FRAG_THR)
        ms, plain_ms = interleaved_ms(k3, k3_plain, 3)
        k3_times[name] = {"ms": ms, "plain_ms": plain_ms,
                          "device_ms": device_ms(k3, 10),
                          # the scan, and the key set-up and unpack
                          "device_ms_by_kernel": device_ms_by_kernel(k3, 10)}
        if name == "a":
            # Every (query row, corpus row) pair that can overlap.
            k3_pairs = int((ql.to(torch.int64).sum() * ln.to(torch.int64).sum()))
            k3_bytes = sum(t.numel() * t.element_size() for t in (qs, ql, c, ln)) \
                + 2 * 4 * shape[0] * shape[2]
            # The bucket of identical rows: every pair matches.
            dc, dq = dense_inputs(c, qs)
            k3_times["a_dense"] = {"device_ms": device_ms(
                lambda: align.fragment_search_batch(dq, ql, dc, ln, FRAG_THR), 10)}
    k1_items = device_ms_by_kernel(k1, 20)
    check(len(k1_items) == 1, f"K1: device items per call {sorted(k1_items)}, not one")
    return {"k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms,
            "k1_device_ms": sum(k1_items.values()),
            "k1_device_items": sorted(k1_items),
            "k1_grid": fused.fingerprint_grid(FRAMES, HEIGHT, WIDTH),
            "k1_stream": k1_stream,
            "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms,
            "k2_device_ms": device_ms(k2, 10),
            "k2_frame_min_device_ms": device_ms(k2_fmin, 20),
            "k2_shape": [SCAN_M, SCAN_N], "k3": k3_times, "k4": k4_times,
            "k4_shape": [SCAN_M, SCAN_N], "k3_pairs": k3_pairs,
            "k3_bytes": k3_bytes}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="OLD_ROOT",
                    help="race this tree against the checkout at OLD_ROOT")
    ap.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(args.measure or root))
    # The analyzer's per-step log lines would bury the phase lines.
    os.environ.setdefault("TVIDZ_LOG_LEVEL", "WARNING")
    if args.measure:                     # one arm of ``race_against``
        print(json.dumps(measure_arm(args.measure, args.dump)))
        return 0
    smi = nvidia_smi()
    if args.against:
        check(os.path.isdir(os.path.join(args.against, "tvidz_tpu_torch")),
              f"--against {args.against}: no tvidz_tpu_torch there")
        race_against(os.path.abspath(args.against), smi)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.ops import align, fused, hamming, phash

    dev = backend.resolve_device("cuda")
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], card=smi,
          device_count=torch.cuda.device_count())

    t0 = time.perf_counter()
    backend.build_all()
    ptxas = [f"{k.name}: {ln.strip()}" for k in backend.KERNELS
             for ln in k.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", seconds=time.perf_counter() - t0,
          kernels=[k.repo_source for k in backend.KERNELS], ptxas=ptxas)

    k1_err = check_fingerprint_block(dev)
    k2_err = check_corpus_scan(dev)
    k3_err = check_fragment_search(dev)

    k4_err = check_scan_modes(dev)
    times = time_kernels(dev)

    work = tempfile.mkdtemp(prefix="tvidz_chip_smoke_")
    os.environ["TVIDZ_TMP_DIR"] = os.path.join(work, "tmp")
    os.makedirs(os.environ["TVIDZ_TMP_DIR"])
    try:
        path_launches, url = drive_main_path(work)
        path_launches["service"] = drive_service(work, url, smi)
        path_launches["bench"] = drive_bench(smi)

        stream_bound = k1_bound(K1_VALUE_FRAMES)
        times["k1_stream"].update(
            bound_ms=stream_bound[0], bound_by=stream_bound[1],
            bound_frames_per_s=K1_VALUE_FRAMES / stream_bound[0] * 1e3)
        phase("timings", card=smi, **times, **time_analyze(work, url),
              profiler_set_aside=sorted(SET_ASIDE))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    check(not any(m == "tvidz_tpu" or m.startswith("tvidz_tpu.") for m in sys.modules),
          "the JAX package was imported")
    # A kernel's launches: the sum over the paths driven above, each read
    # with the counts set to 0 just before it.
    launches = {k.name: sum(p[k.name] for p in path_launches.values())
                for k in backend.KERNELS}
    phase("path_launches", **path_launches)
    m, n = SCAN_M, SCAN_N
    bounds = {
        fused.K1.name: k1_bound(FRAMES),
        # K2 and K4 time the same function (query-nearest): corpus and
        # queries in, q_min and q_arg out; 64 int8 multiply-adds per pair.
        hamming.K2.name: bound(8 * n + 16 * m, 2 * 64 * m * n, INT8_TC_OPS_PER_S),
        hamming.K4.name: bound(8 * n + 16 * m, 2 * 64 * m * n, INT8_TC_OPS_PER_S),
        # K3 at shape (a): 64 int8 multiply-adds per overlapping pair.
        align.K3.name: bound(times["k3_bytes"], 2 * 64 * times["k3_pairs"],
                             INT8_TC_OPS_PER_S),
    }
    k3_a, k4_qn = times["k3"]["a"], times["k4"]["query_nearest"]
    timed = {fused.K1.name: (k1_err, times["k1_ms"], times["k1_plain_ms"]),
             hamming.K2.name: (k2_err, times["k2_ms"], times["k2_plain_ms"]),
             align.K3.name: (k3_err, k3_a["ms"], k3_a["plain_ms"]),
             hamming.K4.name: (k4_err, k4_qn["ms"], k4_qn["plain_ms"])}
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.repo_source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": timed[k.name][0], "ms": timed[k.name][1],
         "plain_ms": timed[k.name][2], "bound_ms": bounds[k.name][0],
         "bound_by": bounds[k.name][1],
         # No single PyTorch call computes these functions (a min/argmin
         # over Hamming distances; a DCT hash with scene scores; a banded
         # alignment count): torch._int_mm gives only the dots.
         "library_ms": None}
        for k in (fused.K1, hamming.K2, align.K3, hamming.K4)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
