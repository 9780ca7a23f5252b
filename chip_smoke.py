#!/usr/bin/env python3
"""Quickest proof that tvidz_tpu_torch runs on the GPU: build its kernels,
check each against its plain PyTorch version (K1 on chained blocks, on the
dispatcher's batch of streams and on a whole stream, each one launch, at the
production 90x160 and at every scene geometry its second form takes; K3,
K4's five modes and K2's frame_min-only switch exactly, ties across K4's
CTA ranges included, at 64-bit and other word widths and past one launch's
16,384 queries), drive
``ingest`` / ``analyze`` / ``search`` through the port's CLI, the two
corpus scans (``search_fingerprints``, ``nearest_video_counts``, the latter
with a 40,000-frame query), the inspector service (uploads over the fake S3
-> SQS path, SSE, fragment and video search, a 16,500-frame video among
them) and a short ``bench`` against a 2^20-fingerprint corpus, then the
same CLI and searches under ``TVIDZ_HASH_ALGO=phash256`` (8-word
fingerprints through K3 and K4), then:

- ``wide_words``: K2, K3 and K4 at W = 26, 32, 42 and 128 (their
  word-chunked walks) against their plain versions, ties at K4's range
  edges, and the CLI and searches under ``TVIDZ_HASH_SIZE=32``;
- ``ship_coeffs``: ``TVIDZ_SHIP_DCT_COEFFS=1`` — K1's median-pack entry on
  planted median ties, the CLI analyze against the luma mode, the service's
  renamed-copy verdict through the shared dispatcher;
- ``forward_batch``: 8 clips of 128 frames in one K1 launch against the
  plain version;
- ``multistream``: ``fingerprint_streams`` over 8 uploads of different
  lengths and one whose decoder raises, at max_active 2 and 8, each stream
  equal to its lone analyze, K1 launches equal to the passes;
- ``bench_legs``: the bench's ingest legs at ``--sizes smoke``, and on a
  line of its own (``decoders``) what the machine offers to write and
  decode their MJPEG and H.264 fixtures;
- ``mesh``: the corpus sharded over ``make_mesh(devices=[cuda:0] * 8)``
  (data 2, corpus 4; with two or more cards, over them too) — MeshCorpus
  against DeviceCorpus on the smoke store, the mesh scans against
  single-card K4 at 2^24 rows, ``multichip_analysis_step`` against the
  per-clip single-card path, the analyzer's and the service's verdicts;
- ``multihost``: the corpus sharded across two ``torch.distributed`` rank
  processes on cuda:0 (gloo) — the port's dryrun at 2^24 fingerprint rows
  against a single-card DeviceCorpus, and two served ranks on one shared
  store warmed with 2^20 fingerprints (``--quick``), each rank reporting
  its kernel launches;
- ``wire_stack``: the service as its own process over the real wire — the
  integration driver with presigned uploads to the port's MiniAWS and
  every store operation over the PostgreSQL wire protocol to the port's
  MiniPG (a 2^20-fingerprint store restored at boot, a MiniPG restart
  while an upload is analyzed), the same driver with ``--mesh``, the
  served multi-host driver with MiniPG as the shared store, the soak
  (40 uploads, 4 in flight), the soak with ``--mesh`` (20 uploads over
  ``[cuda:0] * 8``) and the multi-host soak (12 uploads alternating two
  ranks on cuda:0, the op log bounded under ingest), and K1's hashes of
  the soaks' uploads against ``golden.phash``;
- ``scene_180x320``: the CLI's ingest and analyze under
  ``TVIDZ_SCENE_HEIGHT=180 TVIDZ_SCENE_WIDTH=320``, every block through
  K1's second form (one launch a block), the renamed copy naming its
  original, and the analyze frames/s and device busy share there;

and time it (K1's second form also on 16,384-frame 180x320 and 2,048-frame
720x1280 streams, each row's hashes counted against the plain version and
golden). Launch counts are zeroed before and read after each of those
paths.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OLD_ROOT

``--against`` runs only the race of this tree against another checkout of
the repo (``git archive <commit> | tar -x -C OLD_ROOT``; in a directory
``.gitignore`` lists): four fresh processes, old, new, new, old, each
timing K1, K3 and K4 at the race shapes (torch.profiler device time and
CUDA events; K1 also at K1_TIMED_GEOMETRIES) and one analyze of a
1024-frame upload; K3's and K4's outputs held equal across the trees, K1's
within its tolerances.

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

from perfbench import peaks

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
# K1's second form: the reference's edge geometries (tests/test_edge_parity.py)
# and what TVIDZ_SCENE_HEIGHT / TVIDZ_SCENE_WIDTH reach; 90x160 and 8x8 take
# the first form.
ODD_GEOMETRIES = ((91, 163), (33, 47), (720, 1280), (8, 8), (180, 320),
                  (90, 162), (90, 160))
# K1's second form timed (label, frames, H, W): a lone block at T=128, and a
# whole stream long enough that the bytes and the FMA issue, not the launch,
# set the time (0.94 GB and 1.9 GB of luma).
K1_TIMED_GEOMETRIES = (("t128_180x320", 128, 180, 320),
                       ("t128_720x1280", 128, 720, 1280),
                       ("s16384_180x320", 16_384, 180, 320),
                       ("s2048_720x1280", 2048, 720, 1280))
# Frames of a timed row held against golden.phash (host numpy, ~5-10 ms a
# frame): all of a block, the first 1024 of a stream.
K1_GOLDEN_FRAMES = 1024
# The main path at another scene geometry (TVIDZ_SCENE_HEIGHT/WIDTH): every
# block through K1's second form.
SCENE_GEOMETRY = (180, 320)
WIDE_WORDS = (1, 3, 8)                      # K2 and K4 at other word widths
# Past one pass of the kernels' shared memory (the word-chunked walks):
# W = 32 (TVIDZ_HASH_SIZE=32) and 128 (TVIDZ_DCT_SIZE=64 TVIDZ_HASH_SIZE=64),
# and 26 and 42, whose last chunk of words is short.
WIDER_WORDS = (26, 32, 42, 128)
# K3 at those widths: (Q, Tq_pad, V, Tc), six offset bands a (query, video).
K3_WIDER_SHAPE = (2, 256, 96, 512)
K3_WIDER_THRS = (0, 10, 40)
PHASH256_WORDS = 8
BIG_M = (16_385, 40_000)                    # queries past one launch
LONG_VIDEO_FRAMES = 16_500                  # a /search/video past one launch
K3_WIDE_THRS = (0, 40, 100)
# K3 at W = 8 with four queries against enough videos that the tiles plan
# gives one CTA all four (q_group 4), as the fragment-search cell runs it.
K3_W8_GROUP = (4, 768, 256, 1024)
# K3 at the fragment-search cell's per-request shape: four spans across the
# cell's log-uniform 256 .. 1,024 frames (mean 603; the cell's, ~550).
K3_REQUEST_SPANS = (256, 431, 702, 1024)
# Videos of each bucket of that request held against the plain version
# (all 64 sources; the catalog's first 64, which hold its planted spans).
K3_REQUEST_PLAIN_VIDEOS = 64
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
        f"{sorted((k[:50], c) for k, (_, c) in t.items())}; the windows kept: "
        f"{[sorted((k[:50], n) for k, (_, n) in w.items()) for w in seen]}")


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


# The least time the card could take (``perfbench/peaks.py``), in ms,
# labelled by what sets it: its operations or its bytes.
def labelled(seconds: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by) of a bound of ``seconds`` whose work is ``ops``."""
    return seconds * 1e3, "operations" if seconds == ops / ops_per_s else "bytes"


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by) for moving ``nbytes`` once and doing ``ops``."""
    return labelled(peaks.bound_s(nbytes, ops, ops_per_s), ops, ops_per_s)


def k1_bound(frames: int, h: int = HEIGHT, w: int = WIDTH):
    """K1 over one stream's ``frames`` frames of (h, w); per frame the
    factored DCT and the mafd in fp32."""
    return labelled(peaks.k1_bound_s([frames], h, w),
                    frames * (2 * 8 * h * w + 2 * 64 * h + 3 * h * w),
                    peaks.FP32_OPS_PER_S)


def scan_bound(m: int, n: int, words: int):
    """A corpus scan (query-nearest) of m queries against n rows of
    ``words`` words: one 32 W-term dot per pair."""
    return labelled(peaks.scan_bound_s(m, n, words),
                    peaks.align_ops([m], [n], words), peaks.INT8_TC_OPS_PER_S)


# -- phase 3: K1 -----------------------------------------------------------------


def golden_bits_histogram(luma, words) -> dict:
    """How many frames' K1 hashes ``words`` (T, 2) differ from
    ``golden.phash`` of ``luma`` (T, H, W) uint8 by 0, 1, 2 and more bits
    (the reference's own golden bar is 2 bits a frame)."""
    import numpy as np

    from tvidz_tpu_torch.ops import golden

    want = np.stack([golden.phash(f) for f in luma])
    bits = popcount_rows(np.ascontiguousarray(words).view(np.uint32) ^ want)
    return {"0": int((bits == 0).sum()), "1": int((bits == 1).sum()),
            "2": int((bits == 2).sum()), ">2": int((bits > 2).sum()),
            "max": int(bits.max())}


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
    vs_golden = {}
    for tag, luma in (("random", random_luma), ("synthetic", synth_luma)):
        k1_words = []
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
            k1_words.append(phash.words_to_numpy(fk[:t]))
            bits = popcount_rows(phash.words_to_numpy(fk[:t])
                                 ^ phash.words_to_numpy(fp[:t]))
            max_bits = max(max_bits, int(bits.max()))
            differing += int((bits > 0).sum())
            frames += t
            check(torch.equal(ck.scene.prev_frame, cp.scene.prev_frame)
                  and bool(ck.scene.has_prev) and bool(cp.scene.has_prev),
                  "K1 carry frame differs from the plain version")
            ulps = max(ulps, mafd_ulps(ck.scene.prev_mafd, cp.scene.prev_mafd))
        vs_golden[tag] = golden_bits_histogram(luma, np.concatenate(k1_words))
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
          k1_vs_golden_bits=vs_golden, batch=batch, stream=stream)
    return max_err


def check_k1_geometries(dev) -> dict:
    """K1 at every scene geometry of ODD_GEOMETRIES (the second form at all
    but 90x160 and 8x8): chained blocks of random frames against the plain
    version (scores, carry frame, carried mafd in ulps, hash bits), the
    whole stream one launch bit-equal to the chained launches, the first
    frames within HASH_BITS_TOL of golden.phash; and a K=4 batch of
    misaligned blocks at 91x163, one launch, bit-equal to lone launches."""
    import numpy as np
    import torch

    from tvidz_tpu_torch.ops import fused, golden, phash

    rows, err, bits_max, ulps_max = [], 0.0, 0, 0.0
    for h, w in ODD_GEOMETRIES:
        rng = np.random.default_rng(SEED + h + w)
        t = FRAMES if h * w < 500_000 else 32
        luma = rng.integers(0, 256, size=(2 * t + 7, h, w), dtype=np.uint8)
        x = torch.from_numpy(luma).to(dev)
        left, right = phash.hash_operators(h, w, dev)
        ck = fused.initial_fingerprint_carry(h, w, dev)
        cp = fused.initial_fingerprint_carry(h, w, dev)
        chained, e, b, u, differing = [], 0.0, 0, 0.0, 0
        for s0 in range(0, x.shape[0], t):
            sk, fk, ck = fused.fingerprint_block(x[s0:s0 + t], ck, left, right)
            sp, fp, cp = fused.fingerprint_block_plain(x[s0:s0 + t], cp, left, right)
            torch.cuda.synchronize()
            chained.append((sk, fk))
            e = max(e, (sk - sp).abs().max().item())
            hb = hash_bits(fk, fp)
            b, differing = max(b, int(hb.max())), differing + int((hb > 0).sum())
            check(torch.equal(ck.scene.prev_frame, cp.scene.prev_frame),
                  f"K1 {h}x{w}: carry frame differs from the plain version")
            u = max(u, mafd_ulps(ck.scene.prev_mafd, cp.scene.prev_mafd))
        ss, fs = one_launch(lambda: fused.fingerprint_stream(x), f"K1 stream {h}x{w}")
        torch.cuda.synchronize()
        check(torch.equal(ss, torch.cat([c[0] for c in chained]))
              and torch.equal(fs, torch.cat([c[1] for c in chained])),
              f"K1 {h}x{w}: the stream differs from its chained launches")
        gold = np.stack([golden.phash(f) for f in luma[:4]])
        gold_bits = int(popcount_rows(phash.words_to_numpy(fs[:4]) ^ gold).max())
        check(e <= SCORE_TOL and b <= HASH_BITS_TOL and u <= MAFD_ULPS_TOL
              and gold_bits <= HASH_BITS_TOL,
              f"K1 {h}x{w}: scores {e}, hash bits {b}, carried mafd {u} ulps, "
              f"golden bits {gold_bits}")
        rows.append({"hw": [h, w], "form": fused.k1_form(h, w), "block_frames": t,
                     "grid": fused.fingerprint_grid(t, h, w), "frames": int(x.shape[0]),
                     "score_max_abs_err": e, "hash_max_bit_diff": b,
                     "frames_not_bit_identical": differing,
                     "carry_mafd_max_ulps": u, "golden_max_bit_diff": gold_bits,
                     "stream_bit_equal_to_chained": True})
        err, bits_max, ulps_max = max(err, e), max(bits_max, b), max(ulps_max, u)
        del x
    # The dispatcher's pass at an odd geometry, blocks at odd addresses.
    h, w, t = 91, 163, 64
    rng = np.random.default_rng(SEED + 11)
    left, right = phash.hash_operators(h, w, dev)
    flat = torch.from_numpy(rng.integers(0, 256, size=(4 * t * h * w + 3,),
                                         dtype=np.uint8)).to(dev)
    blocks = [flat[3 + k * t * h * w:3 + (k + 1) * t * h * w].view(t, h, w)
              for k in range(4)]
    carries = [fused.initial_fingerprint_carry(h, w, dev) for _ in range(4)]
    carries[2] = fused.fingerprint_block(blocks[0], carries[0], left, right)[2]
    valid = [t, 1, 33, t]
    sb, fb, cb = one_launch(lambda: fused.fingerprint_blocks_batched(
        blocks, carries, valid, left, right), "K1 batch at 91x163")
    for j in range(4):
        s1, f1, c1 = fused.fingerprint_block(blocks[j], carries[j], left, right,
                                             valid_t=valid[j])
        torch.cuda.synchronize()
        check(torch.equal(sb[j], s1) and torch.equal(fb[j], f1)
              and all(torch.equal(a, b) for a, b in zip(cb[j].scene, c1.scene)),
              f"K1 batch at 91x163: stream {j} differs from a lone launch")
    phase("k1_any_geometry", geometries=rows, score_tol=SCORE_TOL,
          hash_bits_tol=HASH_BITS_TOL, carry_mafd_ulps_tol=MAFD_ULPS_TOL,
          batch_91x163={"streams": 4, "valid_t": valid, "misaligned": True,
                        "bit_equal_to_lone_launches": True})
    return {"score_max_abs_err": err, "hash_max_bit_diff": bits_max,
            "carry_mafd_max_ulps": ulps_max}


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


def planted(dev, words: int = 2) -> tuple:
    """(query -> rows holding an exact copy, the lower one the argmin;
    {mode: K4's grid for SCAN_N rows of ``words`` words}): TILE_TIES,
    THREAD_TIE and ties across the range edges of CTAs 1 and grid / 2 of
    each argmin mode's grid."""
    from tvidz_tpu_torch.ops import hamming

    tiles = SCAN_N // 256
    grids = {mode: hamming.corpus_scan_tc_grid(mode, SCAN_N, dev, words)
             for mode in hamming.MODES}
    check(all(1 < g <= tiles for g in grids.values()),
          f"K4 grids {grids} for {tiles} tiles: no range edge to plant at")
    edges = sorted({256 * (tiles * c // g) for g in (grids[m] for m in ARGMIN_MODES)
                    for c in (1, g // 2)})
    return {**TILE_TIES, **THREAD_TIE,
            **{21 + i: (e, e - 1) for i, e in enumerate(edges)}}, grids


def scan_inputs(dev, ties, words: int = 2):
    """(q, corpus) at (SCAN_M, SCAN_N) of ``words``-word rows, seeded, with
    sentinel rows, exact and near ties, and a copy of q[k] at each row of
    ``ties[k]``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 1)
    corpus = rng.integers(0, 2 ** 32, size=(SCAN_N, words), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, size=(SCAN_M, words), dtype=np.uint32)
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


def check_planted(name, ties, q_min, q_arg, n=SCAN_N, words=2):
    """The planted answers of ``scan_inputs(dev, ties, words)`` (M >
    max(ties))."""
    check(int(q_min[3]) == 0 and int(q_arg[3]) == 1000, f"{name} missed the planted tie")
    check(int(q_min[5]) == words and int(q_arg[5]) == 70_000,
          f"{name} missed a dist-{words} tie")
    check(int(q_arg[9]) == 2048 * 7 + 1023, f"{name} tie across a CTA edge")
    for k, rows in ties.items():
        check(int(q_min[k]) == 0 and int(q_arg[k]) == min(rows),
              f"{name} tie of q[{k}] across tiles: {int(q_arg[k])} != {min(rows)}")
    check(int(q_min[17]) == 2 * words and int(q_arg[17]) == min(GATE_TIE),
          f"{name} dist-{2 * words} tie behind the gate: {int(q_min[17])}, "
          f"{int(q_arg[17])}")
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
    extra = rng.integers(0, 2 ** 32, size=(m - q.shape[0], q.shape[1]),
                         dtype=np.uint32)
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


def scans_against_plain(name, q, corpus, ties=None, words=2) -> float:
    """K4's five modes and K2's two entry points on (q, corpus) held
    exactly to the plain XOR scan, and the planted answers of
    ``scan_inputs`` when ``ties`` is given; returns the largest error."""
    import torch

    from tvidz_tpu_torch.ops import hamming

    want = hamming.corpus_min_distance_plain(q, corpus)
    got = {f"k4_{mode}": hamming.corpus_scan_tc(q, corpus, mode)
           for mode in hamming.MODES}
    got["k2"] = hamming.corpus_min_distance(q, corpus)
    got["k2_frame_min"] = (hamming.corpus_frame_min_xor(q, corpus), None, None)
    torch.cuda.synchronize()
    err = 0
    for variant, outs in got.items():
        for o, w in zip(outs, want):
            if o is not None:
                err = max(err, (o - w).abs().max().item())
                check(torch.equal(o, w),
                      f"{variant} differs from the plain version at {name}")
        if ties is not None and outs[2] is not None:
            check_planted(f"{variant} ({name})", ties, outs[1], outs[2],
                          words=words)
    return err


def check_wide_scans(dev) -> float:
    """K4's five modes and K2's two entry points at WIDE_WORDS word widths
    (M=128, N=2^20, the planted ties of ``scan_inputs`` at the range edges
    of the grid K4 reports for each W; and M=37, N=3000 at W=5), and at W=2
    and W=8 past one launch's 16,384 queries (BIG_M, N=8192): every output
    equal to the plain XOR scan."""
    from tvidz_tpu_torch.ops import hamming

    err, checked = 0, []

    def against_plain(name, q, corpus, ties=None, words=2):
        nonlocal err
        err = max(err, scans_against_plain(name, q, corpus, ties, words))

    for words in WIDE_WORDS:
        ties, grids = planted(dev, words)
        q, corpus = scan_inputs(dev, ties, words)
        against_plain(f"w{words}", q, corpus, ties, words)
        checked.append({"words": words, "m": SCAN_M, "n": SCAN_N,
                        "grids": grids})
        del corpus
    ties, _ = planted(dev, 5)
    q, corpus = scan_inputs(dev, ties, 5)
    against_plain("w5_small", q[:37], corpus[:3000])
    checked.append({"words": 5, "m": 37, "n": 3000})
    for words in (2, PHASH256_WORDS):
        q, corpus = scan_inputs(dev, {}, words)
        for m in BIG_M:
            before = (hamming.K4.launches, hamming.K2.launches)
            against_plain(f"w{words}_m{m}", more_queries(q, m), corpus[:8192])
            chunks = -(-m // 16_384)
            check(hamming.K4.launches - before[0] == len(hamming.MODES) * chunks
                  and hamming.K2.launches - before[1] == 2 * chunks,
                  f"M={m}: {hamming.K4.launches - before[0]} K4 launches, "
                  f"{hamming.K2.launches - before[1]} K2, not {chunks} per call")
            checked.append({"words": words, "m": m, "n": 8192,
                            "launches_per_call": chunks})
    phase("k4_k2_any_width", modes=list(hamming.MODES),
          also=["k2", "k2_frame_min"], max_abs_err=err, exact=True, cases=checked)
    return float(err)


def check_wider_words(dev) -> dict:
    """K2, K3 and K4 at WIDER_WORDS (the word-chunked walks) against their
    plain versions, exactly: K4's five modes and K2's two entry points at
    M=128, N=2^20 with the ties of ``scan_inputs`` planted at the edges of
    the ranges K4 reports for each W, and at M=37, N=3000; K3 at
    K3_WIDER_SHAPE at thresholds K3_WIDER_THRS with its planted fragments,
    and on a bucket of identical rows. K4's grid is asked for W = 128, 8,
    42 and 2 in turn first: no later W may lower an earlier one's
    shared-memory opt-in (each is launched after)."""
    import torch

    from tvidz_tpu_torch.ops import align, hamming

    order = {w: hamming.corpus_scan_tc_grid("query_nearest", SCAN_N, dev, w)
             for w in (128, 8, 42, 2)}
    err, scans, frags = 0, [], []
    for w in (128, 8, 42, 2):                # launched after every grid ask
        q, corpus = scan_inputs(dev, {}, w)
        got = hamming.corpus_query_nearest(q[:16], corpus[:4096])
        want = hamming.corpus_min_distance_plain(q[:16], corpus[:4096], False)[1:]
        torch.cuda.synchronize()
        check(all(torch.equal(g, x) for g, x in zip(got, want)),
              f"K4 at W={w} after the grid was asked for other widths")
        del corpus
    for words in WIDER_WORDS:
        ties, grids = planted(dev, words)
        q, corpus = scan_inputs(dev, ties, words)
        err = max(err, scans_against_plain(f"w{words}", q, corpus, ties, words),
                  scans_against_plain(f"w{words}_small", q[:37], corpus[:3000]))
        scans.append({"words": words, "m": SCAN_M, "n": SCAN_N, "grids": grids,
                      "range_edge_ties": {k: v for k, v in ties.items() if k > 20}})
        del corpus
        (qs, q_lens, corpus, lens), plants = fragment_inputs(
            dev, K3_WIDER_SHAPE, SEED + 9, words)
        dense_c, dense_q = dense_inputs(corpus, qs)
        for name, q_, c_, thr in ([(f"thr{t}", qs, corpus, t) for t in K3_WIDER_THRS]
                                  + [("dense", dense_q, dense_c, FRAG_THR)]):
            got = align.fragment_search_batch(q_, q_lens, c_, lens, thr)
            want = align.fragment_search_batch_plain(q_, q_lens, c_, lens, thr)
            torch.cuda.synchronize()
            err = max(err, *((g - x).abs().max().item() for g, x in zip(got, want)))
            check(all(torch.equal(g, x) for g, x in zip(got, want)),
                  f"K3 at W={words} differs from the plain version at {name}")
            if name == "thr10":
                for qi, (row, off, n) in enumerate(plants):
                    check(int(got[1][qi, row]) == n and int(got[0][qi, row]) == off,
                          f"K3 at W={words} missed the planted fragment of query {qi}")
            if name == "dense":
                check(int(got[1][0, 0]) == int(q_lens[0]),
                      f"K3 at W={words}, dense bucket: {got[1][0, :4].tolist()}")
        frags.append({"words": words, "shape": list(K3_WIDER_SHAPE),
                      "thresholds": list(K3_WIDER_THRS) + ["dense"]})
    # A corpus the card could hold at W = 128 with more rows a CTA range
    # than K4's key holds (2^27 rows, 64 GB): the grid grows past the
    # resident CTAs (only asked, not launched).
    big = {mode: hamming.corpus_scan_tc_grid(mode, 1 << 27, dev, 128)
           for mode in hamming.MODES}
    low = (1 << (32 - (32 * 128).bit_length())) - 1
    tiles = (1 << 27) // 256
    check(all(-(-tiles // g) * 256 < low for g in big.values()),
          f"K4 grid at W=128, N=2^27 leaves a range past the key: {big}")
    return {"max_abs_err": float(err), "scans": scans, "fragments": frags,
            "grid_order": order, "grid_2_27_w128": big}


# -- phase 5: K3 -----------------------------------------------------------------


def fragment_inputs(dev, shape, seed, words: int = 2):
    """Seeded (queries, q_lens, corpus, lens) at ``shape`` = (Q, Tq_pad, V,
    Tc) of ``words``-word rows as device int32 views, with, per query q: a
    fragment of video 7 + (31 q mod (V - 7)) taken at offset 100 + q with
    3-bit damage on every 4th frame; video 5 cut short; video 6 empty.
    Video 7 repeats a 50-frame period, so a query taken from it scores its
    maximum at every offset congruent to its start modulo 50 (ties across
    tiles), and the answer is the first of them. Returns the expected
    (video, offset, q_len) per query too."""
    import numpy as np
    import torch

    qn, tq_pad, v, tc = shape
    rng = np.random.default_rng(seed)
    corpus = rng.integers(0, 2 ** 32, size=(v, tc, words), dtype=np.uint32)
    lens = np.full(v, tc, np.int32)
    lens[5], lens[6] = tc // 3, 0
    corpus[7] = np.resize(corpus[7, :50], (tc, words))
    qs = rng.integers(0, 2 ** 32, size=(qn, tq_pad, words), dtype=np.uint32)
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


def check_k3_wide(dev) -> float:
    """K3 at W = 8 (phash256) at shape (a) and at K3_W8_GROUP (one CTA for
    all four queries of a video, the plan asserted): the planted fragments
    and thresholds K3_WIDE_THRS, and a bucket of identical rows, each equal
    to the plain version."""
    import torch

    from tvidz_tpu_torch.ops import align

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = align.k3_tiles_plan(*K3_W8_GROUP, PHASH256_WORDS, n_sm)
    check(plan[2] == K3_W8_GROUP[0],
          f"K3 at W=8: the plan {plan} at {K3_W8_GROUP} does not group the queries")
    err, checked = 0, []
    for label, shape in (("a", FRAG_A), ("group", K3_W8_GROUP)):
        (qs, q_lens, corpus, lens), plants = fragment_inputs(
            dev, shape, SEED + 3, PHASH256_WORDS)
        dense_c, dense_q = dense_inputs(corpus, qs)
        for name, q_, c_, thr in ([(f"thr{t}", qs, corpus, t) for t in K3_WIDE_THRS]
                                  + [("dense", dense_q, dense_c, FRAG_THR)]):
            got = align.fragment_search_batch(q_, q_lens, c_, lens, thr)
            want = align.fragment_search_batch_plain(q_, q_lens, c_, lens, thr)
            torch.cuda.synchronize()
            err = max(err, *((g - w).abs().max().item() for g, w in zip(got, want)))
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"K3 at W=8 differs from the plain version at ({label}) {name}")
            if name == "thr40":
                for q, (row, off, n) in enumerate(plants):
                    check(int(got[1][q, row]) == n and int(got[0][q, row]) == off,
                          f"K3 at W=8 missed the planted fragment of query {q} "
                          f"at ({label})")
            checked.append({"shape": label, "case": name, "threshold": thr,
                            "max_score": int(got[1].max())})
    phase("k3_w8", words=PHASH256_WORDS, shapes=[list(FRAG_A), list(K3_W8_GROUP)],
          group_plan=list(plan), max_abs_err=err, exact=True, cases=checked)
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
# K1 (label, frames, H, W) at the main path's block and at the bench's
# single-dispatch pass, then K1's second form at K1_TIMED_GEOMETRIES, each
# through ``fused.fingerprint_block`` (which both trees have; each takes any
# T and geometry), from a mid-stream carry.
RACE_K1 = (("t128", FRAMES, HEIGHT, WIDTH), ("t2^17", K1_VALUE_FRAMES, HEIGHT, WIDTH),
           *K1_TIMED_GEOMETRIES)
# K3 (label, shape, words) at the three parity shapes and on the bucket of
# identical rows, then at one W of each instance of the tiles form (N = 256,
# 256, 128, 64) at shape (a) and at K3_WIDER_SHAPE.
RACE_K3_WORDS = (3, 8, 12, 23)
RACE_K3 = (("a", FRAG_A, 2), ("b", FRAG_B, 2), ("c", FRAG_C, 2), ("a_dense", FRAG_A, 2),
           *((f"a_w{w}", FRAG_A, w) for w in RACE_K3_WORDS),
           *((f"small_w{w}", K3_WIDER_SHAPE, w) for w in RACE_K3_WORDS))


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
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    for label, frames, h, w in RACE_K1:
        left, right = phash.hash_operators(h, w, dev)
        x = torch.randint(0, 256, (frames, h, w), dtype=torch.uint8,
                          device=dev, generator=gen)
        # A carry from the block before: the call continues a stream.
        _, _, carry = fused.fingerprint_block(x[:FRAMES], fused.initial_fingerprint_carry(
            h, w, dev), left, right)
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
    for name, shape, words in RACE_K3:
        (qs, ql, c, ln), _ = fragment_inputs(dev, shape, SEED + 3, words)
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
    for label, *_ in RACE_K1:
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


def prefill_store(db_path: str, words: int = 2,
                  fp_videos: int = FILLER_FP_VIDEOS) -> int:
    """A realistic corpus, seeded: FILLER_VIDEOS videos with timestamps and
    ``fp_videos`` x FILLER_FP_FRAMES (2^20 by default) random fingerprints
    of ``words`` words, written in one transaction into the store's own
    schema."""
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
            "VALUES (?, ?, ?)",
            [(i + 1, words, rng.integers(0, 2 ** 32, size=(FILLER_FP_FRAMES, words),
                                         dtype=np.uint32).tobytes())
             for i in range(fp_videos)])
    con.close()
    return fp_videos * FILLER_FP_FRAMES


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
    # A 40,000-frame query (a 22-minute video at 30 fps): alpha's 300
    # fingerprints at its end, random ones before; past one launch.
    import numpy as np

    alpha_fps = store.get_fingerprints(alpha_id)
    long_query = np.concatenate([np.random.default_rng(SEED + 12).integers(
        0, 2 ** 32, size=(40_000 - alpha_fps.shape[0], 2), dtype=np.uint32),
        alpha_fps])
    for name, call, want in (
            ("search_fingerprints", lambda: dict(corpus.search_fingerprints(query)), 128),
            ("nearest_video_counts", lambda: corpus.nearest_video_counts(query), 128),
            ("nearest_video_counts_40000",
             lambda: corpus.nearest_video_counts(long_query), 300)):
        backend.reset_launch_counts()
        got = call()
        scans[name] = {"alpha": got.get(alpha_id),
                       "launches": read_launches({hamming.K4.name}, name)}
        check(got.get(alpha_id, 0) >= want if name == "search_fingerprints"
              else got.get(alpha_id) == want, f"{name} on the smoke corpus: {got}")
    check(scans["nearest_video_counts_40000"]["launches"][hamming.K4.name] == 3,
          f"40,000 queries: {scans['nearest_video_counts_40000']['launches']}")
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
        # A 16,500-frame video at the scene geometry (no rescale), past one
        # launch of the corpus scan: two chunks of queries.
        long_path = os.path.join(work, "svc", "long.y4m")
        _, long_cuts = write_synthetic_y4m(
            long_path, num_frames=LONG_VIDEO_FRAMES, height=cfg.pipeline.scene_height,
            width=cfg.pipeline.scene_width, cut_frames=(1000, 9000, 16_000),
            seed=13)
        with open(long_path, "rb") as f:
            body = f.read()
        os.remove(long_path)
        k4_before = hamming.K4.launches
        t0 = time.perf_counter()
        long_found = client.post("/search/video?filename=long.y4m&top_k=3",
                                 data=body).get_json()
        long_video_s = time.perf_counter() - t0
        del body
        check(long_found.get("frames") == LONG_VIDEO_FRAMES
              and long_found["scene_cuts"] == long_cuts
              and hamming.K4.launches - k4_before == 2,
              f"/search/video of {LONG_VIDEO_FRAMES} frames: "
              f"{ {k: v for k, v in long_found.items() if k != 'scene_cuts'} }, "
              f"{hamming.K4.launches - k4_before} K4 launches")
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
        long_video={"frames": LONG_VIDEO_FRAMES, "seconds": long_video_s,
                    "fingerprint_matches": long_found["fingerprint_matches"],
                    "k4_launches": 2},
        stage_timings=metrics["stage_timings"],
        sync_bytes=metrics["corpus_footprint"]["sync_bytes"])
    return launches


def drive_family(work: str, env: dict, words: int, tag: str,
                 fp_videos: int = FILLER_FP_VIDEOS):
    """The port under another fingerprint configuration (``env``: its
    TVIDZ_* settings, ``words``-word fingerprints): ``ingest`` / ``analyze``
    / ``search`` through the CLI against a sqlite corpus of ``fp_videos`` x
    FILLER_FP_FRAMES fingerprints of that width, then ``/search/fragment``
    and ``/search/video`` through the in-process service on that store. The
    renamed copy must name the original and a fresh video none; every
    verdict goes through K4 and every fragment search through K3 at that
    W, and no block through K1 (the family's plain-torch composition
    fingerprints). Launch counts zeroed before, read after. Returns
    (launches, the phase's fields)."""
    from tvidz_tpu_torch import backend, cli
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.corpus.store import Store
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel
    from tvidz_tpu_torch.ops import align, fused, hamming
    from tvidz_tpu_torch.service import fakes
    from tvidz_tpu_torch.service.app import create_app

    root = os.path.join(work, tag)

    def video(sub, name, seed, n, cuts):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, sub, name)
        return path, write_synthetic_y4m(path, num_frames=n, height=180, width=320,
                                         cut_frames=cuts, seed=seed)[1]

    # Early exit off, so that the renamed copy's whole sequence is stored
    # for the fragment search to take its span from.
    os.environ.update(TVIDZ_EARLY_EXIT="0", **env)
    app = None
    try:
        cfg = Config()
        model = FingerprintModel(cfg, device="cuda")
        check(cfg.hash.words == words and not model.k1,
              f"{tag}: {cfg.hash.words} words, K1 {model.k1}")
        sigma, _ = video("orig", "sigma.y4m", 21, 300, (60, 150, 240))
        video("orig", "tau.y4m", 22, 260, (50, 170))
        renamed = os.path.join(root, "copy", "renamed.y4m")
        os.makedirs(os.path.dirname(renamed))
        shutil.copy(sigma, renamed)
        upsilon, upsilon_cuts = video("fresh", "upsilon.y4m", 23, 280, (70, 200))
        db = os.path.join(root, "corpus.db")
        t0 = time.perf_counter()
        n_fp = prefill_store(db, words=words, fp_videos=fp_videos)
        prefill_s = time.perf_counter() - t0
        url = f"sqlite:///{db}"
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(cli, ["ingest", os.path.join(root, "orig"), "--db", url])
        check(rc == 0 and out[-1]["ingested"] == 2
              and out[-1]["corpus_fingerprints"] == n_fp + 560,
              f"{tag} ingest: {out}")
        rc, (res,) = run_cli(cli, ["analyze", renamed, "--db", url, "--compact"])
        check(rc == 0 and res["duplicates"] == ["sigma.y4m"],
              f"{tag} renamed copy verdict: {res}")
        rc, (fresh,) = run_cli(cli, ["analyze", upsilon, "--db", url, "--compact"])
        check(rc == 0 and fresh["duplicates"] == []
              and fresh["scene_cuts"] == upsilon_cuts, f"{tag} fresh video: {fresh}")
        rc, (found,) = run_cli(cli, ["search", renamed, "--db", url])
        top = found["best_alignments"][0]
        check(rc == 0 and top["filename"] == "sigma.y4m" and top["offset_frames"] == 0
              and top["match_count"] == 300
              and found["fingerprint_matches"][0]["filename"] == "sigma.y4m",
              f"{tag} search of the renamed copy: {found['best_alignments']}")
        cli_s = time.perf_counter() - t0

        app = create_app(config=cfg, store=Store(url),
                         s3=fakes.FakeS3(os.path.join(root, "s3")), sqs=None,
                         device="cuda")
        deadline = time.time() + 300
        while not app.device_ready and time.time() < deadline:
            time.sleep(0.05)
        check(app.device_ready and app.corpus.words == words,
              f"{tag} service did not get ready")
        client = app.wsgi.test_client()
        span = {"filename": "renamed.y4m", "start_frame": 50, "num_frames": 200}
        t0 = time.perf_counter()
        frag = client.post("/search/fragment", json_body=span).get_json()
        fragment_s = time.perf_counter() - t0
        check(frag["matches"][0]["filename"] == "sigma.y4m"
              and frag["matches"][0]["offset_frames"] == 50
              and frag["matches"][0]["match_count"] == 200,
              f"{tag} /search/fragment: {frag}")
        with open(sigma, "rb") as f:
            body = f.read()
        t0 = time.perf_counter()
        vid = client.post("/search/video?filename=renamed.y4m&top_k=3",
                          data=body).get_json()
        video_s = time.perf_counter() - t0
        best = vid["best_alignments"][0]
        check(best["filename"] == "sigma.y4m" and best["offset_frames"] == 0
              and best["match_count"] == 300
              and vid["fingerprint_matches"][0]["filename"] == "sigma.y4m",
              f"{tag} /search/video: {vid['best_alignments']}")
    finally:
        if app is not None:
            app.stop()
        for k in ("TVIDZ_EARLY_EXIT", *env):
            del os.environ[k]
    launches = read_launches({align.K3.name, hamming.K4.name}, f"{tag} path")
    check(launches[fused.K1.name] == 0,
          f"{tag}: {launches[fused.K1.name]} K1 launches (the family's "
          "composition launches none)")
    k3_forms = dict(align.K3.form_launches)
    check(k3_forms == {align.k3_form(words): launches[align.K3.name]},
          f"{tag}: K3 launches by form {k3_forms}, all {launches[align.K3.name]} "
          f"expected in the {align.k3_form(words)!r} form")
    return launches, dict(
        words=words, launches=launches, k3_forms=k3_forms,
        corpus_fingerprints=n_fp + 560,
        prefill_s=prefill_s, renamed_copy=res["duplicates"],
        fresh_duplicates=fresh["duplicates"], search_top_alignment=top,
        cli_s=cli_s, fragment_top=frag["matches"][0], search_fragment_s=fragment_s,
        video_top=best, search_video_s=video_s)


def drive_scene_geometry(work: str, smi: str) -> dict:
    """The main path at TVIDZ_SCENE_HEIGHT/WIDTH = SCENE_GEOMETRY, where
    every block goes through K1's second form: the CLI's ``ingest`` of two
    originals, ``analyze`` of a renamed copy (must name its original) and of
    a fresh video (must name none), on 180x320 Y4M uploads against a store
    prefilled as ``prefill_store`` does, early exit off; K1 launched once a
    block. Then ``time_analyze`` at that geometry (analyze frames/s, device
    busy share). Launch counts zeroed before the CLI calls, read after."""
    from tvidz_tpu_torch import backend, cli
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel
    from tvidz_tpu_torch.ops import fused, hamming

    h, w = SCENE_GEOMETRY
    root = os.path.join(work, f"scene_{h}x{w}")
    lengths = {}

    def video(sub, name, seed, n, cuts):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, sub, name)
        lengths[name] = n
        return path, write_synthetic_y4m(path, num_frames=n, height=h, width=w,
                                         cut_frames=cuts, seed=seed)[1]

    # Early exit off: the renamed copy's every block is fingerprinted too.
    env = {"TVIDZ_SCENE_HEIGHT": str(h), "TVIDZ_SCENE_WIDTH": str(w),
           "TVIDZ_EARLY_EXIT": "0"}
    os.environ.update(env)
    try:
        cfg = Config()
        model = FingerprintModel(cfg, device="cuda")
        form = fused.k1_form(cfg.pipeline.scene_height, cfg.pipeline.scene_width)
        check((cfg.pipeline.scene_height, cfg.pipeline.scene_width) == (h, w)
              and model.k1 and form == 1,
              f"scene {h}x{w}: config {cfg.pipeline.scene_height}x"
              f"{cfg.pipeline.scene_width}, K1 {model.k1}, form {form}")
        kappa, _ = video("orig", "kappa.y4m", 31, 300, (60, 150, 240))
        video("orig", "lambda.y4m", 32, 260, (50, 170))
        renamed = os.path.join(root, "copy", "renamed.y4m")
        os.makedirs(os.path.dirname(renamed))
        shutil.copy(kappa, renamed)
        lengths["renamed.y4m"] = lengths["kappa.y4m"]
        mu, mu_cuts = video("fresh", "mu.y4m", 33, 280, (70, 200))
        db = os.path.join(root, "corpus.db")
        n_fp = prefill_store(db)
        url = f"sqlite:///{db}"
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(cli, ["ingest", os.path.join(root, "orig"), "--db", url])
        check(rc == 0 and out[-1]["ingested"] == 2
              and out[-1]["corpus_fingerprints"] == n_fp + 560,
              f"scene {h}x{w} ingest: {out}")
        rc, (res,) = run_cli(cli, ["analyze", renamed, "--db", url, "--compact"])
        check(rc == 0 and res["duplicates"] == ["kappa.y4m"],
              f"scene {h}x{w} renamed copy verdict: {res}")
        rc, (fresh,) = run_cli(cli, ["analyze", mu, "--db", url, "--compact"])
        check(rc == 0 and fresh["duplicates"] == [] and fresh["scene_cuts"] == mu_cuts,
              f"scene {h}x{w} fresh video: {fresh}")
        cli_s = time.perf_counter() - t0
        launches = read_launches({fused.K1.name, hamming.K4.name}, f"scene {h}x{w} path")
        blocks = sum(-(-n // cfg.pipeline.block_frames) for n in lengths.values())
        check(launches[fused.K1.name] == blocks,
              f"scene {h}x{w}: {launches[fused.K1.name]} K1 launches for "
              f"{blocks} blocks")
        timed = time_analyze(root, url)
    finally:
        for k in env:
            del os.environ[k]
    phase(f"scene_{h}x{w}", card=smi, k1_form=form,
          band_rows=fused.k1_band_rows(h, w), grid_t128=fused.fingerprint_grid(
              cfg.pipeline.block_frames, h, w), launches=launches, blocks=blocks,
          renamed_copy=res["duplicates"], fresh_duplicates=fresh["duplicates"],
          fresh_cuts=fresh["scene_cuts"], cli_s=cli_s, **timed)
    return launches


def drive_phash256(work: str, smi: str) -> dict:
    """``drive_family`` under ``TVIDZ_HASH_ALGO=phash256`` (8-word
    fingerprints) against a 2^20-fingerprint corpus (32 MB on the card)."""
    composition = ("ops/fused.fingerprint_family_block: "
                   "ops/scene.scene_scores_block + ops/hashes.phash256_batched "
                   "(plain torch; K1 computes the 64-bit pHash only)")
    launches, fields = drive_family(work, {"TVIDZ_HASH_ALGO": "phash256"},
                                    PHASH256_WORDS, "phash256")
    phase("phash256_path", card=smi, composition=composition, **fields)
    return launches


def drive_wide_words(dev, work: str, smi: str) -> dict:
    """Phase ``wide_words``: K2, K3 and K4 at WIDER_WORDS against their
    plain versions (``check_wider_words``), then the CLI and the searches
    under ``TVIDZ_HASH_SIZE=32`` (32-word phash, K3 and K4 at W = 32)
    against a corpus of 2^16 such fingerprints: both name the original."""
    kernels = check_wider_words(dev)
    launches, fields = drive_family(work, {"TVIDZ_HASH_SIZE": "32"}, 32, "hash32",
                                    fp_videos=16)
    phase("wide_words", card=smi, kernels=kernels, hash_size_32=fields)
    return launches, kernels["max_abs_err"]


def _coeff_ties(dev, n: int = 4096):
    """(N, 64) float32 coefficients with planted median ties: integer-valued
    rows (many equal values), rows whose two middle order statistics tie,
    rows all equal, and rows with the median value itself present."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 20)
    low = rng.normal(0, 50, size=(n, 64)).astype(np.float32)
    low[: n // 4] = rng.integers(-4, 5, size=(n // 4, 64))
    low[n // 4: n // 4 + 64, :33] = 7.25
    low[n // 4 + 64: n // 4 + 80] = 3.0
    srt = np.sort(low[n // 2:], axis=1)
    low[n // 2:, 5] = (srt[:, 31] + srt[:, 32]) / 2
    return torch.from_numpy(low).to(dev)


def _service_uploads(work: str, tag: str, cfg, uploads, copy_of: str,
                     corpus=None):
    """The in-process service on a fresh store over the fake S3 -> SQS path,
    shared dispatcher on, on ``corpus`` (default: the app's own
    DeviceCorpus): ``uploads`` ({name: path}) posted at once, then
    ``copy_of``'s renamed copy; returns ({name: status}, K1 launches,
    dispatcher passes), the launch counts zeroed just before (and left
    as they were when it returns)."""
    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.corpus.store import Store
    from tvidz_tpu_torch.ops import fused
    from tvidz_tpu_torch.service import fakes
    from tvidz_tpu_torch.service.app import create_app

    root = os.path.join(work, tag)
    sqs, s3 = fakes.FakeSQS(), fakes.FakeS3(os.path.join(root, "s3"))
    sqs.create_queue(cfg.service.sqs_queue)
    s3.create_bucket(cfg.service.s3_bucket)
    s3.configure_notification(sqs, cfg.service.sqs_queue)
    app = create_app(config=cfg, store=Store(f"sqlite:///{root}/s.db"), s3=s3,
                     sqs=sqs, device="cuda", corpus=corpus)
    client = app.wsgi.test_client()

    def verdict(name, timeout=300):
        deadline = time.time() + timeout
        while time.time() < deadline:
            data = client.get(f"/status/{name}").get_json()
            if data.get("status") in ("done", "error"):
                return data
            time.sleep(0.02)
        raise SmokeFailure(f"{tag}: no verdict for {name} in {timeout} s")

    backend.reset_launch_counts()
    try:
        app.start_poller()
        for name, path in uploads.items():
            s3.put_file(cfg.service.s3_bucket, name, path)
        out = {name: verdict(name) for name in uploads}
        s3.put_file(cfg.service.s3_bucket, "renamed-copy.y4m", uploads[copy_of])
        out["renamed-copy.y4m"] = verdict("renamed-copy.y4m")
        k1, passes = fused.K1.launches, app.block_dispatcher.passes
    finally:
        app.stop()
    return out, k1, passes


def drive_ship_coeffs(dev, work: str, smi: str) -> dict:
    """Phase ``ship_coeffs`` (``TVIDZ_SHIP_DCT_COEFFS=1``): K1's median-pack
    entry against its plain version on (N, 64) coefficients with planted
    median ties (bit for bit); the CLI ``analyze`` of a Y4M upload in the
    coefficient mode against the luma mode (cuts equal; fingerprints within
    HASH_BITS_TOL bits a frame, the count of bit-equal frames reported:
    K1 projects in float32, the host in the golden float64); the service
    with the shared dispatcher naming the original of a renamed copy, one
    K1 (median-pack) launch per dispatcher pass."""
    import torch

    from tvidz_tpu_torch import backend, cli
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel
    from tvidz_tpu_torch.ops import fused, phash

    low = _coeff_ties(dev)
    got = fused.median_pack_cuda(low)
    want = phash.phash_from_coeffs_plain(low, 8)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"median pack differs from its plain version on {int((got != want).any(1).sum())} rows")
    root = os.path.join(work, "coeff")
    os.makedirs(root)
    clip = os.path.join(root, "kappa.y4m")
    _, planted = write_synthetic_y4m(clip, num_frames=300, height=180, width=320,
                                     cut_frames=(60, 150, 240), seed=31)
    results = {}
    for mode, env in (("luma", {}), ("coeff", {"TVIDZ_SHIP_DCT_COEFFS": "1"})):
        os.environ.update(env)
        try:
            rc, (res,) = run_cli(cli, ["analyze", clip, "--db",
                                       f"sqlite:///{root}/{mode}.db", "--compact"])
            model = FingerprintModel(Config(), device="cuda")
            check(model.ship_coeffs == (mode == "coeff"), f"{mode}: ship_coeffs")
            cuts, fps = model.analyze_path(clip)
        finally:
            for k in env:
                del os.environ[k]
        check(rc == 0 and res["status"] == "done" and res["scene_cuts"] == planted
              and cuts == planted, f"coefficient mode, {mode} analyze: {res}")
        results[mode] = (res, fps)
    bits = popcount_rows(results["luma"][1] ^ results["coeff"][1])
    check(int(bits.max()) <= HASH_BITS_TOL,
          f"coefficient fingerprints {int(bits.max())} bits from the luma path's")
    os.environ["TVIDZ_SHIP_DCT_COEFFS"] = "1"
    try:
        cfg = Config()
        check(cfg.pipeline.shared_dispatcher and cfg.pipeline.ship_dct_coeffs,
              "coefficient service config")
        ups = {}
        for name, seed, cut in (("lambda.y4m", 32, (70, 190)), ("mu.y4m", 33, (40, 220))):
            ups[name] = os.path.join(root, name)
            write_synthetic_y4m(ups[name], num_frames=260, height=180, width=320,
                                cut_frames=cut, seed=seed)
        verdicts, k1, passes = _service_uploads(work, "coeff_svc", cfg, ups,
                                                "lambda.y4m")
    finally:
        del os.environ["TVIDZ_SHIP_DCT_COEFFS"]
    check(all(v["status"] == "done" for v in verdicts.values())
          and verdicts["lambda.y4m"]["duplicates"] == []
          and verdicts["mu.y4m"]["duplicates"] == []
          and verdicts["renamed-copy.y4m"]["duplicates"] == ["lambda.y4m"],
          f"coefficient service verdicts: {verdicts}")
    check(k1 == passes > 0, f"coefficient service: {k1} K1 launches in {passes} passes")
    launches = {k.name: k.launches for k in backend.KERNELS}
    phase("ship_coeffs", card=smi, median_pack_rows=low.shape[0],
          median_pack_bit_equal=True, analyze_cuts=results["coeff"][0]["scene_cuts"],
          planted_cuts=planted, fingerprint_max_bit_diff=int(bits.max()),
          frames_bit_equal=int((bits == 0).sum()), frames=int(bits.shape[0]),
          service_verdicts={k: v["duplicates"] for k, v in verdicts.items()},
          service_k1_launches=k1, dispatcher_passes=passes, launches=launches)
    return launches


def drive_forward_batch(dev, smi: str) -> dict:
    """Phase ``forward_batch``: B = 8 clips of 128 90x160 frames through
    ``FingerprintModel.forward_batch`` (one K1 launch, 8 segments from the
    initial carry) against the plain version on the same clips (scores
    within SCORE_TOL, hashes within HASH_BITS_TOL bits), frame 0 of each
    clip scored 0."""
    import torch

    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel
    from tvidz_tpu_torch.ops import fused

    model = FingerprintModel(Config(), device="cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    clips = torch.randint(0, 256, (8, FRAMES, HEIGHT, WIDTH), dtype=torch.uint8,
                          device=dev, generator=gen)
    backend.reset_launch_counts()
    scores, fps = model.forward_batch(clips)
    torch.cuda.synchronize()
    launches = read_launches({fused.K1.name}, "forward_batch")
    check(launches[fused.K1.name] == 1,
          f"forward_batch: {launches[fused.K1.name]} K1 launches, not 1")
    init = fused.initial_fingerprint_carry(HEIGHT, WIDTH, dev)
    ps, pf, _ = fused.fingerprint_blocks_batched_plain(
        list(clips), [init] * 8, [FRAMES] * 8, model.left, model.right)
    err = (scores - ps).abs().max().item()
    bits = hash_bits(fps.reshape(-1, 2), pf.reshape(-1, 2))
    check(err <= SCORE_TOL and int(bits.max()) <= HASH_BITS_TOL
          and not scores[:, 0].any().item(),
          f"forward_batch vs plain: score err {err}, {int(bits.max())} bits")
    phase("forward_batch", card=smi, clips=[8, FRAMES, HEIGHT, WIDTH],
          launches=launches, score_max_abs_err=err,
          hash_max_bit_diff=int(bits.max()), frames_bit_equal=int((bits == 0).sum()))
    return launches


def drive_multistream(work: str, smi: str) -> dict:
    """Phase ``multistream``: ``fingerprint_streams`` over 8 Y4M uploads of
    different lengths and a ninth whose decoder raises, at max_active 2 and
    8: the bad stream fails alone, the call returns, every other stream's
    cuts and fingerprints equal a lone ``analyze_path`` of its file, and
    K1's launches equal the passes the stats report (each run's counts
    zeroed just before)."""
    import numpy as np

    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel
    from tvidz_tpu_torch.ops import fused
    from tvidz_tpu_torch.pipeline.multistream import fingerprint_streams

    root = os.path.join(work, "multistream")
    os.makedirs(root)
    paths = []
    for i, n in enumerate((300, 128, 513, 260, 77, 400, 1000, 129)):
        paths.append(os.path.join(root, f"s{i}.y4m"))
        write_synthetic_y4m(paths[-1], num_frames=n, height=180, width=320,
                            cut_frames=(n // 3, 2 * n // 3), seed=40 + i)
    bad = os.path.join(root, "bad.y4m")
    with open(bad, "wb") as f:
        f.write(b"not a y4m stream" * 64)
    model = FingerprintModel(Config(), device="cuda")
    lone = {p: model.analyze_path(p) for p in paths}
    runs = {}
    launches = None
    for max_active in (2, 8):
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        results, stats = fingerprint_streams(paths + [bad], model=model,
                                             max_active=max_active)
        wall = time.perf_counter() - t0
        k1 = fused.K1.launches
        launches = {k.name: k.launches for k in backend.KERNELS}
        check(results[-1].error is not None and results[-1].frames == 0,
              f"multistream: the bad stream did not fail: {results[-1]}")
        for r in results[:-1]:
            cuts, fps = lone[r.path]
            check(r.error is None and r.scene_cuts == cuts
                  and np.array_equal(r.fingerprints, fps),
                  f"multistream (max_active {max_active}): {r.path} differs from "
                  f"its lone analyze: {r.error}, {r.scene_cuts} vs {cuts}")
        check(k1 == stats.dispatches > 0,
              f"multistream: {k1} K1 launches in {stats.dispatches} passes")
        runs[max_active] = {"frames": stats.frames, "passes": stats.dispatches,
                            "k1_launches": k1, "wall_s": wall,
                            "frames_per_s": stats.frames_per_s,
                            "frames_per_pass": stats.frames / stats.dispatches,
                            "decode_starved_s": stats.decode_starved_s,
                            "dispatch_s": stats.dispatch_s,
                            "resolve_s": stats.resolve_s,
                            "bad_stream_error": results[-1].error}
    phase("multistream", card=smi, streams=len(paths) + 1, runs=runs,
          launches=launches)
    return launches


INGEST_LEGS = ("boot_restore,batched_clips,decode_roofline,e2e_modes,e2e_scaling,"
               "service,e2e_scaling_y4m,service_y4m")


def drive_bench_legs(smi: str) -> dict:
    """Phase ``bench_legs``: the bench's ingest legs through its CLI at
    ``--sizes smoke``; the record (every key of bench.py's, a null one with
    its reason) printed on the phase's line. Launch counts zeroed just
    before and read just after."""
    from tvidz_tpu_torch import backend, bench, cli
    from tvidz_tpu_torch.ops import fused

    backend.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--sizes", "smoke", "--legs", INGEST_LEGS])
    launches = read_launches({fused.K1.name}, "bench ingest legs")
    card, record = buf.getvalue().strip().splitlines()[-2:]
    rec = json.loads(record)
    check(rc == 0 and card == smi, f"bench legs: exit {rc}, card line {card!r}")
    missing = [k for k in bench.RECORD_KEYS if k not in rec]
    unexplained = [k for k in bench.RECORD_KEYS
                   if rec[k] is None and not rec["why_null"].get(k)]
    check(not missing and not unexplained,
          f"bench legs: keys missing {missing}, null without a reason {unexplained}")
    check(rec["boot_restore_1m_s"] > 0 and rec["batched_clips_k1_launches_per_call"] == 1
          and set(rec["e2e_streams_y4m_frames_per_sec"]) == {"1", "8"}
          and rec["service_e2e_y4m_blocks_per_pass"] >= 1.0,
          f"bench legs: {rec}")
    phase("bench_legs", card=card, launches=launches, record=rec)
    # What writes and decodes the MJPEG and H.264 fixtures on this machine.
    phase("decoders", card=card, **rec["host"]["decoders"])
    return launches


MESH_CELLS = 8                  # the repeated-device mesh: (data 2, corpus 4)
MESH_SCAN_N = 1 << 24           # the bench's 16m verdict shape: 128 MB at W=2
STEP_CLIPS, STEP_TILES = 4, 4   # the step: B clips x NT tiles of FRAMES frames
STEP_TS_ROWS, STEP_FP_ROWS = 8192, 1 << 20


def _mesh_shape(mesh) -> list:
    from tvidz_tpu_torch.parallel.mesh import CORPUS_AXIS, DATA_AXIS

    return [mesh.shape[DATA_AXIS], mesh.shape[CORPUS_AXIS]]


def _add_launches(total: dict, launches: dict) -> None:
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def _mesh_corpus_checks(mesh, url: str, tag: str, total: dict) -> dict:
    """MeshCorpus against the single-card DeviceCorpus, both loaded from the
    smoke store (2^20 fingerprints, 8192 videos' timestamps, the 256 x 4096
    alignment bucket), with exact copies planted on both sides of each
    shard edge inside the live rows: match_timestamps, search_fingerprints,
    nearest_video_counts (128 and 40,000 queries; the raw (q_min, q_arg)
    too) and locate_fragments over 8 queries must be equal; K4 runs once
    a shard per launch's worth of queries, K3 once a (data, corpus) tile
    per occupied bucket. Only the mesh side's launches count."""
    import numpy as np

    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
    from tvidz_tpu_torch.corpus.store import Store
    from tvidz_tpu_torch.ops import align, hamming
    from tvidz_tpu_torch.parallel.mesh_corpus import MeshCorpus

    data, shards = _mesh_shape(mesh)
    store = Store(url)
    try:
        single, meshc = DeviceCorpus(device=mesh.home), MeshCorpus(mesh)
        for c in (single, meshc):
            c.load(store)
        check(single._fp_cap == meshc._fp_cap and single._ts_cap == meshc._ts_cap,
              f"{tag}: capacities differ")
        rows = meshc._fp_cap // shards
        edges = [e for e in range(rows, meshc._fp_count, rows)]
        rng = np.random.default_rng(SEED + 30)
        planted = rng.integers(0, 2 ** 32, size=(len(edges), 2), dtype=np.uint32)
        for c in (single, meshc):
            for e, row in zip(edges, planted):
                c._fp[e - 1] = c._fp[e] = row
        qvid = int(single._fp_vid[: single._fp_count].max())   # the last upload
        ts_row = single._vid_to_row[qvid]
        q_ts = single._ts[ts_row, : single._ts_len[ts_row]].tolist()
        fps = store.get_fingerprints(qvid)
        q = np.concatenate([fps[:120], planted])
        long_q = np.concatenate([rng.integers(0, 2 ** 32, size=(40_000 - fps.shape[0], 2),
                                              dtype=np.uint32), fps])
        frags = [store.get_fingerprints(v)[100 * v: 100 * v + 700] for v in range(1, 9)]
        out = {}

        def both(what, call, k4=0, k3=0):
            want = call(single)
            backend.reset_launch_counts()
            got = call(meshc)
            launches = {k.name: k.launches for k in backend.KERNELS}
            check(got == want, f"{tag} {what}: mesh {str(got)[:300]} != "
                               f"single card {str(want)[:300]}")
            check(launches[hamming.K4.name] == k4 and launches[align.K3.name] == k3,
                  f"{tag} {what}: launches {launches}, expected K4 {k4}, K3 {k3}")
            _add_launches(total, launches)
            out[what] = {"launches": {hamming.K4.name: k4, align.K3.name: k3}}
            return got

        hits = both("match_timestamps", lambda c: c.match_timestamps(q_ts))
        check(any(v == qvid for v, _ in hits), f"{tag}: {qvid} not in {hits}")
        both("search_fingerprints", lambda c: c.search_fingerprints(fps[:128]),
             k4=shards)
        counts = both("nearest_video_counts", lambda c: c.nearest_video_counts(q),
                      k4=shards)
        owners = [int(single._fp_vid[e - 1]) for e in edges]
        check(all(counts.get(v, 0) >= 1 for v in owners),
              f"{tag}: planted edge copies not credited to {owners}: {counts}")
        raw = both("query_nearest_raw", lambda c: [
            t.cpu().tolist() for t in c._query_nearest(c._padded_queries(q),
                                                        c._fp_dev)], k4=shards)
        check(raw[1][120:120 + len(edges)] == [e - 1 for e in edges],
              f"{tag}: edge ties resolved to {raw[1][120:]}, not {edges}")
        both("nearest_video_counts_40000", lambda c: c.nearest_video_counts(long_q),
             k4=3 * shards)
        buckets = sum(bu is not None and bu.count > 0 for bu in single._al_buckets)
        found = both("locate_fragments_8", lambda c: c.locate_fragments(frags, top_k=3),
                     k3=buckets * data * shards)
        check(all(r and r[0][0] == v and r[0][1] == 100 * v
                  for v, r in zip(range(1, 9), found)), f"{tag}: fragments {found}")
        out.update(edges=edges, edge_owners=owners, buckets=buckets, query_video=qvid)
        return out
    finally:
        store.close()


def _mesh_scans(mesh, dev) -> dict:
    """``sharded_nearest`` and ``sharded_frame_min`` at M=128 against
    N=2^24 rows (corpus shards of N / corpus rows, ties planted across every
    shard edge) against single-card K4 on the same rows; device time and
    per-call time of both. On one card the shards run one after another."""
    import torch

    from tvidz_tpu_torch.ops import hamming
    from tvidz_tpu_torch.parallel import sharded_search as ss
    from tvidz_tpu_torch.parallel.mesh import CORPUS_AXIS

    shards = mesh.shape[CORPUS_AXIS]
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    corpus = torch.randint(-2 ** 31, 2 ** 31, (MESH_SCAN_N, 2), dtype=torch.int32,
                           device=dev, generator=g)
    q = torch.randint(-2 ** 31, 2 ** 31, (SCAN_M, 2), dtype=torch.int32,
                      device=dev, generator=g)
    rows = MESH_SCAN_N // shards
    for j in range(1, shards):
        corpus[j * rows - 1] = corpus[j * rows] = q[j]
    sh = ss.place(corpus, mesh, CORPUS_AXIS)
    out = {"n": MESH_SCAN_N, "m": SCAN_M, "shards": shards}
    for mode, mesh_fn, single_fn in (
            ("query_nearest", lambda: ss.sharded_nearest(q, sh, mesh),
             lambda: hamming.corpus_query_nearest(q, corpus)),
            ("frame_min", lambda: ss.sharded_frame_min(q, sh, mesh),
             lambda: hamming.corpus_frame_min(q, corpus))):
        got, want = mesh_fn(), single_fn()
        got, want = (got if isinstance(got, tuple) else (got,),
                     want if isinstance(want, tuple) else (want,))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"mesh scans: {mode} at 2^24 differs from single-card K4")
        if mode == "query_nearest":
            check(got[1][1:shards].tolist() == [j * rows - 1 for j in range(1, shards)],
                  f"mesh scans: edge ties {got[1][1:shards].tolist()}")
        mesh_ms, single_ms = interleaved_ms(mesh_fn, single_fn, 20)
        out[mode] = {"mesh_ms": mesh_ms, "single_ms": single_ms,
                     "mesh_device_ms": device_ms(mesh_fn, 20),
                     "single_device_ms": device_ms(single_fn, 20)}
    del corpus, sh
    return out


def _mesh_step(mesh, dev, ts_rows, ts_len, fp_rows, total: dict) -> dict:
    """``multichip_analysis_step`` at B clips x NT tiles x T frames of
    90x160 against the smoke corpus's first 8192 timestamp rows (one
    holding clip 0's planted cut times) and 2^20 fingerprints, against the
    per-clip single-card path (K1 stream, timestamp counts, K4 frame_min):
    scores within SCORE_TOL, the rest bit-equal; K1 once a data row, K4
    once per (clip, corpus shard); its per-call and device time."""
    import numpy as np
    import torch

    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.decode import synthetic
    from tvidz_tpu_torch.ops import fused, hamming, timestamps
    from tvidz_tpu_torch.parallel import step

    data, shards = _mesh_shape(mesh)
    b, nt, t = STEP_CLIPS, STEP_TILES, FRAMES
    cuts = (40, 200, 300, 450, 600, 1000, 1300, 1700, 1900)
    luma, pts = synthetic.synthetic_video(b * nt * t, HEIGHT, WIDTH,
                                          cut_frames=cuts, seed=SEED + 32)
    clips = luma.reshape(b, nt, t, HEIGHT, WIDTH)
    pts = pts.reshape(b, nt * t)
    ts_rows = ts_rows.copy()
    clip0_cuts = [round(float(pts[0, f]), 6) for f in cuts if f < nt * t]
    ts_rows[100] = np.nan
    ts_rows[100, : len(clip0_cuts)] = clip0_cuts
    ts_len = ts_len.copy()
    ts_len[100] = len(clip0_cuts)
    args = step.place_step_inputs(mesh, clips, pts, ts_rows, ts_len, fp_rows)
    backend.reset_launch_counts()
    out = step.multichip_analysis_step(*args, mesh=mesh)
    launches = {k.name: k.launches for k in backend.KERNELS}
    check(launches[fused.K1.name] == data and launches[hamming.K4.name] == b * shards,
          f"step: launches {launches}, expected K1 {data}, K4 {b * shards}")
    _add_launches(total, launches)
    ts_dev = torch.from_numpy(ts_rows).to(dev)
    len_dev = torch.from_numpy(ts_len).to(dev)
    fp_dev = torch.from_numpy(np.ascontiguousarray(fp_rows).view(np.int32)).to(dev)
    pts_dev = torch.from_numpy(np.round(pts, 6).astype(np.float32)).to(dev)
    score_err = 0.0
    for i in range(b):
        sc, fp = fused.fingerprint_stream(torch.from_numpy(clips[i].reshape(-1, HEIGHT, WIDTH)).to(dev))
        score_err = max(score_err, (out.scores[i] - sc).abs().max().item())
        cut = step._extract_cut_ts(sc[None], pts_dev[i:i + 1], 0.3, 32)[0]
        check(torch.equal(out.fingerprints[i], fp)
              and torch.equal(out.ts_counts[i],
                              timestamps.timestamp_match_counts(cut, ts_dev, len_dev))
              and torch.equal(out.fp_min_dist[i], hamming.corpus_frame_min(fp, fp_dev)),
              f"step: clip {i} differs from the single-card path")
    check(score_err <= SCORE_TOL, f"step: scores {score_err} from the K1 stream")
    check(out.ts_counts[0, 100].item() == len(clip0_cuts),
          f"step: planted row matched {out.ts_counts[0, 100].item()} of {len(clip0_cuts)}")
    run = lambda: step.multichip_analysis_step(*args, mesh=mesh)  # noqa: E731
    return {"clips": [b, nt, t, HEIGHT, WIDTH], "ts_rows": int(ts_rows.shape[0]),
            "fp_rows": int(fp_rows.shape[0]), "launches": launches,
            "score_max_abs_err": score_err, "ms": cuda_ms(run, 5),
            "device_ms": device_ms(run, 5)}


def _mesh_whole_path(mesh, work: str, url: str, total: dict) -> dict:
    """``Analyzer.analyze`` of an upload and then its renamed copy on a
    copy of the smoke store, with a MeshCorpus and with the single-card
    DeviceCorpus; then the service (fake S3 -> SQS -> poller -> analyzer,
    shared dispatcher) on a fresh store with each. The mesh side's
    verdicts must equal the single card's, and name the original."""
    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
    from tvidz_tpu_torch.corpus.store import Store
    from tvidz_tpu_torch.decode import write_synthetic_y4m
    from tvidz_tpu_torch.parallel.mesh_corpus import MeshCorpus
    from tvidz_tpu_torch.pipeline.analyzer import Analyzer
    from tvidz_tpu_torch.pipeline.progress import AnalysisRegistry

    cfg = Config()
    src = os.path.join(work, "mesh_src")
    os.makedirs(src, exist_ok=True)
    write_synthetic_y4m(os.path.join(src, "mesh-src.y4m"), num_frames=300,
                        height=180, width=320, cut_frames=(70, 160, 250),
                        seed=SEED + 33)
    shutil.copy(os.path.join(src, "mesh-src.y4m"), os.path.join(src, "mesh-copy.y4m"))

    def fetcher(bucket, key, local):
        shutil.copy(os.path.join(src, key), local)

    def mesh_corpus():
        return MeshCorpus(mesh, max_cuts=cfg.match.max_cuts, words=cfg.hash.words,
                          hamming_threshold=cfg.match.hamming_threshold)

    verdicts = {}
    for tag, make in (("single", lambda: DeviceCorpus(device=mesh.home)),
                      ("mesh", mesh_corpus)):
        db = os.path.join(work, f"mesh_{tag}.db")
        shutil.copy(url[len("sqlite:///"):], db)
        store = Store(f"sqlite:///{db}")
        try:
            corpus = make()
            corpus.load(store)
            analyzer = Analyzer(store, corpus, AnalysisRegistry(), fetcher, cfg)
            backend.reset_launch_counts()
            verdicts[tag] = [(r.status, r.duplicates, r.scene_cuts) for r in
                             (analyzer.analyze("videos", "mesh-src.y4m"),
                              analyzer.analyze("videos", "mesh-copy.y4m"))]
            if tag == "mesh":
                _add_launches(total, {k.name: k.launches for k in backend.KERNELS})
        finally:
            store.close()
    check(verdicts["mesh"] == verdicts["single"]
          and verdicts["mesh"][0][:2] == ("done", [])
          and verdicts["mesh"][1][:2] == ("done", ["mesh-src.y4m"]),
          f"mesh analyze: {verdicts}")
    service = {}
    ups = {"mesh-svc.y4m": os.path.join(src, "mesh-src.y4m")}
    for tag, corpus in (("single", None), ("mesh", mesh_corpus())):
        out, k1, passes = _service_uploads(work, f"mesh_svc_{tag}", cfg, ups,
                                           "mesh-svc.y4m", corpus=corpus)
        if tag == "mesh":
            _add_launches(total, {k.name: k.launches for k in backend.KERNELS})
        service[tag] = {n: (v["status"], v.get("duplicates"), v.get("scene_cuts"))
                        for n, v in out.items()}
    check(service["mesh"] == service["single"]
          and service["mesh"]["renamed-copy.y4m"][:2] == ("done", ["mesh-svc.y4m"]),
          f"mesh service: {service}")
    return {"analyze": verdicts["mesh"][1][:2], "service": service["mesh"]}


def drive_mesh(dev, work: str, url: str, smi: str) -> dict:
    """Phase ``mesh``: the corpus sharded over ``make_mesh(devices=[cuda:0]
    * 8)`` = (data 2, corpus 4) — MeshCorpus against DeviceCorpus on the
    smoke store, the 2^24 mesh scans against single-card K4, the
    multi-card step against the per-clip single-card path, and the
    analyzer and service verdicts on a MeshCorpus. With two or more cards
    the same checks run again on ``make_mesh()`` over the real devices.
    Launch counts are zeroed before and read after each mesh-side call
    (the single-card side's launches are not counted)."""
    import numpy as np
    import torch

    from tvidz_tpu_torch.parallel.mesh import make_mesh
    from tvidz_tpu_torch.corpus.store import Store
    from tvidz_tpu_torch.ops import align, fused, hamming

    count = torch.cuda.device_count()
    meshes = [("repeated", make_mesh(devices=[dev] * MESH_CELLS))]
    if count >= 2:
        meshes.append(("devices", make_mesh()))
    store = Store(url)
    try:
        ts_rows, ts_len = np.full((STEP_TS_ROWS, 128), np.nan, np.float32), \
            np.zeros(STEP_TS_ROWS, np.int32)
        for i, (_, row) in enumerate(store.all_timestamps()[:STEP_TS_ROWS]):
            ts_rows[i, : len(row)] = row[:128]
            ts_len[i] = min(len(row), 128)
        fp_rows = np.concatenate([f for _, f in store.all_fingerprints()])[:STEP_FP_ROWS]
    finally:
        store.close()
    total, fields = {}, {}
    for tag, mesh in meshes:
        t0 = time.perf_counter()
        fields[tag] = {
            "mesh": _mesh_shape(mesh),
            "devices": [str(d) for d in mesh.distinct_devices],
            "corpus": _mesh_corpus_checks(mesh, url, tag, total),
            "scans_2_24": _mesh_scans(mesh, dev),
            "step": _mesh_step(mesh, dev, ts_rows, ts_len, fp_rows, total),
            "whole_path": _mesh_whole_path(mesh, work, url, total),
        }
        fields[tag]["seconds"] = time.perf_counter() - t0
    launches = {k.name: total.get(k.name, 0) for k in (fused.K1, hamming.K2,
                                                       align.K3, hamming.K4)}
    check(all(launches[k.name] > 0 for k in (fused.K1, align.K3, hamming.K4)),
          f"mesh: kernels of the path never launched: {launches}")
    phase("mesh", card=smi, device_count=count,
          real_device_mesh=("ran" if count >= 2 else
                            f"not run: {count} CUDA device on this machine"),
          note="the repeated-device mesh runs its shards one after another "
               "on one card: these times are not multi-GPU scaling",
          launches=launches, **fields)
    return launches


MH_RANKS, MH_CELLS = 2, 2      # the multihost phase: ranks on cuda:0, cells each


def _run_driver(argv, what: str, timeout: float) -> dict:
    """Run one of the port's multi-host drivers (a module) to its end; its
    last line is its JSON summary. Its ranks' output goes to a file beside
    the summary, and the tail of it into the failure."""
    import signal

    env = dict(os.environ, TVIDZ_DIST_BACKEND="gloo")
    # A session of its own: on a timeout the driver and the rank processes
    # it started are killed together.
    proc = subprocess.Popen([sys.executable, "-m", *argv], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    lines = out.strip().splitlines()
    try:
        summary = json.loads(lines[-1])
    except (IndexError, ValueError):
        summary = {"ok": False}
    check(proc.returncode == 0 and summary.get("ok"),
          f"{what}: exit {proc.returncode}, {str(summary)[:1500]}\n"
          f"{out[-3000:]}\n{err[-3000:]}")
    return summary


def drive_multihost(work: str, smi: str) -> dict:
    """Phase ``multihost``: the corpus sharded across two rank processes of
    a ``torch.distributed`` group, both on cuda:0 over gloo (NCCL refuses two
    ranks on one card).

    1. ``parallel.dryrun --large``: each rank with ``[cuda:0] * 2`` cells
       places its half of a 2^24-row fingerprint index, 2^16 timestamp rows
       and a 4096-video alignment index, and runs ``match_timestamps``,
       ``search_fingerprints`` (K4 ``frame_min`` per local shard),
       ``nearest_fingerprints`` and ``fragment_search(_batch)`` (K3); every
       rank's answers must be identical and equal to a single-card
       DeviceCorpus of the same rows, ties planted across the rank boundary
       and every shard edge included, and the evidence and the fragment
       also to the same DeviceCorpus with K4 and K3 swapped for their plain
       versions (the reference dryrun's appends, churn and compaction run
       in the CPU tests and the ``cuda`` tests, not here).
    2. ``service.integration_multihost --quick``: two entrypoint processes
       on one shared sqlite store warmed from a fresh 2^20-fingerprint
       ``prefill_store``: a verdict across ranks, /status from the other
       rank, cross-rank fragment searches, online growth past the warm
       capacity, op-log pruning and a remove.

    Each rank zeroes its counts before its work (the dryrun at its
    scenario, a service once ready) and reports them; K3 and K4 must have
    launched on every dryrun rank, K3 on every served rank and K1 on each
    rank that ingested."""
    import torch

    from tvidz_tpu_torch.ops import align, fused, hamming

    # The ranks share the card with this process: hand back what its
    # allocator caches from the earlier phases.
    torch.cuda.empty_cache()
    t_phase = t0 = time.perf_counter()
    dry = _run_driver(
        ["tvidz_tpu_torch.parallel.dryrun", "--processes", str(MH_RANKS),
         "--device", "cuda", "--cells", str(MH_CELLS), "--large",
         "--out", os.path.join(work, "mh_dryrun")], "multihost dryrun", 400)
    dry_s = time.perf_counter() - t0
    for r, counts in enumerate(dry["launches"]):
        check(counts[align.K3.name] > 0 and counts[hamming.K4.name] > 0,
              f"multihost dryrun: rank {r} launched {counts}")
    t0 = time.perf_counter()
    db = os.path.join(work, "mh_prefill.db")
    n_fp = prefill_store(db)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = _run_driver(
        ["tvidz_tpu_torch.service.integration_multihost", "--device", "cuda",
         "--quick", "--store-from", db],
        "multihost served", 400)
    served_s = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase
    ingested = (0, 1)                    # A and G on rank 0, B on rank 1
    for r, rank in enumerate(served["ranks"]):
        counts = rank["kernel_launches"]
        check(counts[align.K3.name] > 0
              and (r not in ingested or counts[fused.K1.name] > 0),
              f"multihost served: rank {r} launched {counts}")
    per_rank = ([c for c in dry["launches"]]
                + [rank["kernel_launches"] for rank in served["ranks"]])
    launches = {k.name: sum(c[k.name] for c in per_rank)
                for k in (fused.K1, hamming.K2, align.K3, hamming.K4)}
    phase("multihost", card=smi, ranks=MH_RANKS, backend="gloo",
          seconds=phase_s,
          dryrun={"seconds": dry_s, "mesh": dry["mesh"], "edges": dry["edges"],
                  "launches": dry["launches"], "rank_seconds": dry["rank_seconds"],
                  "parent_seconds": dry["parent_seconds"],
                  "timings": dry["timings"]},
          served={"seconds": served_s, "prefill_seconds": prefill_s,
                  "prefill_fingerprints": n_fp,
                  "timings": served["timings"],
                  "ranks": served["ranks"]},
          launches=launches)
    return launches


def _built_libraries() -> dict:
    """The kernel libraries in the build directory, with their mtimes."""
    from tvidz_tpu_torch import backend

    if not os.path.isdir(backend.BUILD_DIR):
        return {}
    return {f: os.path.getmtime(os.path.join(backend.BUILD_DIR, f))
            for f in os.listdir(backend.BUILD_DIR) if f.endswith(".so")}


def drive_wire_stack(work: str, smi: str) -> dict:
    """Phase ``wire_stack``: the service as production deploys it, its own
    process on cuda:0, over the real wire:

    (a) ``service.integration --real-clients --pg --store-from``: uploads
        as presigned PUTs to the port's MiniAWS, the S3 notification to SQS
        over HTTP, the poller, the analyzer (K1), the verdict (K4
        ``query_nearest``), fragment search (K3), and every store operation
        over the PostgreSQL wire protocol to the port's MiniPG, which serves
        a copy of a fresh 2^20-fingerprint ``prefill_store`` (restored at
        boot over the wire); MiniPG is down when a third upload arrives and
        comes back once a store operation of it has failed;
    (b) the same driver with ``--mesh`` (the corpus over ``[cuda:0] * 8``)
        and ``--real-clients``, on an empty sqlite store;
    (c) ``service.integration_multihost --pg --quick``: two rank processes
        on cuda:0 over gloo with MiniPG, serving the same prefill, as the
        store they coordinate through;
    (d) ``service.soak``: 40 uploads, 4 in flight, RSS and device memory
        once warm and at the end;
    (e) ``service.soak --mesh``: 20 uploads to the service with the corpus
        over ``[cuda:0] * 8``;
    (f) ``service.soak_multihost``: 12 uploads alternating two rank
        processes on cuda:0 over gloo (both ``--mesh``, one shared sqlite
        store), the op log's row count sampled throughout, at most 64, and
        pruned to the live floor at the end.

    Each service process counts its launches from its ready point and
    reports them; (a) and (b) must launch K1, K4 and K3, (e) and each rank
    of (f) K1 and K4 (the routes they drive reach K4 only through
    ``nearest_video_counts``: its ``query_nearest`` mode). The kernels were
    built by the ``build`` phase: no process here may build one again.
    Last, K1's hashes of the uploads of (e) and (f), decoded as the
    service decodes them, are held against ``golden.phash``: the
    histogram of bits that differ a frame."""
    from tvidz_tpu_torch.ops import align, fused, hamming

    import torch

    torch.cuda.empty_cache()
    libraries = _built_libraries()
    t_phase = time.perf_counter()
    db = os.path.join(work, "wire_prefill.db")
    n_fp = prefill_store(db)
    legs, walls = {}, {}
    for leg, argv in (
            ("a", ["tvidz_tpu_torch.service.integration", "--device", "cuda",
                   "--real-clients", "--pg", "--store-from", db]),
            ("b", ["tvidz_tpu_torch.service.integration", "--device", "cuda",
                   "--real-clients", "--mesh"]),
            ("c", ["tvidz_tpu_torch.service.integration_multihost", "--device",
                   "cuda", "--pg", "--quick", "--store-from", db]),
            ("d", ["tvidz_tpu_torch.service.soak", "--device", "cuda"]),
            ("e", ["tvidz_tpu_torch.service.soak", "--mesh", "--device",
                   "cuda"]),
            ("f", ["tvidz_tpu_torch.service.soak_multihost", "--device",
                   "cuda"])):
        t0 = time.perf_counter()
        legs[leg] = _run_driver(argv, f"wire_stack ({leg})", 400)
        walls[leg] = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase
    names = (fused.K1, hamming.K2, align.K3, hamming.K4)
    per_leg = {leg: ([r["kernel_launches"] for r in legs[leg]["ranks"]]
                     if leg in ("c", "f") else [legs[leg]["kernel_launches"]])
               for leg in legs}
    for leg in ("a", "b"):
        counts = per_leg[leg][0]
        check(all(counts[k.name] > 0 for k in (fused.K1, hamming.K4, align.K3)),
              f"wire_stack ({leg}): launched {counts}")
    # Every rank of (f) ingests: the uploads alternate the two hosts.
    for leg in ("e", "f"):
        for counts in per_leg[leg]:
            check(all(counts[k.name] > 0 for k in (fused.K1, hamming.K4)),
                  f"wire_stack ({leg}): launched {counts}")
    rebuilt = sorted(f for f, t in _built_libraries().items()
                     if libraries.get(f) != t)
    check(not rebuilt, f"wire_stack: kernels built again: {rebuilt}")
    launches = {k.name: sum(c[k.name] for cs in per_leg.values() for c in cs)
                for k in names}
    a, b, c, d, e, f = (legs[k] for k in "abcdef")
    vs_golden = soak_uploads_vs_golden(work)
    phase("wire_stack", card=smi, seconds=phase_s,
          leg_seconds=walls, legs_passed=sorted(legs),
          prefill_fingerprints=n_fp, kernels_rebuilt=rebuilt,
          k4_mode="query_nearest",
          a={"timings": a["timings"], "upload_format": a["upload_format"],
             "failover": a["failover"],
             "rows_after_failover": a["rows_after_failover"],
             "fragment_match_count": a["fragment_match_count"],
             "block_dispatcher": a["block_dispatcher"],
             "launches": per_leg["a"][0]},
          b={"timings": b["timings"], "launches": per_leg["b"][0]},
          c={"timings": c["timings"], "ranks": c["ranks"]},
          d={k: v for k, v in d.items() if k not in ("ok", "failures")},
          e={k: v for k, v in e.items() if k not in ("ok", "failures")},
          f={"seconds": f["seconds"], "videos": f["videos"],
             "videos_per_s": f["videos_per_s"], "boot_s": f["boot_s"],
             "oplog_max_rows": f["oplog_max_rows"],
             "oplog_final_rows": f["oplog_final_rows"],
             "oplog_max_lag_ops": f["oplog_max_lag_ops"],
             "oplog_samples": f["oplog_samples"],
             "corpus_videos": f["corpus_videos"], "ranks": f["ranks"]},
          soak_uploads_k1_vs_golden_bits=vs_golden,
          launches=launches)
    return launches


def soak_uploads_vs_golden(work: str) -> dict:
    """K1's hashes of the originals the soaks of legs (e) and (f) upload,
    decoded to 90x160 as the service decodes them, against
    ``golden.phash``: how many frames differ by 0, 1, 2 and more bits.
    (One K1 launch a clip, outside every launch-count window.)"""
    import numpy as np
    import torch

    from tvidz_tpu_torch.decode.y4m import Y4MDecoder
    from tvidz_tpu_torch.ops import fused
    from tvidz_tpu_torch.service import soak, soak_multihost

    out = os.path.join(work, "soak_uploads")
    os.makedirs(out)
    _, _, originals = soak.make_uploads(out, soak.MESH_VIDEOS)
    paths = [p for _, p in originals] + sorted({
        soak_multihost.write_clip(out, seed)
        for _, seed, copy_of in soak_multihost.upload_plan(soak_multihost.VIDEOS)
        if copy_of is None})
    luma = [np.ascontiguousarray(np.concatenate([b.luma for b in Y4MDecoder(
        ).blocks(p, FRAMES, HEIGHT, WIDTH)])) for p in paths]
    words = [fused.fingerprint_stream(torch.from_numpy(x).cuda())[1].cpu().numpy()
             for x in luma]
    hist = golden_bits_histogram(np.concatenate(luma), np.concatenate(words))
    return {"clips": len(paths), "frames": sum(len(x) for x in luma), **hist}


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


def popc_ceiling_ms(dev, m: int, n: int, words: int) -> dict:
    """The ceiling of K2's XOR + popcount formulation: one POPC per 32-bit
    word of every (query, row) pair, at 16 POPC a clock per SM (Hopper's
    issue rate for it) and the card's top SM clock; the same function on
    the tensor cores is K4."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    popc = m * n * words
    return {"popc": popc, "sms": sms, "max_sm_mhz": mhz,
            "ms": popc / (sms * 16 * mhz * 1e6) * 1e3}


def k1_timed_row(dev, gen, frames: int, h: int, w: int) -> dict:
    """K1 over ``frames`` random frames of (h, w) from a fresh carry: per
    call (CUDA events, interleaved with the plain version) and on the device
    (torch.profiler), its grid, bands and bound; and how many frames' hashes
    are not bit-identical to the plain version's and to golden.phash's (the
    first K1_GOLDEN_FRAMES), ROADMAP C.8's record."""
    import numpy as np
    import torch

    from tvidz_tpu_torch.ops import fused, golden, phash

    x = torch.randint(0, 256, (frames, h, w), dtype=torch.uint8, device=dev,
                      generator=gen)
    left, right = phash.hash_operators(h, w, dev)
    carry = fused.initial_fingerprint_carry(h, w, dev)
    fn = lambda: fused.fingerprint_block(x, carry, left, right)  # noqa: E731
    fn_plain = lambda: fused.fingerprint_block_plain(x, carry, left, right)  # noqa: E731
    _, fk, _ = fn()
    _, fp, _ = fn_plain()
    vs_plain = hash_bits(fk, fp)
    g = min(frames, K1_GOLDEN_FRAMES)
    gold = np.stack([golden.phash(f) for f in x[:g].cpu().numpy()])
    vs_golden = popcount_rows(phash.words_to_numpy(fk[:g]) ^ gold)
    check(int(vs_plain.max()) <= HASH_BITS_TOL and int(vs_golden.max()) <= HASH_BITS_TOL,
          f"K1 {frames} x {h}x{w}: hash bits {int(vs_plain.max())} from the plain "
          f"version, {int(vs_golden.max())} from golden")
    del fp
    torch.cuda.empty_cache()
    ms, plain_ms = interleaved_ms(fn, fn_plain, 5 if frames == FRAMES else 2)
    b = k1_bound(frames, h, w)
    rows = fused.k1_band_rows(h, w) if fused.k1_form(h, w) == 1 else h
    return {"frames": frames, "hw": [h, w], "form": fused.k1_form(h, w),
            "grid": fused.fingerprint_grid(frames, h, w), "bands": -(-h // rows),
            "band_rows": rows, "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms(fn, 10 if frames == FRAMES else 3),
            "bound_ms": b[0], "bound_by": b[1],
            "hash_max_bit_diff": int(vs_plain.max()),
            "frames_not_bit_identical": int((vs_plain > 0).sum()),
            "golden_frames": g, "golden_max_bit_diff": int(vs_golden.max()),
            "frames_not_bit_identical_vs_golden": int((vs_golden > 0).sum())}


def align_bound_ms(q_lens, lens, words: int) -> float:
    """``perfbench/peaks.align_bound_s`` of a K3 call's real query and video
    lengths, in ms: the yardstick of the benchmark's ``k3_roofline``."""
    return peaks.align_bound_s(q_lens.tolist(), lens.tolist(), words) * 1e3


def time_k3_request(dev, w: int) -> dict:
    """K3 at rows of ``w`` words at the fragment-search cells' per-request
    shape (W = 8: ``fragsearch-phash256``, the tiles form; W = 2:
    ``fragsearch-phash64``, the band form): Q = 4 spans of K3_REQUEST_SPANS
    frames (one Tq_pad) against the two buckets, 4,080 catalog videos of
    4,096 frames and 64 sources of 1,024, each launch's device time beside
    its bound; the two together are one request's K3. Random rows with a
    planted span a query, each found whole at its offset; the sources
    bucket and the catalog's first K3_REQUEST_PLAIN_VIDEOS videos equal to
    the plain version."""
    import torch

    from tvidz_tpu_torch.ops import align

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    tq_pad = -(-max(K3_REQUEST_SPANS) // 64) * 64
    ql = torch.tensor(K3_REQUEST_SPANS, dtype=torch.int32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    form = align.k3_form(w)
    out, total_ms, total_bound = {}, 0.0, 0.0
    for name, (v, tc) in (("catalog", (4080, 4096)), ("sources", (64, 1024))):
        c = torch.randint(-2 ** 31, 2 ** 31, (v, tc, w), dtype=torch.int32,
                          device=dev, generator=gen)
        ln = torch.full((v,), tc, dtype=torch.int32, device=dev)
        qs = torch.randint(-2 ** 31, 2 ** 31, (4, tq_pad, w), dtype=torch.int32,
                           device=dev, generator=gen)
        for q, n in enumerate(K3_REQUEST_SPANS):
            qs[q, :n] = c[(17 * q + 3) % v, tc - n:]
        fn = lambda: align.fragment_search_batch(qs, ql, c, ln, FRAG_THR)  # noqa: E731
        ms = device_ms(fn, 5)
        ko, ks = fn()
        for q, n in enumerate(K3_REQUEST_SPANS):
            row = (17 * q + 3) % v
            check(int(ks[q, row]) == n and int(ko[q, row]) == tc - n,
                  f"K3 request, W = {w} ({name}): query {q} at video {row} read "
                  f"{int(ko[q, row])}, {int(ks[q, row])} != {tc - n}, {n}")
        k = min(v, K3_REQUEST_PLAIN_VIDEOS)
        po, ps = align.fragment_search_batch_plain(qs, ql, c[:k], ln[:k], FRAG_THR)
        check(torch.equal(ko[:, :k], po) and torch.equal(ks[:, :k], ps),
              f"K3 request, W = {w} ({name}): the first {k} videos differ from the "
              f"plain version")
        b = align_bound_ms(ql, ln, w)
        out[name] = {"shape": [4, tq_pad, v, tc], "device_ms": ms, "align_bound_ms": b,
                     "plain_checked_videos": k,
                     "roofline_pct": 100.0 * b / ms, "form": form}
        if form == "tiles":
            out[name]["plan"] = align.k3_tiles_plan(4, tq_pad, v, tc, w, n_sm)
        total_ms, total_bound = total_ms + ms, total_bound + b
        del c
    out.update(spans=list(K3_REQUEST_SPANS), device_ms=total_ms,
               align_bound_ms=total_bound, roofline_pct=100.0 * total_bound / total_ms)
    return out


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
    k2_ceiling = popc_ceiling_ms(dev, SCAN_M, SCAN_N, 2)
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
    # K1's second form (a block at T=128 and a whole stream, per geometry),
    # and K4 and K3 at W = 8 (phash256).
    k1_geo = {label: k1_timed_row(dev, gen, frames, h, w)
              for label, frames, h, w in K1_TIMED_GEOMETRIES}
    q8, corpus8 = scan_inputs(dev, {}, PHASH256_WORDS)
    k4_w8 = {}
    for mode in ("query_nearest", "frame_min"):
        fn = lambda mode=mode: hamming.corpus_scan_tc(q8, corpus8, mode)  # noqa: E731
        fn_plain = lambda mode=mode: hamming.corpus_scan_pm1_plain(  # noqa: E731
            q8, corpus8, mode)
        ms, plain_ms = interleaved_ms(fn, fn_plain, 3)
        b = scan_bound(SCAN_M, SCAN_N, PHASH256_WORDS)
        k4_w8[mode] = {"ms": ms, "plain_ms": plain_ms, "device_ms": device_ms(fn, 20),
                       "bound_ms": b[0], "bound_by": b[1],
                       "grid": hamming.corpus_scan_tc_grid(mode, SCAN_N, dev,
                                                           PHASH256_WORDS)}
    # K2 at W = 8: its chunked instance in one chunk (off every route).
    fn = lambda: hamming.corpus_min_distance(q8, corpus8, frame_min=False)  # noqa: E731
    fn()
    b = scan_bound(SCAN_M, SCAN_N, PHASH256_WORDS)
    k2_w8 = {"ms": cuda_ms(fn, 5), "device_ms": device_ms(fn, 5),
             "bound_ms": b[0], "bound_by": b[1]}
    del corpus8
    (qs8, ql8, c8, ln8), _ = fragment_inputs(dev, FRAG_A, SEED + 3, PHASH256_WORDS)
    fn = lambda: align.fragment_search_batch(qs8, ql8, c8, ln8, FRAG_THR)  # noqa: E731
    fn_plain = lambda: align.fragment_search_batch_plain(  # noqa: E731
        qs8, ql8, c8, ln8, FRAG_THR)
    ms, plain_ms = interleaved_ms(fn, fn_plain, 2)
    pairs8 = int(ql8.to(torch.int64).sum() * ln8.to(torch.int64).sum())
    bytes8 = sum(t.numel() * t.element_size() for t in (qs8, ql8, c8, ln8)) \
        + 2 * 4 * FRAG_A[0] * FRAG_A[2]
    b = bound(bytes8, 2 * 32 * PHASH256_WORDS * pairs8, peaks.INT8_TC_OPS_PER_S)
    dc8, dq8 = dense_inputs(c8, qs8)
    k3_w8 = {"shape": list(FRAG_A), "ms": ms, "plain_ms": plain_ms,
             "device_ms": device_ms(fn, 10), "bound_ms": b[0], "bound_by": b[1],
             "align_bound_ms": align_bound_ms(ql8, ln8, PHASH256_WORDS),
             "dense_device_ms": device_ms(
                 lambda: align.fragment_search_batch(dq8, ql8, dc8, ln8, FRAG_THR), 5)}
    del c8, dc8
    k3_w8_request = time_k3_request(dev, PHASH256_WORDS)
    k3_w2_request = time_k3_request(dev, 2)
    # K4, K2 and K3 at the widths they walk in word chunks (and W = 26 and
    # 32, which K4 holds in one pass and K2 in one chunk). The plain XOR
    # scan is not timed there (seconds a call at W = 128; K2 is off every
    # route).
    wider = {}
    for words in WIDER_WORDS:
        qw, cw = scan_inputs(dev, {}, words)
        b = scan_bound(SCAN_M, SCAN_N, words)
        row = {}
        for mode in ("query_nearest", "frame_min"):
            fn = lambda mode=mode: hamming.corpus_scan_tc(qw, cw, mode)  # noqa: E731
            fn_plain = lambda mode=mode: hamming.corpus_scan_pm1_plain(  # noqa: E731
                qw, cw, mode)
            ms, plain_ms = interleaved_ms(fn, fn_plain, 2)
            row[f"k4_{mode}"] = {
                "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms(fn, 5),
                "bound_ms": b[0], "bound_by": b[1],
                "grid": hamming.corpus_scan_tc_grid(mode, SCAN_N, dev, words)}
        fn = lambda: hamming.corpus_min_distance(qw, cw, frame_min=False)  # noqa: E731
        fn()
        row["k2"] = {"ms": cuda_ms(fn, 3), "plain_ms": None,
                     "device_ms": device_ms(fn, 3), "bound_ms": b[0],
                     "bound_by": b[1]}
        del cw
        (qs, ql, c, ln), _ = fragment_inputs(dev, K3_WIDER_SHAPE, SEED + 9, words)
        fn = lambda: align.fragment_search_batch(qs, ql, c, ln, FRAG_THR)  # noqa: E731
        fn_plain = lambda: align.fragment_search_batch_plain(  # noqa: E731
            qs, ql, c, ln, FRAG_THR)
        ms, plain_ms = interleaved_ms(fn, fn_plain, 2)
        pairs = int(ql.to(torch.int64).sum() * ln.to(torch.int64).sum())
        nbytes = sum(t.numel() * t.element_size() for t in (qs, ql, c, ln)) \
            + 2 * 4 * K3_WIDER_SHAPE[0] * K3_WIDER_SHAPE[2]
        bk3 = bound(nbytes, 2 * 32 * words * pairs, peaks.INT8_TC_OPS_PER_S)
        row["k3"] = {"shape": list(K3_WIDER_SHAPE), "ms": ms, "plain_ms": plain_ms,
                     "device_ms": device_ms(fn, 5), "bound_ms": bk3[0],
                     "bound_by": bk3[1]}
        wider[words] = row
    return {"k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms, "k1_geometries": k1_geo,
            "k4_w8": k4_w8, "k2_w8": k2_w8, "k3_w8": k3_w8,
            "k3_w8_request": k3_w8_request, "k3_w2_request": k3_w2_request,
            "wider_words": wider,
            "k1_device_ms": sum(k1_items.values()),
            "k1_device_items": sorted(k1_items),
            "k1_grid": fused.fingerprint_grid(FRAMES, HEIGHT, WIDTH),
            "k1_stream": k1_stream,
            "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms, "k2_popc_ceiling": k2_ceiling,
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
    k1_err = max(k1_err, check_k1_geometries(dev)["score_max_abs_err"])
    k2_err = check_corpus_scan(dev)
    k3_err = check_fragment_search(dev)
    k3_err = max(k3_err, check_k3_wide(dev))

    k4_err = check_scan_modes(dev)
    wide_err = check_wide_scans(dev)
    k2_err, k4_err = max(k2_err, wide_err), max(k4_err, wide_err)
    times = time_kernels(dev)

    work = tempfile.mkdtemp(prefix="tvidz_chip_smoke_")
    os.environ["TVIDZ_TMP_DIR"] = os.path.join(work, "tmp")
    os.makedirs(os.environ["TVIDZ_TMP_DIR"])
    try:
        path_launches, url = drive_main_path(work)
        path_launches["service"] = drive_service(work, url, smi)
        path_launches["bench"] = drive_bench(smi)
        path_launches["phash256"] = drive_phash256(work, smi)
        path_launches["hash32"], wide_err = drive_wide_words(dev, work, smi)
        k2_err, k3_err, k4_err = (max(e, wide_err) for e in (k2_err, k3_err, k4_err))
        path_launches["ship_coeffs"] = drive_ship_coeffs(dev, work, smi)
        path_launches["forward_batch"] = drive_forward_batch(dev, smi)
        path_launches["multistream"] = drive_multistream(work, smi)
        path_launches["bench_legs"] = drive_bench_legs(smi)
        path_launches["mesh"] = drive_mesh(dev, work, url, smi)
        path_launches["multihost"] = drive_multihost(work, smi)
        path_launches["wire_stack"] = drive_wire_stack(work, smi)
        path_launches[f"scene_{SCENE_GEOMETRY[0]}x{SCENE_GEOMETRY[1]}"] = \
            drive_scene_geometry(work, smi)

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
        # K2 and K4 time the same function (query-nearest) at W = 2.
        hamming.K2.name: scan_bound(m, n, 2),
        hamming.K4.name: scan_bound(m, n, 2),
        # K3 at shape (a): 64 int8 multiply-adds per overlapping pair.
        align.K3.name: bound(times["k3_bytes"], 2 * 64 * times["k3_pairs"],
                             peaks.INT8_TC_OPS_PER_S),
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
