#!/usr/bin/env python3
"""Quickest proof that tvidz_tpu_torch runs on the GPU: build its kernels,
check each against its plain PyTorch version, drive ``ingest`` / ``analyze``
/ ``search`` through the port's CLI and the inspector service (uploads over
the fake S3 -> SQS path, SSE, fragment and video search) against a
2^20-fingerprint corpus, and time it.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and on any
failed phase. Each phase prints one line; the line before the last is
``nvidia-smi``'s card name and power limit, and the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
SCORE_TOL = 1e-6        # mafd sums are integer-exact: bit-equal expected
HASH_BITS_TOL = 2       # f32 sums in another order (tests/test_ops_phash.py)


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


def device_ms(fn, reps: int) -> float:
    """Device time per call — kernels, copies and memsets summed from a
    torch.profiler trace. Unlike ``cuda_ms`` it leaves out the gaps while
    the host issues launches, which dominate calls this short."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / reps / 1e3


def device_busy(prof, wall_s: float) -> dict:
    """Device busy time, idle share over ``wall_s`` and the top five items
    of a device-activity-only torch.profiler trace (with CPU ops traced too,
    each op would carry its kernels' device time again)."""
    ops = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                  if e.self_device_time_total > 0), reverse=True)
    busy_us = sum(us for us, _ in ops)
    return {"device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / (wall_s * 1e6),
            "device_top_ops_ms": [[k[:80], us / 1e3] for us, k in ops[:5]]}


def popcount_rows(x):
    import numpy as np

    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1).sum(-1)


# -- phase 3: K1 -----------------------------------------------------------------


def check_fingerprint_block(dev):
    import numpy as np
    import torch

    from tvidz_tpu_torch._reference import synthetic
    from tvidz_tpu_torch.ops import fused, phash

    rng = np.random.default_rng(SEED)
    left, right = phash.hash_operators(HEIGHT, WIDTH, dev)
    random_luma = rng.integers(0, 256, size=(3 * FRAMES + 50, HEIGHT, WIDTH),
                               dtype=np.uint8)
    synth_luma, _ = synthetic.synthetic_video(
        3 * FRAMES + 50, HEIGHT, WIDTH, cut_frames=(40, 200, 300), seed=SEED)
    max_err, max_bits, differing, frames = 0.0, 0, 0, 0
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
            max_err = max(max_err, abs(ck.scene.prev_mafd.item()
                                       - cp.scene.prev_mafd.item()))
    check(max_err <= SCORE_TOL, f"K1 scores differ by {max_err} > {SCORE_TOL}")
    check(max_bits <= HASH_BITS_TOL,
          f"K1 hashes differ by {max_bits} bits > {HASH_BITS_TOL}")

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
          frames_not_bit_identical=differing, median_pack_rows_exact=low.shape[0])
    return max_err


# -- phase 4: K2 -----------------------------------------------------------------


def scan_inputs(dev):
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
    to = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    return to(q), to(corpus)


def check_corpus_scan(dev):
    import torch

    from tvidz_tpu_torch.ops import hamming

    q, corpus = scan_inputs(dev)
    fk, mk, ak = hamming.corpus_min_distance(q, corpus)
    fp, mp, ap = hamming.corpus_min_distance_plain(q, corpus)
    mk2, ak2 = hamming.corpus_query_nearest(q, corpus)
    torch.cuda.synchronize()
    err = max((fk - fp).abs().max().item(), (mk - mp).abs().max().item(),
              (ak - ap).abs().max().item())
    check(err == 0 and torch.equal(mk2, mp) and torch.equal(ak2, ap),
          f"K2 differs from the plain version (max abs err {err})")
    check(int(mk[3]) == 0 and int(ak[3]) == 1000, "K2 missed the planted tie")
    check(int(mk[5]) == 2 and int(ak[5]) == 70_000, "K2 missed a dist-2 tie")
    check(int(ak[9]) == 2048 * 7 + 1023, "K2 tie across a CTA edge")
    check(int(mk[11]) == 0 and int(ak[11]) == SCAN_N - 4096,
          "K2 sentinel rows not scanned like the reference")
    phase("k2_vs_plain", m=SCAN_M, n=SCAN_N, max_abs_err=err,
          outputs_exact=True)
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
    phase("k3_vs_plain", threshold=FRAG_THR, max_abs_err=err, exact=True,
          shapes=checked)
    return float(err)


# -- phase 6: the main path --------------------------------------------------------


def prefill_store(db_path: str) -> int:
    """A realistic corpus, seeded: FILLER_VIDEOS videos with timestamps and
    FILLER_FP_VIDEOS x FILLER_FP_FRAMES (= 2^20) random fingerprints,
    written in one transaction into the store's own schema."""
    import numpy as np

    from tvidz_tpu_torch._reference import Store

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
    from tvidz_tpu_torch._reference import write_synthetic_y4m

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
    launches = {k.name: k.launches for k in backend.KERNELS}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    corpus = sessions[-1][2]
    check(corpus._fp_dev.device.type == "cuda"
          and corpus._ts_dev.device.type == "cuda",
          "corpus tensors are not on the GPU")
    phase("main_path", launches=launches, renamed_copy=res["duplicates"],
          fresh_duplicates=fresh["duplicates"],
          search_top_alignment=found["best_alignments"][0],
          k1_scored_cuts=dev_cut["scene_cuts"], planted_cuts=delta_cuts,
          corpus_fingerprints=corpus.num_fingerprints,
          alpha_cuts=alpha_cuts)
    return launches, url


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
    from tvidz_tpu_torch._reference import Config, Store, fakes, write_synthetic_y4m
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
    launches = {k.name: k.launches for k in backend.KERNELS}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the service path never launched: {launches}")
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
        search_video_s=video_s, dispatcher=disp,
        stage_timings=metrics["stage_timings"],
        sync_bytes=metrics["corpus_footprint"]["sync_bytes"])
    return launches


def time_analyze(work: str, url: str) -> dict:
    """End-to-end frames/s of one 1024-frame analyze (decode included) on a
    fresh session, with the analyzer's stage times; then a second fresh
    upload analyzed under torch.profiler for the device's busy time and
    idle share (tracing off for the frames/s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tvidz_tpu_torch import cli
    from tvidz_tpu_torch._reference import write_synthetic_y4m

    n = 1024
    paths = []
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    # The analyzer's per-step log lines would bury the phase lines.
    os.environ.setdefault("TVIDZ_LOG_LEVEL", "WARNING")
    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.ops import align, fused, hamming, phash

    smi = nvidia_smi()
    dev = backend.resolve_device("cuda")
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], card=smi,
          device_count=torch.cuda.device_count())

    t0 = time.perf_counter()
    backend.build_all()
    ptxas = [ln.strip() for k in backend.KERNELS for ln in k.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", seconds=time.perf_counter() - t0,
          kernels=[k.repo_source for k in backend.KERNELS], ptxas=ptxas)

    k1_err = check_fingerprint_block(dev)
    k2_err = check_corpus_scan(dev)
    k3_err = check_fragment_search(dev)

    work = tempfile.mkdtemp(prefix="tvidz_chip_smoke_")
    os.environ["TVIDZ_TMP_DIR"] = os.path.join(work, "tmp")
    os.makedirs(os.environ["TVIDZ_TMP_DIR"])
    try:
        cli_launches, url = drive_main_path(work)
        launches = drive_service(work, url, smi)

        left, right = phash.hash_operators(HEIGHT, WIDTH, dev)
        x = torch.randint(0, 256, (FRAMES, HEIGHT, WIDTH), dtype=torch.uint8,
                          device=dev)
        carry = fused.initial_fingerprint_carry(HEIGHT, WIDTH, dev)
        k1 = lambda: fused.fingerprint_block(x, carry, left, right)  # noqa: E731
        k1_plain = lambda: fused.fingerprint_block_plain(  # noqa: E731
            x, carry, left, right)
        k1_ms, k1_plain_ms = interleaved_ms(k1, k1_plain, 20)
        q, corpus = scan_inputs(dev)
        k2 = lambda: hamming.corpus_query_nearest(q, corpus)  # noqa: E731
        k2_plain = lambda: hamming.corpus_min_distance_plain(  # noqa: E731
            q, corpus, False)
        k2_ms, k2_plain_ms = interleaved_ms(k2, k2_plain, 10)
        k3_times = {}
        for name, shape in (("a", FRAG_A), ("b", FRAG_B)):
            (qs, ql, c, ln), _ = fragment_inputs(dev, shape, SEED + 3)
            k3 = lambda: align.fragment_search_batch(qs, ql, c, ln, FRAG_THR)  # noqa: E731
            k3_plain = lambda: align.fragment_search_batch_plain(  # noqa: E731
                qs, ql, c, ln, FRAG_THR)
            ms, plain_ms = interleaved_ms(k3, k3_plain, 3)
            k3_times[name] = {"ms": ms, "plain_ms": plain_ms,
                              "device_ms": device_ms(k3, 10),
                              "plain_device_ms": device_ms(k3_plain, 2)}
        phase("timings", card=smi, k1_ms=k1_ms, k1_plain_ms=k1_plain_ms,
              k1_device_ms=device_ms(k1, 20),
              k1_plain_device_ms=device_ms(k1_plain, 20),
              k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
              k2_device_ms=device_ms(k2, 10),
              k2_plain_device_ms=device_ms(k2_plain, 3),
              k2_shape=[SCAN_M, SCAN_N], k3=k3_times,
              cli_launches=cli_launches, **time_analyze(work, url))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    print(json.dumps({"kernels": [
        {"name": fused.K1.name, "route": "cuda", "source": fused.K1.repo_source,
         "replaces": fused.K1.replaces, "launches": launches[fused.K1.name],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": hamming.K2.name, "route": "cuda",
         "source": hamming.K2.repo_source, "replaces": hamming.K2.replaces,
         "launches": launches[hamming.K2.name], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": align.K3.name, "route": "cuda",
         "source": align.K3.repo_source, "replaces": align.K3.replaces,
         "launches": launches[align.K3.name], "max_abs_err": k3_err,
         "ms": k3_times["a"]["ms"], "plain_ms": k3_times["a"]["plain_ms"]},
    ]}))
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
