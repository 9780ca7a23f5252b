"""Multi-process dryrun of the corpus sharded across ranks.

Port of ``scripts/dryrun_multihost.py``. The parent spawns N rank
processes (default 2) joined by ``torch.distributed`` on this machine; each
rank builds the global mesh with the corpus axis host-major over its
``--cells`` local cells of ``--device``, places only its own row range and
runs the sharded searches whose evidence merges cross the rank boundary:
the reference script's checks (timestamps, nearest, appends sourced by
each rank in turn, churn with a compaction), plus ``search_fingerprints``,
``fragment_search`` and ``fragment_search_batch``. Each rank writes its
results and its kernel launch counts to ``--out``; the parent checks that
every rank's results are identical.

``--large`` runs, in place of that scenario, a 2^24-row fingerprint index
(128 MiB at 2 words) over 4096 videos and 2^16 timestamp rows, with copies
planted on both sides of the rank boundary and of each rank's shard edges.
The parent writes the rows once to ``--out`` for the ranks to load, and
while they run it asks a single-device ``DeviceCorpus`` of the same rows
the same questions, and asks again for the evidence and the fragment with
the scans on their plain versions; every rank's answers must equal both
(first-index ties included). On CUDA ranks the large queries are timed
(per-call wall and torch.profiler device time).

    python -m tvidz_tpu_torch.parallel.dryrun [--processes N]
        [--device cuda|cpu] [--cells N] [--large] [--out DIR]

The device is the card unless ``--device cpu`` is given (it raises without
one); ``--cells`` defaults to 1 on the card and 4 on the CPU (the
reference's four virtual devices a host). CUDA ranks share one card over
gloo (NCCL refuses two ranks on one device); ``--one-card-per-rank`` gives
rank i card i alone (``CUDA_VISIBLE_DEVICES``) and NCCL. The last line
printed is one JSON object; exit 0 when every rank verified identical,
correct results.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
LARGE_FP_VIDEOS, LARGE_FP_FRAMES = 4096, 4096      # 2^24 fingerprint rows
LARGE_TS_ROWS = 1 << 16
LARGE_FILE = "large_rows.npz"       # written by the parent, read by the ranks


class RowsStore:
    """The two reads ``refresh_from_store`` and ``DeviceCorpus.load`` make
    of a store, over rows held in memory."""

    def __init__(self, ts, fps):
        self.ts, self.fps = ts, fps

    def all_timestamps(self):
        return list(self.ts)

    def all_fingerprints(self):
        return list(self.fps)


def _nn(rows):
    return [[list(t) for t in per] for per in rows]


def small_scenario(make_corpus, rank: int, world: int) -> dict:
    """The reference dryrun's ops and checks on ``make_corpus(**kw)`` (a
    MultiHostShardedCorpus of either package), with rank ``r`` sourcing the
    appends the reference's process ``r % world`` sources. Returns every
    result (lists), identical on every rank."""
    corpus = make_corpus(max_cuts=16, hamming_threshold=5)
    out = {}

    def payload(src, x):
        return x if rank == src else None

    # Every rank derives the same global corpus (the shared-store model)...
    rng = np.random.default_rng(SEED)
    rows = [sorted(rng.uniform(0, 100, size=5).round(2).tolist())
            for _ in range(20)]
    rows[13] = [1.25, 7.5, 42.0, 77.0]
    corpus.load_timestamps(rows, list(range(100, 120)), min_rows=64)
    fps = rng.integers(0, 2**32, size=(1000, 2), dtype=np.uint32)
    fp_vids = np.repeat(np.arange(100, 120, dtype=np.int32), 50)
    corpus.load_fingerprints(fps, fp_vids, min_rows=4096)

    # ...and every rank gets the same replicated verdicts back, with the
    # evidence merge crossing the rank boundary.
    hits = corpus.match_timestamps([1.25, 42.0, 77.0, 99.0], min_match=2)
    assert hits == [(113, 3)], f"rank {rank}: {hits}"
    q = fps[650:658]          # frames of video 113
    nn = corpus.nearest_fingerprints(q, k=3)
    assert len(nn) == 8
    for m in range(8):
        d0, idx0, vid0 = nn[m][0]
        assert d0 == 0 and idx0 == 650 + m and vid0 == 113, (m, nn[m])
    out["ts"], out["nearest"] = hits, _nn(nn)
    out["evidence"] = corpus.search_fingerprints(
        np.concatenate([q, fps[:3]]), min_match=1)
    assert out["evidence"][0] == (113, 8), out["evidence"]

    # Streaming ingest: each rank in turn plays the analyzing process; only
    # the payload crosses ranks.
    src1 = 1 % world
    new_fp0 = rng.integers(1, 2**32 - 1, size=(40, 2), dtype=np.uint32)
    corpus.append_video(500, ts=payload(0, [3.5, 8.25, 60.0]),
                        fps=payload(0, new_fp0), n_ts=3, n_fp=40, src_process=0)
    new_fp1 = rng.integers(1, 2**32 - 1, size=(24, 2), dtype=np.uint32)
    corpus.append_video(501, ts=payload(src1, [9.75, 14.5]),
                        fps=payload(src1, new_fp1), n_ts=2, n_fp=24,
                        src_process=src1)
    hits2 = corpus.match_timestamps([3.5, 60.0], min_match=2)
    assert hits2 == [(500, 2)], f"rank {rank}: {hits2}"
    hits3 = corpus.match_timestamps([9.75, 14.5], min_match=2)
    assert hits3 == [(501, 2)], f"rank {rank}: {hits3}"
    # Every rank drew the same rng stream, so each verifies both payloads.
    out["appended"] = []
    for q_new, vid in ((new_fp0[:4], 500), (new_fp1[:4], 501)):
        nn2 = corpus.nearest_fingerprints(q_new, k=1)
        for m in range(4):
            d0, _, vid0 = nn2[m][0]
            assert d0 == 0 and vid0 == vid, (m, vid, nn2[m])
        out["appended"].append(_nn(nn2))
    out["fragment"] = corpus.fragment_search(new_fp0[5:35], top_k=2)
    assert out["fragment"][0] == (500, 5, 30), out["fragment"]

    # Churn across the rank boundary: tombstoned ts/al slots are reused by
    # the next claim, and a full fingerprint tail with tombstones triggers
    # the compaction on every rank at the same op.
    churn = make_corpus(max_cuts=16, hamming_threshold=5, al_tcap=64)
    churn.load_timestamps([], [], min_rows=8)
    churn.load_fingerprints(
        np.zeros((0, 2), np.uint32), np.zeros(0, np.int32), min_rows=256)
    cap = churn._inner.corpus_fp.shape[0]
    per = 128
    vids_fps = {}
    for i in range(cap // per):
        vf = rng.integers(1, 2**32 - 1, size=(per, 2), dtype=np.uint32)
        vids_fps[600 + i] = vf
        src = i % world
        churn.append_video(600 + i, ts=payload(src, [1.0 + i, 2.0 + i]),
                           fps=payload(src, vf), n_ts=2, n_fp=per,
                           src_process=src)
    assert churn._fp_count == cap
    churn.remove_video(600)
    ts_rows, al_rows = churn._ts_rows, churn._al_rows
    vf_new = rng.integers(1, 2**32 - 1, size=(per, 2), dtype=np.uint32)
    churn.append_video(777, ts=payload(0, [50.0, 60.0]), fps=payload(0, vf_new),
                       n_ts=2, n_fp=per, src_process=0)
    assert churn.fp_compactions == 1, churn.fp_compactions
    assert churn._fp_count == cap
    assert (churn._ts_rows, churn._al_rows) == (ts_rows, al_rows)
    assert churn.match_timestamps([50.0, 60.0], min_match=2) == [(777, 2)]
    assert churn.match_timestamps([1.0, 2.0], min_match=2) == []
    nn3 = churn.nearest_fingerprints(vf_new[:4], k=1)
    assert all(nn3[m][0][0] == 0 and nn3[m][0][2] == 777 for m in range(4))
    survivor = 601
    nn4 = churn.nearest_fingerprints(vids_fps[survivor][:4], k=1)
    assert all(nn4[m][0][0] == 0 and nn4[m][0][2] == survivor
               for m in range(4)), nn4
    fh = churn.fragment_search(vf_new[30:62], top_k=2)
    assert fh and fh[0][:2] == (777, 30), fh
    out["churn"] = {"nearest": _nn(nn3) + _nn(nn4), "fragment": fh,
                    "compactions": churn.fp_compactions}
    out["fragments"] = churn.fragment_search_batch(
        [vf_new[30:62], vids_fps[survivor][:40], vids_fps[600][:16]], top_k=2)
    assert out["fragments"][0][0][:2] == (777, 30)
    assert out["fragments"][1][0][:2] == (survivor, 0)
    assert all(h[0] != 600 for h in out["fragments"][2])   # removed
    return out


def make_large_rows(world: int, shards_per_rank: int) -> dict:
    """The large scenario's store rows as arrays (seeded): 2^24 fingerprint
    rows with copies planted on both sides of every shard edge (the rank
    boundary, row 2^23 for two ranks, among them), two videos astride the
    rank boundary sharing frames 1..300, and 2^16 timestamp rows of 4..39
    distinct sorted cuts each (two equal rows astride row 2^15)."""
    rng = np.random.default_rng(SEED + 1)
    n_fp = LARGE_FP_VIDEOS * LARGE_FP_FRAMES
    fp = rng.integers(0, 2**32, size=(n_fp, 2), dtype=np.uint32)
    edges = np.array([n_fp * j // (world * shards_per_rank)
                      for j in range(1, world * shards_per_rank)], np.int64)
    planted = rng.integers(0, 2**32, size=(len(edges), 2), dtype=np.uint32)
    fp[edges - 1] = fp[edges] = planted
    v_hi = LARGE_FP_VIDEOS // 2          # first video of the upper half
    lo_start, hi_start = (v_hi - 1) * LARGE_FP_FRAMES, v_hi * LARGE_FP_FRAMES
    fp[lo_start + 1:lo_start + 301] = fp[hi_start + 1:hi_start + 301]
    # Distinct sorted frame indices below 15000 (39 steps of at most 375),
    # off the 1/25 s grid: no filler cut equals a planted one.
    n_cuts = rng.integers(4, 40, size=LARGE_TS_ROWS)
    frames = np.cumsum(rng.integers(1, 376, size=(LARGE_TS_ROWS, 39)), axis=1)
    return {"fp": fp, "edges": edges, "n_cuts": n_cuts,
            "ts": np.round(frames * 0.04 + 0.013, 6)}


def large_case(rows: dict):
    """(the store over ``make_large_rows``' arrays, the queries)."""
    fp, edges = rows["fp"], rows["edges"]
    fps = [(v + 1, fp[v * LARGE_FP_FRAMES:(v + 1) * LARGE_FP_FRAMES])
           for v in range(LARGE_FP_VIDEOS)]
    ts = [(i + 1, row[:n].tolist())
          for i, (row, n) in enumerate(zip(rows["ts"], rows["n_cuts"]))]
    cuts = [1234.5, 1240.25, 1300.75]
    b = LARGE_TS_ROWS // 2
    ts[b - 1] = (b, list(cuts))
    ts[b] = (b + 1, list(cuts))
    hi_start = LARGE_FP_VIDEOS // 2 * LARGE_FP_FRAMES
    q = np.concatenate([fp[edges], fp[5 * LARGE_FP_FRAMES:5 * LARGE_FP_FRAMES
                                      + 128 - len(edges)]])
    frags = [fp[hi_start + 1:hi_start + 301],
             fp[4 * LARGE_FP_FRAMES + 100:4 * LARGE_FP_FRAMES + 400],
             fp[(LARGE_FP_VIDEOS - 1) * LARGE_FP_FRAMES:
                (LARGE_FP_VIDEOS - 1) * LARGE_FP_FRAMES + 64]]
    return RowsStore(ts, fps), {"cuts": cuts, "q": q, "frags": frags,
                                "edges": edges.tolist()}


def large_queries(corpus, qs) -> dict:
    """The large scenario's answers from a MultiHostShardedCorpus."""
    nn = corpus.nearest_fingerprints(qs["q"], k=4)
    return {
        "ts": corpus.match_timestamps(qs["cuts"], min_match=2),
        "evidence": corpus.search_fingerprints(qs["q"], min_match=1),
        "nearest": _nn(nn),
        "fragment": corpus.fragment_search(qs["frags"][0], top_k=3),
        "fragments": corpus.fragment_search_batch(qs["frags"], top_k=3),
    }


def single_device_answers(store: RowsStore, qs, device) -> dict:
    """The same questions to a single-device DeviceCorpus of the same rows,
    in the large scenario's terms (its nearest as (min, first argmin)); and
    ``evidence`` and ``fragment`` again with the scans on their plain
    versions (``plain_evidence``, ``plain_fragment``)."""
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
    from tvidz_tpu_torch.ops import align, hamming

    class PlainScans(DeviceCorpus):
        """K4 ``frame_min`` and K3 replaced by their plain versions."""

        def _frame_min(self, q, fp_dev):
            return hamming.corpus_scan_pm1_plain(
                self._to_device(q), fp_dev, "frame_min")[0]

        def _fragment_query(self, q, q_lens, al_dev, len_dev, thr):
            return align.fragment_search_batch_plain(q, q_lens, al_dev,
                                                     len_dev, thr)

    dc = DeviceCorpus(hamming_threshold=5, device=device)
    dc.load(store)
    dc._sync_fp()
    q_min, q_arg = dc._query_nearest(dc._padded_queries(qs["q"]), dc._fp_dev)
    m = qs["q"].shape[0]
    out = {
        "ts": dc.match_timestamps(qs["cuts"], min_match=2),
        "evidence": dc.search_fingerprints(qs["q"], min_match=1),
        "nearest1": [[int(d), int(i)] for d, i in
                     zip(q_min[:m].cpu().tolist(), q_arg[:m].cpu().tolist())],
        "fragment": dc.locate_fragment(qs["frags"][0], top_k=3),
        "fragments": dc.locate_fragments(qs["frags"], top_k=3),
    }
    del dc
    plain = PlainScans(hamming_threshold=5, device=device)
    plain.load(store)
    out["plain_evidence"] = plain.search_fingerprints(qs["q"], min_match=1)
    out["plain_fragment"] = plain.locate_fragment(qs["frags"][0], top_k=3)
    return out


def _timed(fn, reps: int, device) -> dict:
    """Per-call wall ms of ``fn`` (a collective: every rank calls it as
    often) and, on CUDA, the device ms per call of each kernel and copy,
    from one torch.profiler window after a warm-up one."""
    import torch

    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wall = (time.perf_counter() - t0) / reps * 1e3
    if device.type != "cuda":
        return {"wall_ms": wall}
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    dev = {e.key[:60]: e.self_device_time_total / reps / 1e3
           for e in prof.key_averages() if e.self_device_time_total > 0}
    return {"wall_ms": wall, "device_ms": dev}


def child(rank: int, world: int, port: int, device: str, cells: int,
          large: bool, out_dir: str) -> int:
    import torch.distributed as dist

    from tvidz_tpu_torch import backend
    from tvidz_tpu_torch.parallel.distributed import (
        MultiHostShardedCorpus,
        init_distributed,
        make_multihost_mesh,
        process_count,
    )

    os.environ.setdefault("TVIDZ_LOG_LEVEL", "WARNING")
    assert init_distributed(f"127.0.0.1:{port}", world, rank, device=device)
    assert process_count() == world
    dev = backend.resolve_device(device)
    mesh = make_multihost_mesh(local_devices=[dev] * cells)
    print(f"[host {rank}] mesh {dict(mesh.shape)} over {cells} cells of "
          f"{dev}", flush=True)

    def make(**kw):
        return MultiHostShardedCorpus(mesh, **kw)

    if dev.type == "cuda":
        backend.build_all()
    backend.reset_launch_counts()
    results, seconds, timings = {}, {}, {}
    t0 = time.perf_counter()
    if large:
        with np.load(os.path.join(out_dir, LARGE_FILE)) as f:
            store, qs = large_case(dict(f))
        corpus = make(hamming_threshold=5, al_tcap=LARGE_FP_FRAMES)
        corpus.refresh_from_store(store)
        seconds["large_warm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results["large"] = large_queries(corpus, qs)
        seconds["large_queries"] = time.perf_counter() - t0
    else:
        results["small"] = small_scenario(make, rank, world)
        seconds["small"] = time.perf_counter() - t0
    # The scenario's launches; the timing repeats below are not counted.
    launches = {k.name: k.launches for k in backend.KERNELS}
    if large and dev.type == "cuda":
        timings = {
            "search_fingerprints": _timed(
                lambda: corpus.search_fingerprints(qs["q"]), 5, dev),
            "fragment_search": _timed(
                lambda: corpus.fragment_search(qs["frags"][0], top_k=3), 5, dev),
        }
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"results": results, "launches": launches,
                   "seconds": seconds, "timings": timings,
                   "mesh": dict(mesh.shape)}, f)
    print(f"[host {rank}] OK: sharded search verified (launches {launches})",
          flush=True)
    dist.destroy_process_group()
    return 0


def _canon(x):
    """JSON round trip: tuples and lists compare alike."""
    return json.loads(json.dumps(x))


def parent(world: int, device: str, cells: int, large: bool,
           out_dir: str = None, timeout_s: float = 600.0,
           one_card_per_rank: bool = False) -> dict:
    """Run the ranks; returns the summary (``ok`` and what failed). With
    ``large`` this process writes the rows the ranks load, and computes the
    single-device answers while they run."""
    from tvidz_tpu_torch import backend

    dev = backend.resolve_device(device)
    device = dev.type
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = out_dir or tempfile.mkdtemp(prefix="tvidz-dryrun-")
    os.makedirs(out_dir, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if device == "cuda" and not one_card_per_rank:
        env.setdefault("TVIDZ_DIST_BACKEND", "gloo")
    elif device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")   # the ranks share the cores
    t_start = time.perf_counter()
    steps = {}
    if large:
        # The local mesh's corpus axis: the largest power of two dividing
        # the cells (make_multihost_mesh).
        rows = make_large_rows(world, cells & -cells)
        large_path = os.path.join(out_dir, LARGE_FILE)
        np.savez(large_path, **rows)
        steps["rows"] = time.perf_counter() - t_start
    # Rank output goes to files: a rank blocked on a full pipe would stall
    # its peers inside a collective.
    logs = [open(os.path.join(out_dir, f"rank{i}.log"), "w+") for i in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tvidz_tpu_torch.parallel.dryrun", "--child",
         str(i), str(world), str(port), "--device", device, "--cells",
         str(cells), "--out", out_dir] + (["--large"] if large else []),
        env=dict(env, CUDA_VISIBLE_DEVICES=str(i)) if one_card_per_rank else env,
        cwd=root, stdout=logs[i], stderr=subprocess.STDOUT)
        for i in range(world)]
    failures, want = [], None
    if large:
        t0 = time.perf_counter()
        store, qs = large_case(rows)
        try:
            want = _canon(single_device_answers(store, qs, dev))
        except Exception as e:   # reported, after the ranks are reaped
            failures.append(f"single device: {e!r}")
        steps["single_device"] = time.perf_counter() - t0
        del store, rows
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout_s
    for i, p in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            failures.append(f"rank {i} timed out")
    steps["ranks_after"] = time.perf_counter() - t0
    for i, p in enumerate(procs):
        if p.poll() is None:
            p.kill()
            p.wait()
        logs[i].seek(0)
        out = logs[i].read()
        logs[i].close()
        sys.stderr.write(out)
        if p.returncode != 0 or f"[host {i}] OK" not in out:
            failures.append(f"rank {i} exited {p.returncode}")
    if large:
        os.remove(large_path)
    summary = {"ok": False, "ranks": world, "device": device, "cells": cells,
               "backend": ("nccl" if one_card_per_rank
                           else env.get("TVIDZ_DIST_BACKEND", "gloo")),
               "seconds": time.perf_counter() - t_start,
               "parent_seconds": steps, "failures": failures}
    if failures:
        return summary
    ranks = []
    for i in range(world):
        with open(os.path.join(out_dir, f"rank{i}.json")) as f:
            ranks.append(json.load(f))
    summary.update(mesh=ranks[0]["mesh"],
                   launches=[r["launches"] for r in ranks],
                   rank_seconds=[r["seconds"] for r in ranks],
                   timings=[r["timings"] for r in ranks])
    for i, r in enumerate(ranks[1:], 1):
        if r["results"] != ranks[0]["results"]:
            failures.append(f"rank {i}'s results differ from rank 0's")
    if large and not failures:
        got = ranks[0]["results"]["large"]
        got["nearest1"] = [per[0][:2] for per in got["nearest"]]
        got["plain_evidence"] = got["evidence"]
        got["plain_fragment"] = got["fragment"]
        for key in want:
            if got[key] != want[key]:
                failures.append(f"large {key}: ranks {str(got[key])[:200]} != "
                                f"single device {str(want[key])[:200]}")
        edges = qs["edges"]
        firsts = [per[0][1] for per in got["nearest"][:len(edges)]]
        if firsts != [e - 1 for e in edges]:
            failures.append(f"edge ties resolved to {firsts}, not {edges}")
        summary["edges"] = edges
    summary["ok"] = not failures
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (default, or $TVIDZ_TORCH_DEVICE) or cpu")
    ap.add_argument("--cells", type=int, default=None,
                    help="mesh cells per rank, each on the rank's device "
                         "(default 1 on cuda, 4 on cpu)")
    ap.add_argument("--large", action="store_true",
                    help="the 2^24-row scenario, checked against DeviceCorpus, "
                         "in place of the small one")
    ap.add_argument("--out", default=None, help="directory for rank results")
    ap.add_argument("--one-card-per-rank", action="store_true",
                    help="rank i on CUDA card i alone, over NCCL")
    ap.add_argument("--child", nargs=3, type=int, metavar=("RANK", "WORLD", "PORT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from tvidz_tpu_torch import backend

    device = backend.resolve_device(args.device).type
    cells = args.cells or (4 if device == "cpu" else 1)
    if args.child:
        rank, world, port = args.child
        return child(rank, world, port, device, cells, args.large, args.out)
    summary = parent(args.processes, device, cells, args.large, args.out,
                     one_card_per_rank=args.one_card_per_rank)
    print("dryrun_multihost " + (
        f"OK: {args.processes}-rank corpus sharding verified" if summary["ok"]
        else f"FAILED: {summary['failures']}"))
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
