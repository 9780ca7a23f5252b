"""Multi-host sustained-ingest soak: the collective op log stays bounded
under load.

Port of ``scripts/soak_multihost.py``. Two served ranks of one
``torch.distributed`` group (``service/integration_multihost.py``'s
``spawn_ranks``, both ``--mesh``) share one sqlite store in the run's own
directory. Ingest payloads ride inline in the op log's rows, so an
unbounded log is an unbounded durable store: watermark heartbeats and
min-member pruning must reclaim applied rows as fast as ingest adds them.
The soak checks that:

- N videos are ingested one after another, alternating webhook hosts, and
  every 4th is a byte copy that must name exactly its original (no original
  is called a duplicate);
- the op log's row count, sampled from host 0's ``/metrics`` through the
  whole run, stays at most 64 (a few ingests' worth, not O(N)), and the
  final log is pruned to the live floor with no watermark lag;
- no lag alarm fires in the healthy cluster;
- the timestamp index grew online past its warm capacity of 8;
- both hosts agree on the corpus.

    python -m tvidz_tpu_torch.service.soak_multihost [--device cuda|cpu] [--videos N]

On one card both ranks run on cuda:0 over gloo; CPU ranks take one thread
each and ``[cpu] * 4`` cells. The last line printed is one JSON object (the
rate, the op log's largest sampled and final row counts, each rank's op
wall times and kernel launches since it became ready); exit 0 when every
check passed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

from tvidz_tpu_torch.service.integration_multihost import (
    free_port,
    http,
    spawn_ranks,
    stop_ranks,
    wait_ranks_healthy,
)

VIDEOS = 12
FRAMES, HEIGHT, WIDTH = 120, 160, 240
TS_CAPACITY = 8
# The bound: each ingest is a handful of ops (upsert_timestamps and the
# per-block append_fingerprints bursts). With 2 s pruning the live tail
# stays at a few ingests' worth; 64 is about 4 ingests of headroom, and an
# unpruned log passes it by video 6 (more than 15 ops a video).
MAX_ROWS = 64
RANK_ENV = {
    # Tiny warm capacities: a 12-video soak crosses them, so the bound is
    # shown through online growth too.
    "TVIDZ_MH_TS_CAPACITY": str(TS_CAPACITY),
    "TVIDZ_MH_FP_CAPACITY": "2048",
    "TVIDZ_MH_AL_TCAP": "256",
    "TVIDZ_EARLY_EXIT": "0",
    # The hygiene cadence scaled to the soak's length: prune every 2 s,
    # heartbeat every 1 s. The bound holds only because pruning keeps up
    # with ingest.
    "TVIDZ_MH_PRUNE_INTERVAL_S": "2",
    "TVIDZ_MH_WM_INTERVAL_S": "1",
    "TVIDZ_MH_LAG_ALARM_OPS": str(MAX_ROWS),
}


def upload_plan(n_videos: int):
    """[(upload i, clip seed, the original it must name or None)]: every
    4th upload is a byte copy of upload i-3's clip."""
    plan = []
    for i in range(n_videos):
        if i % 4 == 3:
            plan.append((i, (i - 3) // 4 * 4 + 100, f"soak{i - 3}.y4m"))
        else:
            plan.append((i, (i // 4) * 4 + (i % 4) + 100, None))
    return plan


def write_clip(workdir: str, seed: int) -> str:
    """The Y4M clip of ``seed``. Its cut positions vary with the seed:
    timestamp dedup is exact equality, so only byte copies may match
    (shared cut frames would make every video a duplicate of every other
    and the verdict checks vacuous)."""
    from tvidz_tpu_torch.decode.synthetic import synthetic_video
    from tvidz_tpu_torch.decode.y4m import write_y4m

    path = os.path.join(workdir, f"src{seed}.y4m")
    if not os.path.exists(path):
        cuts = (24 + (seed % 7) * 3, 68 + (seed % 11) * 4)
        luma, _ = synthetic_video(num_frames=FRAMES, height=HEIGHT,
                                  width=WIDTH, cut_frames=cuts, seed=seed)
        write_y4m(path, luma, fps=25.0)
    return path


class OplogSampler:
    """The op log's row count and watermark lag as ``/metrics``'
    ``collective_oplog`` reports them, sampled through a run, and the
    reference's checks on them."""

    def __init__(self):
        self.max_rows = 0
        self.max_lag = 0
        self.samples = 0

    def observe(self, oplog: dict) -> None:
        self.max_rows = max(self.max_rows, int(oplog.get("rows", 0)))
        self.max_lag = max(self.max_lag, int(oplog.get("lag_ops", 0)))
        self.samples += 1

    def checks(self, final: dict):
        """[(name, passed, detail)] against the run's samples and the log
        as ``final`` reports it once the pruners have caught up."""
        return [
            (f"op-log rows bounded throughout (max {self.max_rows})",
             0 < self.max_rows <= MAX_ROWS,
             f"max sampled rows {self.max_rows} over {self.samples} samples"),
            ("final log pruned to the live floor",
             final.get("rows", 99) <= 2 and final.get("lag_ops", 99) == 0,
             final),
            ("no lag alarm during healthy soak",
             final.get("lag_alarm") is False, final),
        ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default, or $TVIDZ_TORCH_DEVICE) or cpu")
    ap.add_argument("--videos", type=int, default=VIDEOS,
                    help="uploads, alternating the two hosts")
    args = ap.parse_args(argv)
    from tvidz_tpu_torch import backend

    # Raises without a card unless the CPU was asked for.
    device = backend.resolve_device(args.device).type
    # Mesh cells per rank: [cpu] * 4 (the reference's 4 virtual devices a
    # host), or the rank's card.
    cells = 4 if device == "cpu" else 1
    n_videos = args.videos

    from tvidz_tpu_torch.corpus.store import Store

    workdir = tempfile.mkdtemp(prefix="tvidz-mhsoak-")
    bucket_dir = os.path.join(workdir, "s3", "videos")
    os.makedirs(bucket_dir)
    db_url = f"sqlite:///{os.path.join(workdir, 'shared.db')}"
    # The schema before the ranks open it: two ranks opening a fresh file
    # together hit "database is locked".
    Store(db_url).close()
    ports = (free_port(), free_port())
    bases = [f"http://127.0.0.1:{p}" for p in ports]
    failures: list = []
    summary = {"device": device, "videos": n_videos, "cells": cells}

    def check(name, cond, detail=""):
        print(f"[mh-soak] {'PASS' if cond else 'FAIL'}: {name} "
              f"{str(detail)[:600] if not cond else ''}", flush=True)
        if not cond:
            failures.append(name)

    def oplog(i, timeout=10):
        _, body = http("GET", f"{bases[i]}/metrics", timeout=timeout)
        return (body or {}).get("collective_oplog", {})

    sampler = OplogSampler()
    stop_sampling = threading.Event()

    def sample():
        # Through the whole run, so bursts between uploads are seen too.
        while not stop_sampling.is_set():
            o = oplog(0, timeout=5)
            if o:
                sampler.observe(o)
            stop_sampling.wait(0.5)

    t_boot = time.perf_counter()
    servers, logs = spawn_ranks(ports, free_port(), workdir, db_url, device,
                                cells, RANK_ENV)
    try:
        ready = wait_ranks_healthy(bases, servers)
        summary["boot_s"] = time.perf_counter() - t_boot
        check("both hosts healthy", ready)
        if not ready:
            raise TimeoutError("hosts never became healthy")
        sampler_thread = threading.Thread(target=sample, daemon=True)
        sampler_thread.start()

        t0 = time.perf_counter()
        for i, seed, original in upload_plan(n_videos):
            host = i % 2
            key = f"17557{i:08d}-soak{i}.y4m"
            shutil.copy(write_clip(workdir, seed), os.path.join(bucket_dir, key))
            status, _ = http("POST", f"{bases[host]}/notify", {
                "Records": [{"s3": {"bucket": {"name": "videos"},
                                    "object": {"key": key}}}]})
            check(f"soak{i} delivered (host {host})", status == 200, status)
            last = {}
            end = time.time() + 300
            while time.time() < end:
                _, body = http("GET", f"{bases[host]}/status/soak{i}.y4m",
                               timeout=5)
                if body:
                    last = body
                    if last.get("status") in ("done", "error"):
                        break
                time.sleep(0.25)
            check(f"soak{i} done", last.get("status") == "done", last)
            if original:
                check(f"soak{i} names exactly its original",
                      last.get("duplicates") == [original], last)
            else:
                check(f"soak{i} is no duplicate",
                      last.get("duplicates") in ([], None), last)
        elapsed = time.perf_counter() - t0
        summary.update(seconds=elapsed, videos_per_s=n_videos / elapsed)
        print(f"[mh-soak] {n_videos} videos in {elapsed:.1f} s "
              f"({n_videos / elapsed:.2f}/s sustained, 2 hosts)", flush=True)

        # Let the pruners catch up, then stop sampling.
        time.sleep(6.0)
        stop_sampling.set()
        sampler_thread.join(timeout=5)
        final = oplog(0)
        for name, cond, detail in sampler.checks(final):
            check(name, cond, detail)
        _, health = http("GET", f"{bases[0]}/healthz")
        live = (health or {}).get("corpus_videos", 0)
        check(f"growth happened ({live} live videos past warm ts capacity "
              f"{TS_CAPACITY})", live > TS_CAPACITY, f"corpus_videos={live}")

        def n_vids(base):
            _, p = http("GET", f"{base}/debug/videos")
            return len(p) if isinstance(p, list) else len((p or {}).get("videos", []))

        seen = [n_vids(b) for b in bases]
        check("hosts agree on corpus size", seen == [n_videos] * 2, seen)
        summary.update(oplog_max_rows=sampler.max_rows,
                       oplog_max_lag_ops=sampler.max_lag,
                       oplog_samples=sampler.samples,
                       oplog_final_rows=final.get("rows"),
                       oplog_final=final, corpus_videos=live)
        ranks = []
        for base in bases:
            _, m = http("GET", f"{base}/metrics", timeout=10)
            m = m or {}
            ranks.append({
                "op_wall_ms": m.get("collective_oplog", {}).get("op_wall_ms"),
                "kernel_launches": m.get("kernel_launches"),
                "corpus_fingerprints": m.get("corpus_fingerprints")})
        summary["ranks"] = ranks
    except TimeoutError:
        pass
    finally:
        stop_sampling.set()
        stop_ranks(servers)
        for lf in logs:
            lf.close()
        if failures:
            for pid in range(2):
                path = os.path.join(workdir, f"host{pid}.log")
                if os.path.exists(path):
                    with open(path) as f:
                        tail = f.read().splitlines()[-40:]
                    print(f"---- host{pid}.log tail ----")
                    print("\n".join(tail))
        shutil.rmtree(workdir, ignore_errors=True)

    print(f"[mh-soak] FAILED: {failures}" if failures
          else "[mh-soak] ALL CHECKS PASSED")
    print(json.dumps({"ok": not failures, "failures": failures, **summary}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
