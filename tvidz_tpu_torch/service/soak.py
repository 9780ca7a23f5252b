"""Sustained-ingest soak of the port's inspector service over sockets.

Port of ``scripts/soak_test.py``. Beyond the integration's two uploads it
checks that:

- every analysis completes under continuous ingest, 4 uploads in flight;
- duplicate verdicts stay right as the corpus grows: every fifth upload is
  a byte copy of an earlier original and must name it, and no original is
  called a duplicate (the originals' cut windows are disjoint, so no two
  share a cut pair);
- the in-memory analysis registry stays bounded
  (``TVIDZ_MAX_ANALYSIS_RESULTS``, an LRU) and the process's RSS stays flat
  once warm: six more uploads after the main phase cost under 10 MB each;

and reports the sustained rate.

    python -m tvidz_tpu_torch.service.soak [--device cuda|cpu] [--videos N] [--mesh]

``--mesh`` soaks the sharded-corpus service: the entrypoint's ``--mesh
--cells-per-device 8`` (``[cuda:0] * 8`` on the card, ``[cpu] * 8`` on the
CPU), 20 uploads unless ``--videos`` says otherwise, and the server log
must say the corpus was sharded over the 8 cells.

The fake S3 root, the uploads and the server log live in a directory of the
run's own. On the card the service process's device memory
(``nvidia-smi --query-compute-apps``; where that lists no such pid, the
card's used memory less what it was before the service started) is read
beside its RSS, once warm and at the end. The last line printed is one JSON object; exit 0 when every
check passed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

from tvidz_tpu_torch.service.integration import (
    log_tail,
    spawn_service,
    stop_service,
    wait_healthy,
)
from tvidz_tpu_torch.service.integration_multihost import free_port

MAX_RESULTS = 24
FRAMES = 200
IN_FLIGHT = 4
PROBES = 6
VIDEOS, MESH_VIDEOS = 40, 20
MESH_CELLS = 8
# On the CPU every tensor of an analysis is host memory. glibc raises its
# mmap threshold to the largest block freed so far, so later blocks of that
# size stay in the heap of whichever thread's arena took them, and RSS
# swings by tens of MB from upload to upload with nothing leaked. A fixed
# threshold returns every block of 128 KiB or more to the system when it
# is freed: RSS then follows what is live, which the leak check reads.
HOST_TENSOR_MALLOC = {"MALLOC_MMAP_THRESHOLD_": str(128 * 1024)}


def rss_mb(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def device_memory_mib(pid: int, before: float = None) -> dict:
    """The process's device memory as ``nvidia-smi`` lists it (MiB; None
    when it lists no such pid, as in a container with its own pid space),
    the card's whole used memory, and that less ``before`` (the card's
    used memory read before the process started)."""
    def smi(query):
        out = subprocess.run(["nvidia-smi", query,
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return [ln.split(",") for ln in out.stdout.strip().splitlines() if ln]

    try:
        apps = smi("--query-compute-apps=pid,used_memory")
        card = smi("--query-gpu=memory.used")
    except (OSError, subprocess.SubprocessError):
        return {"process_mib": None, "card_used_mib": None,
                "card_used_since_start_mib": None}
    mine = [float(m) for p, m in apps if p.strip() == str(pid)]
    used = float(card[0][0]) if card else None
    return {"process_mib": mine[0] if mine else None, "card_used_mib": used,
            "card_used_since_start_mib": (None if used is None or before is None
                                          else used - before)}


def make_uploads(uploads_dir: str, n_videos: int):
    """The soak's uploads, written into ``uploads_dir``: (names and paths
    in upload order, {copy: the original it must name}, originals). Every
    fifth is a byte copy of an earlier original; the originals' cut windows
    are disjoint, so no two share a cut pair and exact-equality dedup
    cannot rightly cross-fire."""
    import numpy as np

    from tvidz_tpu_torch.decode.synthetic import synthetic_video
    from tvidz_tpu_torch.decode.y4m import write_y4m

    names, expect_dup_of, originals = [], {}, []
    rng = np.random.default_rng(9)
    for i in range(n_videos):
        name = f"soak-{i:03d}.y4m"
        path = os.path.join(uploads_dir, name)
        if i % 5 == 4 and originals:
            src_name, src_path = originals[int(rng.integers(0, len(originals)))]
            shutil.copy(src_path, path)
            expect_dup_of[name] = src_name
        else:
            first = 10 + 4 * len(originals)
            luma, _ = synthetic_video(
                num_frames=FRAMES, height=240, width=320,
                cut_frames=(first, first + 1, first + 2), seed=1000 + i)
            write_y4m(path, luma, fps=25.0)
            originals.append((name, path))
        names.append((name, path))
    return names, expect_dup_of, originals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default, or $TVIDZ_TORCH_DEVICE) or cpu")
    ap.add_argument("--videos", type=int, default=None,
                    help=f"uploads in the main phase ({VIDEOS}; "
                         f"{MESH_VIDEOS} with --mesh)")
    ap.add_argument("--mesh", action="store_true",
                    help=f"the corpus sharded over {MESH_CELLS} cells of the device")
    args = ap.parse_args(argv)
    from tvidz_tpu_torch import backend

    # Raises without a card unless the CPU was asked for.
    device = backend.resolve_device(args.device).type
    n_videos = args.videos or (MESH_VIDEOS if args.mesh else VIDEOS)

    import requests

    # A fake S3 root of the run's own: a shared one would cross-ingest with
    # (and at cleanup delete) a concurrent run's uploads.
    workdir = tempfile.mkdtemp(prefix="tvidz-soak-")
    bucket_dir = os.path.join(workdir, "s3", "videos")
    os.makedirs(bucket_dir)
    uploads_dir = os.path.join(workdir, "uploads")
    os.makedirs(uploads_dir)
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    card_before = (device_memory_mib(-1)["card_used_mib"]
                   if device == "cuda" else None)
    t_boot = time.perf_counter()
    mesh_args = (["--mesh", "--cells-per-device", str(MESH_CELLS)]
                 if args.mesh else [])
    server, log_path = spawn_service(
        ["--fake-aws", *mesh_args, "--db", "sqlite:///:memory:",
         "--port", str(port)],
        workdir, device,
        {"TVIDZ_MAX_ANALYSIS_RESULTS": str(MAX_RESULTS),
         # The mesh check reads the entrypoint's INFO line.
         "TVIDZ_LOG_LEVEL": "INFO" if args.mesh else "WARNING",
         **(HOST_TENSOR_MALLOC if device == "cpu" else {})})
    failures: list = []
    summary = {"device": device, "videos": n_videos, "mesh": args.mesh,
               "in_flight": IN_FLIGHT, "frames_per_video": FRAMES}

    def check(name, cond, detail=""):
        print(f"[soak] {'PASS' if cond else 'FAIL'}: {name} "
              f"{str(detail)[:600]}", flush=True)
        if not cond:
            failures.append(name)

    def memory(tag):
        summary[f"rss_mb_{tag}"] = rss_mb(server.pid)
        if device == "cuda":
            summary[f"device_memory_{tag}"] = device_memory_mib(server.pid,
                                                                card_before)

    try:
        # The uploads, built while the service boots.
        names, expect_dup_of, originals = make_uploads(uploads_dir, n_videos)
        wait_healthy(base, server)
        summary["boot_s"] = time.perf_counter() - t_boot
        if args.mesh:
            check(f"corpus sharded over the {MESH_CELLS} cells",
                  f"corpus sharded over {MESH_CELLS} devices"
                  in log_tail(log_path, 400))
        memory("warm")

        sem = threading.Semaphore(IN_FLIGHT)
        errors: list = []
        results: dict = {}

        def upload(name, path):
            # A copy must not race its original: with both in flight, the
            # original's cuts may not be committed when the copy scans.
            want = expect_dup_of.get(name)
            if want is not None:
                wait_until = time.time() + 300
                while want not in results:
                    if time.time() > wait_until or any(n == want for n, _ in errors):
                        errors.append((name, f"original {want} never finished"))
                        return
                    time.sleep(0.05)
            with sem:
                try:
                    shutil.copy(path, os.path.join(bucket_dir, name))
                    r = requests.post(f"{base}/notify", json={
                        "Records": [{"s3": {"bucket": {"name": "videos"},
                                            "object": {"key": name}}}]},
                        timeout=10)
                    if r.status_code != 200:
                        errors.append((name, r.status_code))
                        return
                    deadline = time.time() + 600
                    while time.time() < deadline:
                        try:
                            s = requests.get(f"{base}/status/{name}",
                                             timeout=30).json()
                        except requests.RequestException:
                            time.sleep(1.0)
                            continue
                        if s.get("status") in ("done", "error"):
                            results[name] = s
                            return
                        time.sleep(0.05)
                    errors.append((name, "status poll deadline"))
                except Exception as e:  # noqa: BLE001 — reported as a failure
                    errors.append((name, repr(e)))

        t0 = time.perf_counter()
        threads = []
        for k, (name, path) in enumerate(names):
            t = threading.Thread(target=upload, args=(name, path), daemon=True)
            t.start()
            threads.append(t)
            if k == n_videos // 3:
                for tt in threads:
                    tt.join()
                memory("third")
        for t in threads:
            t.join(timeout=600)
        dt = time.perf_counter() - t0

        check("no transport errors", not errors, errors[:3])
        check("all analyses finished", len(results) == n_videos,
              f"{len(results)}/{n_videos}")
        bad = [n for n, s in results.items() if s.get("status") != "done"]
        check("all done (no errors)", not bad, bad[:3])
        dup_bad = [(n, want, results.get(n, {}).get("duplicates"))
                   for n, want in expect_dup_of.items()
                   if want not in (results.get(n, {}).get("duplicates") or [])]
        check(f"duplicate verdicts ({len(expect_dup_of) - len(dup_bad)}/"
              f"{len(expect_dup_of)})", not dup_bad, dup_bad[:3])
        false_pos = [n for n in results
                     if n not in expect_dup_of and results[n].get("duplicates")]
        check("no false duplicates on originals", not false_pos, false_pos[:3])
        held = int(requests.get(f"{base}/debug/analysis-results",
                                timeout=10).json()["count"])
        check(f"registry LRU bounded (<= {MAX_RESULTS + 4})",
              held <= MAX_RESULTS + 4, held)
        summary.update(seconds=dt, videos_per_s=n_videos / dt,
                       frames_per_s=n_videos * FRAMES / dt,
                       registry_held=held)

        # With every capacity grown and every shape built, more uploads
        # must cost next to nothing.
        memory("steady")
        for j in range(PROBES):
            name = f"soak-probe-{j}.y4m"
            path = os.path.join(uploads_dir, name)
            shutil.copy(originals[j % len(originals)][1], path)
            upload(name, path)
        check("probe uploads clean", not errors, errors[:3])
        memory("end")
        growth = summary["rss_mb_end"] - summary["rss_mb_steady"]
        check(f"steady-state RSS flat (< 10 MB/upload over {PROBES})",
              growth < 10.0 * PROBES,
              f"{summary['rss_mb_steady']:.0f} -> {summary['rss_mb_end']:.0f} MB "
              f"(main phase: {summary['rss_mb_third']:.0f} -> "
              f"{summary['rss_mb_steady']:.0f})")
        summary["kernel_launches"] = requests.get(
            f"{base}/metrics", timeout=30).json().get("kernel_launches")
        print(f"[soak] sustained ingest: {n_videos} videos "
              f"({n_videos * FRAMES} frames) in {dt:.1f} s = "
              f"{n_videos / dt:.2f} videos/s, {IN_FLIGHT}-way concurrent",
              flush=True)
    except (RuntimeError, TimeoutError, OSError, ValueError) as e:
        check("service reachable", False, repr(e))
    finally:
        stop_service(server)
        if failures:
            print("[soak] server log tail:\n" + log_tail(log_path), flush=True)
        shutil.rmtree(workdir, ignore_errors=True)

    print(f"[soak] FAILED: {failures}" if failures else "[soak] ALL CHECKS PASSED")
    print(json.dumps({"ok": not failures, "failures": failures, **summary}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
