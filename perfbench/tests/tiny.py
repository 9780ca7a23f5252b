"""A checkout of the benchmark at sizes a CPU test can hold.

``tiny_root(tmp)`` writes a ``BENCHMARK.json`` with the repository's own
cells, metrics and limits, and configuration and traffic files cut to a
few videos and a few seconds, beside links to the real traffic kinds and
metric readers, so
``core.run_cell(..., device="cpu", root=...)`` drives every part of a run.
"""

from __future__ import annotations

import json
import os

from perfbench.core import ROOT, load_json

TINY_CATALOG = {"phash64-16m": {"videos": 16, "frames_per_video": 512},
                "phash256-16m": {"videos": 8, "frames_per_video": 256}}
TINY_TRAFFIC = {
    "uploads-poisson": {"rate_per_s": 2.0, "frames": [128, 256],
                        "originals": {"count": 4, "frames": 128},
                        "duplicate_share": 0.25, "drain_s": 60},
    "fragsearch-4clients": {"sources": {"count": 4, "frames": 128},
                            "span_frames": [32, 128], "warm_requests": 1,
                            "check_requests": 2, "requests_per_client": 512},
}


def tiny_root(tmp: str, traffic_changes=None) -> str:
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    pb = os.path.join(tmp, "perfbench")
    for d in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(pb, d), exist_ok=True)
    for d in ("metrics", "kinds"):
        os.symlink(os.path.join(ROOT, "perfbench", d), os.path.join(pb, d))
    for c in bench["configs"]:
        cfg = load_json(os.path.join(ROOT, c["file"]))
        cfg["catalog"] = dict(cfg["catalog"], **TINY_CATALOG[c["name"]])
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name, change in TINY_TRAFFIC.items():
        t = load_json(os.path.join(ROOT, "perfbench", "traffic", f"{name}.json"))
        t.update(change)
        t.update((traffic_changes or {}).get(name, {}))
        with open(os.path.join(pb, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    for w in bench["workloads"]:
        limits = load_json(os.path.join(ROOT, "perfbench", "checks",
                                        f"{w['name']}.json"))
        with open(os.path.join(pb, "checks", f"{w['name']}.json"), "w") as f:
            json.dump(limits, f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
