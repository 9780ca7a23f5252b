"""The benchmark's core: find a cell's parts by name, run it, reduce what it
recorded to metrics, and build the result line.

Everything a cell is made of is found from ``BENCHMARK.json`` by name:

- the cell (``workloads[]``): its configuration and traffic names;
- the configuration: the file its ``configs[]`` entry names
  (``perfbench/configs/<config>.json``: the deployment's settings and
  catalog);
- the traffic: ``perfbench/traffic/<traffic>.json``, whose ``kind`` names
  the module ``perfbench/kinds/<kind>.py`` that offers it, with its seams,
  its comparison and its control (``perfbench/load.py``);
- the limits of the comparison: ``perfbench/checks/<workload>.json``;
- each per-layer metric: ``perfbench/metrics/<metric>.py``, a reader with
  ``read(ctx)`` that returns a number or None (nothing to read: the metric
  is left out of the line).

End-to-end metrics are named ``<sample>_p<q>_<unit>`` (the q-th percentile
of a kind's samples of that name, over every request of the window, a
failed one beyond every percentile) or ``setup_s`` (process start to the
start of the window).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(entries: Sequence[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """A workload of ``BENCHMARK.json`` with every part it names."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        self.cell = by_name(self.bench["workloads"], name, "workload")
        self.name = name
        entry = by_name(self.bench["configs"], self.cell["config"], "config")
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(os.path.join(
            root, "perfbench", "traffic", f"{self.cell['traffic']}.json"))
        self.limits = load_json(os.path.join(
            root, "perfbench", "checks", f"{name}.json"))
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]

    def kind_class(self) -> type:
        from perfbench.load import load_kind

        return load_kind(self.root, self.traffic["kind"])

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.root, "perfbench", "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', metric)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of all values, linear between order statistics;
    ``inf`` (a failed request) sorts beyond every other."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(v[hi]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


_E2E = re.compile(r"^(?P<sample>[a-z_]+)_p(?P<q>\d+)_(?P<unit>ms|s)$")


def end_to_end_value(name: str, samples: Dict[str, List[float]],
                     setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    m = _E2E.match(name)
    if not m or m["sample"] not in samples:
        raise KeyError(f"no arithmetic for end-to-end metric {name!r}")
    value = percentile(samples[m["sample"]], float(m["q"]))
    return value / 1e3 if m["unit"] == "s" else value


def process_start_wall() -> float:
    """The wall-clock time this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


class Context:
    """What a per-layer reader reads (see ``perfbench/metrics``)."""

    def __init__(self, kind, rec, before: dict, after: dict, trace,
                 window_s: float, platform: str):
        self.kind, self.rec, self.trace = kind, rec, trace
        self.window_s, self.platform = window_s, platform
        self.stages = {}
        for name, a in after["stages"].items():
            b = before["stages"].get(name, {"total_s": 0.0, "count": 0})
            self.stages[name] = {"total_s": a["total_s"] - b["total_s"],
                                 "count": a["count"] - b["count"]}
        self.passes = after["passes"] - before["passes"]
        self.blocks = after["blocks"] - before["blocks"]


def card(device: str) -> dict:
    """The card's name, count and power limit (``nvidia-smi``)."""
    import subprocess

    import torch

    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    limit = out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit": limit}


def written_bytes() -> int:
    """What this process has passed to write calls so far (Linux
    ``/proc/self/io``), 0 where that is not there."""
    try:
        with open("/proc/self/io") as f:
            return next(int(line.split()[1]) for line in f
                        if line.startswith("wchar"))
    except (OSError, StopIteration):
        return 0


def forbidden_modules() -> List[str]:
    """JAX, or the JAX package, imported into this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "tvidz_tpu"))


def _profiler():
    """A profiler of the CPU and the card that records the ranges of every
    thread (the analyses and clients run on threads of their own)."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        cfg = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return profile(activities=acts)
    return profile(activities=acts, experimental_config=cfg)


def run_cell(workload: str, seed: int, seconds: int, trace: bool,
             device: str = "cuda", root: str = ROOT,
             overrides: Optional[dict] = None, hooks: Sequence = (),
             say=print) -> dict:
    """One run of a cell: set up, measure ``seconds``, drain, compare with
    the reference; the result line as a dict (``checks`` last)."""
    import torch

    from perfbench.probes import Recorder, read_trace

    start_wall = process_start_wall()
    cell = Cell(workload, root)
    traffic = dict(cell.traffic, **(overrides or {}))
    gpu = device.startswith("cuda")
    rec = Recorder(traced=bool(trace) and gpu)
    work = tempfile.mkdtemp(prefix="perfbench-")
    try:
        kind = cell.kind_class()(cell.config, traffic, seed, seconds, device,
                                 rec, work)
        kind.hooks = list(hooks)
        kind.setup()
        kind.begin_window()
        before = kind.counters()
        if gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if rec.traced:
            prof = _profiler()
            prof.__enter__()
        t0 = max(kind.window_start(), time.perf_counter())
        while (d := t0 - time.perf_counter()) > 0:
            time.sleep(d)
        setup_s = time.time() - start_wall
        if prof is not None:
            with torch.profiler.record_function("perfbench.window"):
                kind.run_window(t0)
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        else:
            kind.run_window(t0)
        kind.drain(traffic["drain_s"])
        after = kind.counters()
        dev = card(device)
        dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if gpu else 0)
        say(json.dumps({"card": dev, "setup_s": setup_s, **kind.notes,
                        "written_gb": written_bytes() / 1e9}), flush=True)
        tr = None
        if prof is not None:
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            tr = read_trace(path, host_state=lambda ts: kind.host_state(t0 + ts))
            os.remove(path)
            dev["busy_s"] = tr["busy_s"]
            dev["window_s"] = tr["window_s"]
        metrics = {}
        if trace:
            ctx = Context(kind, rec, before, after, tr, float(seconds),
                          dev["platform"])
            for m in cell.per_layer:
                value = cell.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in cell.end_to_end:
                value = end_to_end_value(m["name"], kind.samples, setup_s)
                if math.isinf(value):
                    value = 1e3 * (kind.drain_end - kind.t0)
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        kind.free_program()
        t = time.perf_counter()
        checks = kind.verify(cell.limits)
        say(json.dumps({"verify_s": time.perf_counter() - t}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"imported into the benchmark's process: {bad}")
    correct = kind.failed == 0 and all(v <= lim for v, lim in checks.values())
    line = {"correct": correct, "attempted": kind.attempted,
            "failed": kind.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line
