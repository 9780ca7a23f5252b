"""Spans and counters the benchmark takes from outside the program, and the
reading of the profiler's trace.

``Recorder`` wraps, at run time, the program calls that bound its layers
(the poller's dispatch, the analyzer, the fingerprint and corpus ops, the
fragment route) and keeps, in memory, a span for each call: its name, host
start and end, and what the call's shapes say (frames, the least time the
chip needs for it). In a traced run every span also opens a
``torch.profiler.record_function`` range named ``perfbench.<name>#<n>``,
so that the device work launched inside it can be found in the trace.

``read_trace`` turns an exported Chrome trace into: device busy seconds
(the union of kernel, copy and set intervals) inside the window, the device
seconds launched from inside each span, the device operations that took the
most time, and the longest idle gaps named by the innermost span open on
the host at the time.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "perfbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class Span:
    __slots__ = ("name", "seq", "t0", "t1", "info")

    def __init__(self, name: str, seq: int, t0: float, info: dict):
        self.name, self.seq, self.t0, self.t1, self.info = name, seq, t0, None, info

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Recorder:
    """In-memory spans and marks of one run; ``traced`` also opens profiler
    ranges."""

    def __init__(self, traced: bool):
        self.traced = traced
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self.spans: Dict[str, List[Span]] = defaultdict(list)
        self.marks: Dict[str, Dict[str, float]] = defaultdict(dict)
        self.counts: Dict[str, float] = defaultdict(float)
        self.local = threading.local()

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.marks.clear()
            self.counts.clear()

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self.counts[name] += value

    @contextlib.contextmanager
    def span(self, name: str, **info):
        sp = Span(name, next(self._seq), time.perf_counter(), info)
        ctx = contextlib.nullcontext()
        if self.traced:
            import torch

            ctx = torch.profiler.record_function(f"{PREFIX}{name}#{sp.seq}")
        try:
            with ctx:
                yield sp
        finally:
            sp.t1 = time.perf_counter()
            with self._lock:
                self.spans[name].append(sp)

    def mark(self, kind: str, key: str, t: Optional[float] = None) -> None:
        """The host time of an event of ``kind`` for ``key`` (first wins)."""
        with self._lock:
            self.marks[kind].setdefault(key, time.perf_counter() if t is None else t)


def wrap(obj, attr: str, make) -> None:
    """Replace ``obj.attr`` by ``make(original)`` on this instance only."""
    setattr(obj, attr, make(getattr(obj, attr)))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _split(name: str) -> Tuple[str, Optional[int]]:
    base, _, seq = name[len(PREFIX):].partition("#")
    return base, (int(seq) if seq.isdigit() else None)


def read_trace(path: str, top: int = 10, host_state=None) -> dict:
    """What the benchmark reads from one Chrome trace (times in seconds):
    ``window_s``, ``busy_s``, ``by_span`` {seq: device seconds launched from
    inside that span}, ``device_ops`` [[name, seconds]] and ``idle_gaps``
    [[what the host was doing, seconds]]: the innermost span open at the
    gap's middle, else ``host_state(seconds since the window opened)``."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, runtime, ranges = [], {}, defaultdict(list)
    external = {}
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((ts, dur, e.get("name", ""), args))
        elif cat in RUNTIME_CATS and "correlation" in args:
            runtime[args["correlation"]] = (e.get("tid"), ts)
        elif e.get("name", "").startswith(PREFIX):
            base, seq = _split(e["name"])
            if base == "window":
                window = (ts, ts + dur)
            else:
                ranges[e.get("tid")].append((ts, ts + dur, base, seq))
                if "External id" in args:
                    external[args["External id"]] = seq
    if window is None:
        raise RuntimeError("the trace holds no perfbench.window range")
    w0, w1 = window
    for rs in ranges.values():
        rs.sort()

    def owner(tid, ts) -> Optional[int]:
        best = None
        for a, b, _, seq in ranges.get(tid, ()):
            if a > ts:
                break
            if ts <= b and seq is not None:
                best = seq                   # the latest start: innermost
        return best

    by_span: Dict[int, float] = defaultdict(float)
    ops: Dict[str, float] = defaultdict(float)
    busy = []
    for ts, dur, name, args in device:
        seq = None
        hit = runtime.get(args.get("correlation"))
        if hit is not None:
            seq = owner(*hit)
        if seq is None and args.get("External id") in external:
            seq = external[args["External id"]]
        if seq is not None:
            by_span[seq] += dur / 1e6
        a, b = max(ts, w0), min(ts + dur, w1)
        if b > a:
            busy.append((a, b))
            ops[name[:80]] += (b - a) / 1e6
    merged = _union(busy)
    gaps, at = [], w0
    for a, b in merged + [(w1, w1)]:
        if a > at:
            gaps.append((a - at, at, a))
        at = max(at, b)
    gaps.sort(reverse=True)
    flat = [(a, b, base) for rs in ranges.values() for a, b, base, _ in rs]

    def open_span(t: float) -> str:
        best = None
        for a, b, base in flat:
            if a <= t <= b and (best is None or a > best[0]):
                best = (a, base)
        if best:
            return best[1]
        state = host_state((t - w0) / 1e6) if host_state else None
        return state or "no request in flight"

    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in merged) / 1e6,
        "by_span": dict(by_span),
        "device_ops": [[k, v] for k, v in
                       sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[open_span((a + b) / 2), g / 1e6]
                      for g, a, b in gaps[:top]],
    }
