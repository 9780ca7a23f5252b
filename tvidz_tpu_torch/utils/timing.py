"""Per-stage timing and the port's spans.

``span(name, **attrs)`` times one piece of work where it happens, and
``StageTimer.stage(name)`` is a span that also keeps the analyzer's five
stages (``download``, ``probe``, ``fingerprint``, ``fp-search``,
``dedup-search``; ``summary()``). Every span adds its wall time to an
aggregate: a stage to its timer, any other span to the process-wide table
that ``/metrics`` serves as ``spans`` (``{name: {count, total_s, mean_s}}``;
a counter, ``count(name)``, is a row whose ``total_s`` stays 0).

Tracing is on exactly while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``, read once per span).
Then a span also opens ``torch.profiler.record_function("tvidz.<name>")``,
so the program's ranges sit in the exported trace on the profiler's clock
beside the kernels they launched, and its record (``SpanRecord``: name,
``time.perf_counter`` start and end, its id, its parent's id — the
innermost span open on the thread —, the trace id of the request it serves,
the thread and its attrs) goes to a bounded ring (``TRACER.finished()``;
the oldest are dropped and counted in ``TRACER.dropped``). Off, a span
reads the flag and the clock twice and updates its aggregate under a lock:
no record, no profiler range, no CUDA event, no synchronisation.

A request's trace id lives in a context variable: ``trace(id)`` binds it on
the thread that serves the request, and a thread the program starts for a
request is handed ``current_trace()`` and binds it itself. ``record``
enters a span whose ends are known only afterwards (a queue's wait).

The JAX package's ``TVIDZ_PROFILE_DIR`` is not read here.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import sys
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, NamedTuple, Optional

_PROFILER_MODULE = "torch.autograd.profiler"
_TRACE: contextvars.ContextVar = contextvars.ContextVar("tvidz_trace", default=None)
_PARENT: contextvars.ContextVar = contextvars.ContextVar("tvidz_span", default=None)
_IDS = itertools.count(1)


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is recording (no profiler can
    be on before torch is imported)."""
    mod = sys.modules.get(_PROFILER_MODULE)
    return mod is not None and mod._is_profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    t0: float
    t1: float
    id: int
    parent: Optional[int]
    trace: Optional[str]
    thread: str
    attrs: dict

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class StageTimer:
    """Wall-clock per name, thread-safe: the analyzer's stages
    (``stage(name)``, a span that adds its time here), and the base of the
    process-wide span table."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float, n: int = 1) -> None:
        with self._lock:
            self._total[name] += seconds
            self._count[name] += n

    def stage(self, name: str) -> "_Span":
        return _Span(name, {}, self)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: {"total_s": round(self._total[name], 6),
                           "count": self._count[name],
                           "mean_s": round(self._total[name]
                                           / max(self._count[name], 1), 6)}
                    for name in sorted(self._count)}


class Tracer(StageTimer):
    """The process's span table and its ring of finished records."""

    def __init__(self, capacity: int = 1 << 16) -> None:
        super().__init__()
        self._ring: deque = deque(maxlen=capacity)
        self.dropped = 0

    def keep(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)

    def finished(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._ring)


TRACER = Tracer()


class _Span:
    """One timed piece of work; its wall time goes to ``sink.add``."""

    __slots__ = ("name", "attrs", "_sink", "_t0", "_id", "_parent",
                 "_trace", "_token", "_range")

    def __init__(self, name: str, attrs: dict, sink) -> None:
        self.name, self.attrs, self._sink = name, attrs, sink

    @property
    def traced(self) -> bool:
        return self._id is not None

    def note(self, **attrs) -> None:
        """Attrs known only inside the span (kept when traced)."""
        if self._id is not None:
            self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        if tracing():
            self._open()
        else:
            self._id = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._sink.add(self.name, t1 - self._t0)
        if self._id is not None:
            self._close(t1)
        return False

    def _open(self) -> None:
        import torch

        self._id = next(_IDS)
        self._parent = _PARENT.get()
        self._trace = _TRACE.get()
        self._token = _PARENT.set(self._id)
        self._range = torch.profiler.record_function(f"tvidz.{self.name}")
        self._range.__enter__()

    def _close(self, t1: float) -> None:
        self._range.__exit__(None, None, None)
        _PARENT.reset(self._token)
        TRACER.keep(SpanRecord(self.name, self._t0, t1, self._id, self._parent,
                               self._trace, threading.current_thread().name,
                               self.attrs))


def span(name: str, **attrs) -> _Span:
    """A span of the process-wide table (module note)."""
    return _Span(name, attrs, TRACER)


def record(name: str, t0: float, t1: float, trace_id: Optional[str] = None,
           **attrs) -> None:
    """A span that ended at ``t1`` (``perf_counter``) and began at ``t0``,
    under ``trace_id`` (default: the thread's)."""
    TRACER.add(name, t1 - t0)
    if tracing():
        TRACER.keep(SpanRecord(name, t0, t1, next(_IDS), _PARENT.get(),
                               trace_id if trace_id is not None else _TRACE.get(),
                               threading.current_thread().name, attrs))


def count(name: str, n: int = 1) -> None:
    """A counter in the span table."""
    TRACER.add(name, 0.0, n)


def current_trace() -> Optional[str]:
    return _TRACE.get()


@contextlib.contextmanager
def trace(trace_id: Optional[str]) -> Iterator[None]:
    """Bind a request's trace id on this thread."""
    token = _TRACE.set(trace_id)
    try:
        yield
    finally:
        _TRACE.reset(token)
