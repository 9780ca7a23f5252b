"""The in-process state plane.

Reference: the ``analysis_results`` dict + ``analysis_lock`` (app.py:28-29),
written by analysis threads and read by /status and the SSE streamer. Same
JSON state shape here so the frontend works unchanged:

    {status, progress, scene_cuts, total_cuts, duplicates,
     original_filename, clean_filename [, error]}

plus framework extensions under non-conflicting keys (fingerprint count,
stage timings) that old clients simply ignore.

Beside each state, never inside it, the registry keeps when ``finish`` last
wrote it (``time.perf_counter``) and the trace id of the request that did
(``utils.timing``), for the SSE stream's ``sse.deliver`` span.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from tvidz_tpu_torch.utils.timing import current_trace


class AnalysisRegistry:
    """Thread-safe registry of per-analysis state dicts, keyed by the
    race-proof analysis key (``{epoch}_{uuid8}_{filename}``, app.py:134-136)."""

    def __init__(self, max_entries: int = 10_000) -> None:
        self._lock = threading.Lock()
        self._results: Dict[str, dict] = {}
        self._finished: Dict[str, Tuple[float, Optional[str]]] = {}
        self.max_entries = max_entries

    def _evict_locked(self) -> None:
        """Drop oldest FINISHED entries beyond the cap (the reference's
        analysis_results dict grows without bound, app.py:28). In-flight
        analyses are never evicted."""
        if self.max_entries <= 0 or len(self._results) <= self.max_entries:
            return
        excess = len(self._results) - self.max_entries
        for key in [
            k for k, v in self._results.items()
            if v.get("status") in ("done", "error")
        ][:excess]:
            del self._results[key]
            self._finished.pop(key, None)

    # -- write side (analyzer) ----------------------------------------------

    def seed(self, key: str, original_filename: str, clean_filename: str) -> None:
        with self._lock:
            self._results[key] = {
                "status": "analyzing",
                "scene_cuts": [],
                "progress": 0.0,
                "total_cuts": 0,
                "duplicates": [],
                "original_filename": original_filename,
                "clean_filename": clean_filename,
            }
            self._finished.pop(key, None)
            self._evict_locked()

    def remove(self, key: str) -> None:
        with self._lock:
            self._results.pop(key, None)
            self._finished.pop(key, None)

    def update(self, key: str, **fields) -> None:
        with self._lock:
            if key in self._results:
                self._results[key].update(fields)

    def finish(self, key: str, **fields) -> None:
        """Replace the entry wholesale (reference final-state writes,
        app.py:293-302 / 303-315)."""
        with self._lock:
            self._results[key] = fields
            self._finished[key] = (time.perf_counter(), current_trace())
            self._evict_locked()

    def get_existing_duplicates(self, key: str) -> List[str]:
        with self._lock:
            return list(self._results.get(key, {}).get("duplicates", []))

    # -- read side (API / SSE) -------------------------------------------------

    def lookup(self, filename: str) -> Optional[dict]:
        """Exact-key match first, then scan for original_filename — the
        reference's /status resolution order (app.py:75-84). A third pass
        matches RESTORED (post-restart) entries by clean name: the store
        only holds the clean filename, so a frontend polling with its
        epoch-prefixed upload name ('1723-test.mp4') would otherwise sit at
        'pending' forever after a restart. Passes 2 AND 3 are partitioned
        live-vs-restored: boot-time restored entries precede live seeds in
        dict order, so an unpartitioned scan would return a stale restored
        'done' (whose SSE stream then terminates) ahead of an in-flight
        re-analysis of the same name."""
        return self.lookup_finished(filename)[0]

    def lookup_finished(self, filename: str
                        ) -> Tuple[Optional[dict],
                                   Optional[Tuple[float, Optional[str]]]]:
        """``lookup``'s state, with when ``finish`` wrote it and under which
        trace id (None before a ``finish``)."""
        # Lazy import (circular with analyzer at module scope), kept
        # OUTSIDE the lock so a first-touch import chain can't block
        # every analyzer update for its duration.
        from tvidz_tpu_torch.pipeline.analyzer import extract_filenames

        _, clean = extract_filenames(filename)
        with self._lock:
            key = self._find_locked(filename, clean)
            if key is None:
                return None, None
            return dict(self._results[key]), self._finished.get(key)

    def _find_locked(self, filename: str, clean: str) -> Optional[str]:
        if filename in self._results:
            return filename
        for key, data in self._results.items():
            if (not str(key).startswith("restored_")
                    and isinstance(data, dict)
                    and data.get("original_filename") == filename):
                return key
        for key, data in self._results.items():
            if (str(key).startswith("restored_")
                    and isinstance(data, dict)
                    and data.get("clean_filename") == clean):
                return key
        return None

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._results.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._results)
