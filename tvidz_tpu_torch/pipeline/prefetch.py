"""Decode-ahead prefetching: overlap host decode with device compute.

The analyzer's loop alternates host decode (CPU-bound, dominates e2e) with
device fingerprinting + corpus queries (TPU + dispatch RTT). Decoding block
N+1 on a background thread while block N is on the device turns the per-video
wall clock from (decode + device) into ~max(decode, device).

The prefetcher is early-exit-safe: closing it (the analyzer's duplicate
early-termination, app.py:249-255 analog) unblocks and ends the worker
thread promptly even with a full queue.

The worker serves the request that made it: it binds the creating thread's
trace id (``utils.timing``), and each step of the iterator is a
``decode.block`` span on it (attr ``frames``: the block's frame count).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from tvidz_tpu_torch.utils.timing import current_trace, span, trace

T = TypeVar("T")

_SENTINEL = object()


def _decode_steps(iterator: Iterable[T]) -> Iterator[T]:
    """``iterator``'s items, each step a ``decode.block`` span."""
    it = iter(iterator)
    while True:
        with span("decode.block") as sp:
            item = next(it, _SENTINEL)
            if sp.traced and item is not _SENTINEL:
                sp.note(frames=len(getattr(item, "luma", ())))
        if item is _SENTINEL:
            return
        yield item


class BlockPrefetcher:
    def __init__(self, iterator: Iterable[T], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, args=(iterator, current_trace()), daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, iterator: Iterable[T], trace_id) -> None:
        with trace(trace_id):
            try:
                for item in _decode_steps(iterator):
                    if not self._put(item):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised on the consumer side
                self._err = e
            self._put(_SENTINEL)

    def __iter__(self) -> Iterator[T]:
        try:
            while True:
                item = self._q.get()
                if item is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()

    def close(self) -> None:
        self._stop.set()
        # Drain so a worker blocked mid-put can observe the stop flag fast.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
