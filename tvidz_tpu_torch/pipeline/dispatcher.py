"""Shared per-block device dispatcher for concurrent analyses, on PyTorch.

Port of ``tvidz_tpu/pipeline/dispatcher.py``. The service runs one analysis
thread per upload; with the dispatcher attached to the model, each thread's
``FingerprintModel.process_block`` submits its padded block here and blocks
on a future, and one worker thread runs every queued block in one
``forward_streams`` pass:

- the worker is self-clocking: while a pass runs, new blocks queue, and the
  next pass takes everything queued (up to ``max_bucket``); an optional
  submission window (clamped to 1 s) waits for more after the first block;
- on CUDA the submitting thread copies its block into pinned host memory and
  issues a ``non_blocking`` host-to-device copy on a side stream, recording
  an event; the worker's stream waits on each block's event before the pass
  (the reference's ``jax.device_put`` on the submitting thread);
- one device-to-host copy per pass brings back every block's scores and
  hashes;
- a pass that raises re-runs each of its blocks alone, so only a block whose
  own forward raises fails its future, and the worker keeps serving;
- ``stop()`` fails whatever is still queued, and a submission after stop
  fails at once, so no analysis thread waits forever.

Spans (``utils.timing``): ``dispatch.submit`` (pin and H2D enqueue, on the
submitting thread); ``dispatch.queue``, one a block from its submission to
the start of its pass, under the submitter's trace id, which each item
carries; ``dispatch.pass`` (attrs ``blocks`` and ``traces``, the trace ids
of its blocks), run under its first block's trace id, and inside it
``dispatch.pull``, the pass's device-to-host copy.

Blocks are not padded to a power-of-two batch as in the reference: nothing
compiles per shape here, and a dummy slot would be a wasted K1 launch.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from tvidz_tpu_torch.utils import log
from tvidz_tpu_torch.utils.futures import Future
from tvidz_tpu_torch.utils.timing import current_trace, record, span, trace
from tvidz_tpu_torch.pipeline.multistream import warm_dispatch


class _Future(Future):
    """Block-dispatch future: ``set``/``result`` over the shared Future."""

    __slots__ = ()

    def __init__(self):
        super().__init__(timeout_msg="block dispatch timed out")

    set = Future.resolve
    result = Future.wait


class _Item(NamedTuple):
    luma: torch.Tensor                  # the payload block on the device
    carry: object
    valid_t: int
    future: _Future
    ready: Optional[torch.cuda.Event]   # H2D copy done (CUDA only)
    host: Optional[torch.Tensor]        # the pinned source, kept until used
    trace: Optional[str]                # the submitter's trace id
    submitted: float                    # perf_counter at submission


class SharedBlockDispatcher:
    """One ``forward_streams`` pass over every concurrent analysis' ready
    block. ``max_bucket`` caps the blocks per pass (the rest roll into the
    next pass)."""

    def __init__(self, model, max_bucket: int = 4,
                 dispatcher_window_s: float = 0.0):
        self.model = model
        self.device = model.device
        self.max_bucket = max(1, max_bucket)
        # Clamped to 1 s: while waiting, the worker holds the first block's
        # future, and an unbounded window could outlive stop()'s join.
        self.dispatcher_window_s = min(max(0.0, dispatcher_window_s), 1.0)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._q: "queue.Queue[_Item]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Telemetry for /metrics: batching achieved, and the age of the pass
        # in flight (a stuck pass blocks every analysis behind it).
        self.passes = 0
        self.blocks = 0
        self._pass_started: Optional[float] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "SharedBlockDispatcher":
        self._thread = threading.Thread(
            target=self._loop, name="block-dispatcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._drain_failed()

    def _drain_failed(self) -> None:
        err = RuntimeError("block dispatcher stopped")
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            item.future.fail(err)

    def warm(self, max_bucket: Optional[int] = None) -> None:
        """One pass at every batch bucket up to ``max_bucket`` (service
        boot), so the first burst finds the kernels loaded."""
        warm_dispatch(
            self.model, min(max_bucket or self.max_bucket, self.max_bucket))

    # -- submission -----------------------------------------------------------

    def submit(self, buf: np.ndarray, carry, valid_t: int) -> _Future:
        """``buf`` is the block's device payload padded to block_frames
        rows — (T, H, W) uint8 luma, or (T, hash²) float32 coefficients
        under ship_dct_coeffs — and ``valid_t`` its real frame count. The future resolves to
        (scores (T,) float32 numpy, fps (T, words) uint32 numpy, new carry
        on the device)."""
        fut = _Future()
        if self._stop.is_set():
            fut.fail(RuntimeError("block dispatcher stopped"))
            return fut
        with span("dispatch.submit"):
            host = torch.from_numpy(np.ascontiguousarray(buf))
            ready = None
            if self._copy_stream is not None:
                host = host.pin_memory()
                with torch.cuda.stream(self._copy_stream):
                    luma = host.to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
            else:
                luma = host.to(self.device)
            self._q.put(_Item(luma, carry, int(valid_t), fut, ready, host,
                              current_trace(), time.perf_counter()))
        if self._stop.is_set():
            # stop() may have drained between the check above and the put.
            self._drain_failed()
        return fut

    # -- worker ---------------------------------------------------------------

    def _take_batch(self, first: _Item):
        batch = [first]
        deadline = (time.monotonic() + self.dispatcher_window_s
                    if self.dispatcher_window_s else None)
        while len(batch) < self.max_bucket:
            try:
                left = (0.0 if deadline is None or self._stop.is_set()
                        else deadline - time.monotonic())
                if left <= 0:
                    batch.append(self._q.get_nowait())
                else:
                    # <= 0.2 s slices so stop() during the window is prompt.
                    batch.append(self._q.get(timeout=min(left, 0.2)))
            except queue.Empty:
                if (deadline is not None and not self._stop.is_set()
                        and time.monotonic() < deadline):
                    continue
                break
        return batch

    def _run(self, batch):
        """One pass: forward_streams, then one D2H copy of every block's
        scores (as int32 bits) and hashes; returns each block's result."""
        if self._copy_stream is not None:
            stream = torch.cuda.current_stream(self.device)
            for item in batch:
                stream.wait_event(item.ready)
                # The block was allocated on the copy stream and is read on
                # this one: keep its memory until this stream is done.
                item.luma.record_stream(stream)
        scores, fps, carries = self.model.forward_streams(
            [item.luma for item in batch], [item.carry for item in batch],
            [item.valid_t for item in batch])
        packed = torch.cat([scores.view(torch.int32)[..., None], fps], dim=-1)
        with span("dispatch.pull"):
            host = packed.cpu().numpy()                    # (K, T, 1 + words)
        self.passes += 1
        self.blocks += len(batch)
        return [(host[j, :, 0].view(np.float32),
                 np.ascontiguousarray(host[j, :, 1:]).view(np.uint32), carries[j])
                for j in range(len(batch))]

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = self._take_batch(first)
            self._pass_started = time.monotonic()
            started = time.perf_counter()
            for item in batch:
                record("dispatch.queue", item.submitted, started, item.trace)
            done = []
            with trace(first.trace), \
                    span("dispatch.pass", blocks=len(batch)) as sp:
                if sp.traced:
                    sp.note(traces=[item.trace for item in batch])
                try:
                    done = list(zip(batch, self._run(batch)))
                except Exception as e:  # noqa: BLE001 — isolate, keep serving
                    log("dispatcher", f"batched pass failed ({len(batch)} "
                                      f"blocks): {e}; retrying each block alone")
                    if len(batch) == 1:
                        batch[0].future.fail(e)
                    else:
                        for item in batch:
                            try:
                                done += list(zip([item], self._run([item])))
                            except Exception as e1:  # noqa: BLE001
                                log("dispatcher", f"isolated block failed: {e1}")
                                item.future.fail(e1)
                finally:
                    self._pass_started = None
            # The pass is over (pass_age_s reads 0) before any submitter
            # wakes on its future.
            for item, result in done:
                item.future.set(result)

    def pass_age_s(self) -> float:
        """Seconds the current pass has been in flight (0 = idle)."""
        started = self._pass_started
        return (time.monotonic() - started) if started is not None else 0.0
