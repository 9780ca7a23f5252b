"""Multi-stream decode feeding one shared batched device pass, on PyTorch.

Port of ``tvidz_tpu/pipeline/multistream.py``. Host decode is the ingest
ceiling: one decode stream keeps about one CPU core busy while the device
idles. ``fingerprint_streams`` runs N uploads at once, each with its own
decoder thread (at most ``max_active`` at a time, queued paths admitted as
streams finish), multiplexed onto the one device by a single loop:

1. **One pass a loop** — every loop pass takes the ready block of each
   stream and runs ONE ``FingerprintModel.forward_streams`` over them: for
   the 64-bit pHash one K1 launch (up to 64 streams), each stream a
   segment with its own carry and real frame count. Blocks are not padded
   to a power-of-two batch as in the reference (nothing compiles per shape
   here); a short tail block is padded with its last row and passes
   ``valid_t``.
2. **Transfer pump** — decoder threads hand each full block to one pump
   thread, which copies it from pinned host memory to the device with
   ``non_blocking=True`` on a CUDA stream of its own and records an event;
   the dispatch stream waits on that event, and ``record_stream`` keeps the
   block's memory from the caching allocator until the pass is done. A
   block the pump has not copied yet goes from the host inline; a copy the
   pump failed is logged and fails its block's stream.
3. **Deferred resolve** — carries stay on the device from pass to pass
   (no host sync). Each pass's scores and hashes are copied into a pinned
   host buffer with one non-blocking copy and an event; the pass is
   resolved (pulled and folded into its streams) one pass later, waiting
   on that event, not on the device: on the loop thread, or under
   ``ship_dct_coeffs`` (or ``ASYNC_RESOLVE = True``) on a resolver thread.

Two faults of the reference are not copied (ADVICE.md, ROADMAP C.5): the
resolver marks every item done in a ``finally`` and survives any exception
its pass raises (which fails that pass's streams), so ``drain()`` cannot
hang; and on an abnormal exit the resolver discards the passes still
queued and is joined, so no pass folds after ``fingerprint_streams`` has
returned.

``MultiStreamStats`` separates decode-starved wall time from dispatch and
resolve time, for the bench's e2e scaling legs.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.decode import get_decoder
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.ops.scene import NativeSceneScorer
from tvidz_tpu_torch.utils.logging import log


@dataclasses.dataclass
class StreamResult:
    path: str
    scene_cuts: List[float]
    fingerprints: np.ndarray     # (T, words) uint32
    frames: int
    error: Optional[str] = None


@dataclasses.dataclass
class MultiStreamStats:
    frames: int
    wall_s: float
    decode_starved_s: float      # loop idle: no stream had a block ready
    device_s: float              # dispatch + loop-blocked resolve
    streams: int
    dispatches: int = 0          # passes issued (one forward_streams each)
    dispatch_s: float = 0.0      # loop time issuing passes
    resolve_s: float = 0.0       # loop time blocked on resolution
    # Resolver-thread busy time (pull + fold), overlapped with decode and
    # dispatch under async resolve; equal to resolve_s when synchronous.
    resolve_busy_s: float = 0.0

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.wall_s if self.wall_s else 0.0


class _TransferPump:
    """One host-to-device copy thread shared by all streams of a loop, with
    a CUDA stream of its own. ``submit(holder, payload)`` returns at once;
    the pump sets ``holder[0] = (device block, event, pinned source)`` when
    the copy is issued, or the exception when it fails: the pass that takes
    the block raises it (``_on_device``), which fails that block's stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, name="h2d-pump",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            holder, payload = item
            try:
                host = torch.from_numpy(np.ascontiguousarray(payload)).pin_memory()
                with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                    block = host.to(self.device, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(self.stream)
                # The pinned source lives until the copy has run: the pass
                # that takes the block waits on ``done`` first.
                holder[0] = (block, done, host)
            except Exception as e:  # noqa: BLE001 — raised where the block is taken
                log("multistream", f"h2d pump copy failed: {e!r}", logging.WARNING)
                holder[0] = e

    def submit(self, holder, payload) -> None:
        self.q.put((holder, payload))

    def stop(self) -> None:
        self.q.put(None)


class _Stream:
    """One upload: a decoder thread pushing (block, holder, payload) into a
    bounded queue, then None."""

    def __init__(self, path: str, model: FingerprintModel, depth: int = 2,
                 pump: Optional[_TransferPump] = None):
        self.path = path
        self.carry = model.init_carry()
        self.scorer = NativeSceneScorer(
            model.config.scene.native_resolution,
            host_mafd_fallback=model.ship_coeffs)
        self.cuts: List[float] = []
        self.fps_out: List[np.ndarray] = []
        self.frames = 0
        self.error: Optional[str] = None
        self.done = False
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stopped = False
        self._model = model
        self._pump = pump
        self._thread = threading.Thread(target=self._decode, name="decode",
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """A bounded put that gives up once the stream is stopped (the loop
        died or retired it), so the thread never blocks forever."""
        while not self.stopped:
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _decode(self) -> None:
        m = self._model
        try:
            dec = get_decoder(
                self.path, lowres=m.config.pipeline.decode_lowres,
                dct_dc=m.config.pipeline.decode_dct_dc)
            for block in dec.blocks(self.path, m.block_frames, m.height, m.width):
                # The device payload (luma, or the projected coefficients)
                # is computed here, on the decoder thread's core.
                payload = m.project_payload(block.luma)
                holder = [None]
                if (self._pump is not None
                        and block.luma.shape[0] == m.block_frames):
                    self._pump.submit(holder, payload)
                if not self._put((block, holder, payload)):
                    return
        except Exception as e:  # noqa: BLE001 — surfaced per stream
            self.error = str(e)
        self._put(None)

    def stop(self) -> None:
        """Retire the decoder thread (its queue is drained once so that a
        pending put returns)."""
        self.stopped = True
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass


# Resolve placement, as the reference's (ASYNC_RESOLVE, multistream.py:196):
# None resolves on a thread of its own only under ship_dct_coeffs, where
# the payloads are small; True / False force one placement (tests, races).
ASYNC_RESOLVE = None


class _Resolver:
    """Resolve thread: pulls each pass's outputs and folds them into its
    streams in FIFO order (a stream's blocks enter passes in order).

    Failures: any exception a pass raises becomes (stream, exc) for each
    of its streams, which the loop applies with ``pop_failures``; the item
    is marked done in a ``finally`` and the thread keeps serving. ``stop(
    abort=True)`` discards what is still queued, and ``stop`` joins the
    thread."""

    def __init__(self, model: FingerprintModel, depth: int = 4):
        self._model = model
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.busy_s = 0.0
        self._failed: List[Tuple["_Stream", BaseException]] = []
        self._lock = threading.Lock()
        self._abort = threading.Event()
        self._thread = threading.Thread(target=self._run, name="resolver",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self.q.get()
            try:
                if item is None:
                    return
                if self._abort.is_set():
                    continue
                t0 = time.perf_counter()
                try:
                    _resolve(self._model, item)
                except BaseException as e:  # noqa: BLE001 — the pass's streams
                    with self._lock:
                        self._failed.extend((s, e) for s, _b, _t in item[0])
                self.busy_s += time.perf_counter() - t0
            finally:
                self.q.task_done()

    def submit(self, pending) -> None:
        """Blocks while ``depth`` passes are unresolved (backpressure)."""
        self.q.put(pending)

    def pop_failures(self) -> List[Tuple["_Stream", BaseException]]:
        with self._lock:
            out, self._failed = self._failed, []
        return out

    def drain(self) -> None:
        """Wait until every submitted pass has been resolved."""
        self.q.join()

    def stop(self, abort: bool = False) -> None:
        if abort:
            self._abort.set()
        self.q.put(None)
        self._thread.join()


def _bucket(k: int) -> int:
    """Next power of two >= k: the batch sizes a warm pass visits."""
    return 1 << (k - 1).bit_length()


def default_max_active() -> int:
    """Decoder-thread admission default: one decoder thread per core (decode
    is the per-core bottleneck; more decoders than cores only thrash)."""
    return max(1, os.cpu_count() or 1)


def warm_dispatch(model: FingerprintModel, max_streams: int) -> None:
    """Run one ``forward_streams`` pass at every bucket up to
    ``max_streams`` concurrent streams, at the production payload
    (``example_payload``: luma, or coefficients under ship_dct_coeffs).
    Nothing compiles per shape here; the pass loads the kernels and fills
    the allocator's pools before the first real burst."""
    bt = model.block_frames
    k = 1
    while True:
        lumas = tuple(model.example_payload() for _ in range(k))
        carries = [model.init_carry() for _ in range(k)]
        scores, fps, _ = model.forward_streams(lumas, carries, [bt] * k)
        scores.cpu(), fps.cpu()
        if k >= max_streams:
            return
        k = _bucket(k + 1)


def _on_device(model: FingerprintModel, payload: np.ndarray, t: int,
               holder) -> torch.Tensor:
    """A ready block's payload on the device, padded to block_frames rows:
    the pump's copy (the current stream waits on its event, and the block's
    memory is kept until this stream is done with it), else the host
    payload, padded with its last row, copied inline. A copy the pump
    failed raises its error here."""
    bt = model.block_frames
    if holder is not None and isinstance(holder[0], BaseException):
        raise holder[0]
    if holder is not None and holder[0] is not None:
        block, done, _host = holder[0]
        stream = torch.cuda.current_stream(model.device)
        stream.wait_event(done)
        block.record_stream(stream)
        return block
    if t < bt:
        payload = np.concatenate([payload, np.repeat(payload[-1:], bt - t, axis=0)])
    return torch.from_numpy(np.ascontiguousarray(payload)).to(model.device)


def _dispatch(model: FingerprintModel, ready):
    """ONE ``forward_streams`` pass over the ready (stream, block, holder,
    payload) tuples. Each stream's carry becomes its (device-resident) new
    carry at once, so the next pass chains without a host sync; the
    outputs start their copy to pinned host memory. Returns the pending
    pass ``(metas, host buffer, event)`` that ``_resolve`` takes later."""
    metas, slots, carries, valid = [], [], [], []
    for s, block, holder, payload in ready:
        t = block.luma.shape[0]
        slots.append(_on_device(model, payload, t, holder))
        carries.append(s.carry)
        valid.append(t)
        metas.append((s, block, t))
    scores, fps, new_carries = model.forward_streams(slots, carries, valid)
    for j, (s, _block, _t) in enumerate(metas):
        s.carry = new_carries[j]
    packed = torch.cat([scores.view(torch.int32)[..., None], fps], dim=-1)
    if packed.is_cuda:
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        # On the outputs' device (not the current one): the copy's stream.
        done.record(torch.cuda.current_stream(packed.device))
        return metas, host, done
    return metas, packed, None


def _resolve(model: FingerprintModel, pending) -> None:
    """Pull a dispatched pass (wait on its copy's event) and fold it into
    its streams: scores through each stream's ``NativeSceneScorer``, cuts
    through the model's one ``extract_cuts``."""
    metas, host, done = pending
    if done is not None:
        done.synchronize()
    out = host.numpy()                                   # (K, T, 1 + words)
    for j, (s, block, t) in enumerate(metas):
        scores = s.scorer.scores(block, out[j, :, 0].view(np.float32), t)
        new_cuts = model.extract_cuts(
            scores, block.pts, t, last_cut=s.cuts[-1] if s.cuts else None)
        s.fps_out.append(np.ascontiguousarray(out[j, :t, 1:]).view(np.uint32))
        s.cuts.extend(new_cuts)
        s.frames += t


def fingerprint_streams(
    paths: Sequence[str],
    model: Optional[FingerprintModel] = None,
    config: Optional[Config] = None,
    queue_depth: int = 2,
    max_active: Optional[int] = None,
    device=None,
) -> Tuple[List[StreamResult], MultiStreamStats]:
    """Fingerprint N videos concurrently: at most ``max_active`` decoder
    threads, one device, one ``forward_streams`` pass per loop pass.

    The loop serves whichever streams have a block ready (a slow or long
    video never stalls the others), keeps each stream's scene carry on the
    device, isolates a failing block to its own stream, and accounts
    decode-starved against dispatch and resolve time. ``device`` is the
    model's when no ``model`` is given."""
    model = model or FingerprintModel(config or Config(), device=device)
    if max_active is None:
        max_active = default_max_active()
    max_active = max(1, max_active)

    order = list(range(len(paths)))
    waiting = list(order)
    streams: Dict[int, _Stream] = {}
    active: Dict[int, _Stream] = {}
    pump = _TransferPump(model.device) if model.device.type == "cuda" else None
    use_async = model.ship_coeffs if ASYNC_RESOLVE is None else ASYNC_RESOLVE
    resolver = _Resolver(model) if use_async else None

    def admit() -> None:
        while waiting and len(active) < max_active:
            i = waiting.pop(0)
            s = _Stream(paths[i], model, depth=queue_depth, pump=pump)
            streams[i] = s
            active[i] = s

    admit()
    starved_s = device_s = dispatch_s = resolve_s = 0.0
    dispatches = 0
    pending = None
    t_start = time.perf_counter()

    def fail_stream(s: _Stream, err: BaseException,
                    label: str = "device dispatch failed") -> None:
        # Only ITS stream: record the error, retire the decoder thread, drop
        # it from the loop, admit a waiting path.
        s.error = s.error or f"{label}: {err}"
        s.stop()
        for i, cand in list(active.items()):
            if cand is s:
                del active[i]
        admit()

    def resolve_inline(p) -> None:
        try:
            _resolve(model, p)
        except Exception as e:  # noqa: BLE001 — the whole pass's streams
            for s, _block, _t in p[0]:
                fail_stream(s, e)

    finished = False
    try:
        while active or pending is not None:
            if resolver is not None:
                for s, e in resolver.pop_failures():
                    fail_stream(s, e, label="block resolve failed")
            ready = []
            for i in sorted(active):
                s = active[i]
                try:
                    item = s.q.get_nowait()
                except queue.Empty:
                    continue
                if item is None:
                    s.done = True
                    del active[i]
                    admit()
                    continue
                block, holder, payload = item
                if block.luma.shape[0] == 0:
                    continue                      # a zero-frame block: no-op
                ready.append((s, block, holder, payload))
            new_pending = None
            if ready:
                t0 = time.perf_counter()
                try:
                    new_pending = _dispatch(model, ready)
                    dispatches += 1
                except Exception:  # noqa: BLE001 — isolate per stream
                    # Re-run each ready block as its own pass and retire only
                    # the streams whose own pass raises. Every earlier pass
                    # is resolved first, so no stream's blocks fold out of
                    # order.
                    if resolver is not None:
                        resolver.drain()
                        for s0, e0 in resolver.pop_failures():
                            fail_stream(s0, e0, label="block resolve failed")
                    if pending is not None:
                        resolve_inline(pending)
                        pending = None
                    for s, block, holder, payload in ready:
                        if s.error is not None:
                            continue
                        try:
                            p = _dispatch(model, [(s, block, holder, payload)])
                            dispatches += 1
                            _resolve(model, p)
                        except Exception as e1:  # noqa: BLE001
                            fail_stream(s, e1)
                dt_ = time.perf_counter() - t0
                device_s += dt_
                dispatch_s += dt_
            if new_pending is not None and resolver is not None:
                t0 = time.perf_counter()
                resolver.submit(new_pending)
                dt_ = time.perf_counter() - t0
                device_s += dt_
                resolve_s += dt_
                new_pending = None
            if pending is not None:
                # The previous pass, while this one runs on the device and
                # the decoders refill their queues.
                t0 = time.perf_counter()
                resolve_inline(pending)
                dt_ = time.perf_counter() - t0
                device_s += dt_
                resolve_s += dt_
            pending = new_pending
            if not ready and pending is None and active:
                t0 = time.perf_counter()
                time.sleep(0.001)
                starved_s += time.perf_counter() - t0
        if resolver is not None:
            t0 = time.perf_counter()
            resolver.drain()
            dt_ = time.perf_counter() - t0
            device_s += dt_
            resolve_s += dt_
            for s, e in resolver.pop_failures():
                s.error = s.error or f"block resolve failed: {e}"
                s.stop()
        finished = True
    finally:
        # Retire every decoder thread (none may stay blocked in a put); on
        # an abnormal exit the resolver discards what is still queued, and
        # it is joined either way, so nothing folds after this returns.
        for s in streams.values():
            s.stop()
        if pump is not None:
            pump.stop()
        if resolver is not None:
            resolver.stop(abort=not finished)

    wall = time.perf_counter() - t_start
    words = model.config.hash.words
    results = []
    for i in order:
        s = streams.get(i)
        if s is None:
            results.append(StreamResult(
                path=paths[i], scene_cuts=[], frames=0,
                fingerprints=np.zeros((0, words), np.uint32),
                error="never started (dispatch loop aborted)"))
            continue
        results.append(StreamResult(
            path=s.path, scene_cuts=s.cuts,
            fingerprints=(np.concatenate(s.fps_out) if s.fps_out
                          else np.zeros((0, words), np.uint32)),
            frames=s.frames, error=s.error))
    return results, MultiStreamStats(
        frames=sum(r.frames for r in results), wall_s=wall,
        decode_starved_s=starved_s, device_s=device_s, streams=len(paths),
        dispatches=dispatches, dispatch_s=dispatch_s, resolve_s=resolve_s,
        resolve_busy_s=resolver.busy_s if resolver is not None else resolve_s)
