"""The port's benchmark: the device legs of ``bench.py`` on one CUDA card.

    python -m tvidz_tpu_torch bench [--device cpu] [--sizes tiny] [--legs ...]

Legs (the JAX harness's function each one ports):

- ``fingerprint``  (``bench_fingerprint_throughput``): K1 over 512 x 256
  contiguous 90x160 frames, one launch a loop with the scene carry
  threaded through (single dispatch, as the JAX harness) -> ``value``
  (median frames/s); the same frames issued one 256-frame block a launch
  -> ``fingerprint_per_block_frames_per_sec``.
- ``verdict``      (``bench_verdict_latency``): the corpus-scan race at
  M=128 against 2^20 and 2^24 random rows -> ``verdict_{1m,16m}_device_ms``
  and ``verdict_compares_per_sec`` (the fastest full-contract variant),
  ``frame_evidence_{1m,16m}_device_ms`` (the fastest frame_min-only one).
- ``timestamp``    (``bench_timestamp_match``): the plain-torch timestamp
  match against 2^20 videos -> ``timestamp_match_p50_ms``.
- ``fragment``     (``bench_fragment_search``): K3, a 768-frame fragment in
  1024 videos x 1024 frames -> ``fragment_search_1m_p50_ms``.
- ``fragment10m``  (``bench_fragment_search_10m``): ``DeviceCorpus.
  locate_fragment`` over ~10M fingerprints in mixed length tiers, built
  with removal churn -> ``fragment_search_10m_p50_ms``.
- ``race_specialized`` (``scripts/race_specialized.py``): full/two-phase,
  frame_min-only and query-nearest-only scans at 2^20 and 2^24.
- ``scale_verdict`` (``scripts/scale_verdict.py``): K4 ``full``,
  ``full_cols`` and ``twophase`` from 2^24 to 2^27 rows (1 GiB of corpus).
- ``boot_restore`` (``bench_boot_restore``): ``DeviceCorpus.load`` of 1M
  fingerprints from the store -> ``boot_restore_1m_s``.
- ``batched_clips`` (``bench_batched_clips``): ``forward_batch`` of 100
  clips x 128 frames (one K1 launch per 64 clips).
- ``decode_roofline``, ``e2e_modes``, ``e2e_scaling``, ``service``
  (``bench_decode_roofline``, ``bench_e2e_modes``, ``bench_e2e_scaling``
  in its four modes, ``bench_service_e2e`` default and fast): 1080p MJPEG
  fixtures through the native libav decoder -> ``decode_only_frames_per_sec``,
  ``e2e_decoded_frames_per_sec*``, ``e2e_h264_frames_per_sec*``,
  ``e2e_streams_frames_per_sec*`` and ``service_e2e_*``, each with the
  reference's definition. Without libav each key is null and
  ``why_null`` (and a log line) says so. The service leg reports its
  plateau (phases repeat until two in a row agree within 15%), every
  phase's rate and the analyzer's stages under ``host``.
- ``e2e_scaling_y4m``, ``service_y4m``: the multistream engine and the
  service on Y4M uploads (no libav) -> ``e2e_streams_y4m_frames_per_sec``
  and ``service_e2e_y4m_*``, keys of the port's own.

Reps are interleaved across modes, fixtures are written once per process
under a directory of its own and moved into place with ``os.replace``.

Every race row names its variant (``k2``, ``k2_frame_min``,
``k2_query_nearest`` for K2; ``k4_<mode>`` for K4), its contract and its
times, and says whether its outputs equal K2's full scan of the same
inputs (the run stops if one does not). Device time is K back-to-back launches on one stream
between CUDA events, divided by K; wall p50 is one call including the copy
of its outputs to the host.

Output: one line per leg on stderr, then on stdout the card's name and
power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``) on a line of its own and one JSON line with every
key. With ``--device cpu`` there is no card: device times are null (not
measured) and host-clock numbers go under ``host``; ``--sizes tiny``
shrinks every leg for that. The record carries every key of ``bench.py``'s
record (``RECORD_KEYS``).
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.ops import align, fused, hamming, phash
from tvidz_tpu_torch.ops.timestamps import timestamp_match_counts

_FULL = dict(fp_block=256, fp_blocks=512, fp_loops=8, fp_reps=5,
             scan_m=128, verdict_n=(1 << 20, 1 << 24), iters=10, chain=50,
             ts_videos=1 << 20, ts_cuts=32,
             frag=(1024, 1024, 768), frag_iters=5,
             frag10=(8192, 768, 1024, 3600, 768), frag10_iters=3,
             race_n=(1 << 20, 1 << 24), race_chain=8,
             scale_n=(1 << 24, 1 << 25, 1 << 26, 1 << 27), scale_chain=8,
             # The ingest legs, at bench.py's sizes: 1080p MJPEG fixtures.
             boot=(1000, 1000), clips=(100, 128), clip_reps=5,
             e2e_hw=(1080, 1920), roofline_frames=120, roofline_reps=5,
             e2e_frames=256, e2e_reps=3, e2e_passes=4,
             streams=(1, 2, 4), stream_frames=512, stream_reps=3,
             service=(8, 256), service_phases=4,
             # The Y4M variants (no libav needed): 180x320 sources.
             y4m_hw=(180, 320), y4m_streams=(1, 2, 4, 8), y4m_stream_frames=512,
             y4m_service=(8, 256))
SIZES = {
    "full": _FULL,
    # chip_smoke.py's short bench phase: the full leg shapes, fewer passes.
    "smoke": {**_FULL, "fp_blocks": 16, "fp_loops": 2, "fp_reps": 3,
              "iters": 5, "chain": 10, "frag_iters": 3,
              "boot": (200, 1000), "clips": (8, 128), "clip_reps": 3,
              "roofline_frames": 24, "roofline_reps": 2, "e2e_frames": 64,
              "e2e_reps": 1, "e2e_passes": 2, "streams": (1, 2),
              "stream_frames": 128, "stream_reps": 1, "service": (8, 128),
              "service_phases": 3, "y4m_streams": (1, 8),
              "y4m_stream_frames": 256, "y4m_service": (8, 128)},
    "tiny": dict(fp_block=16, fp_blocks=4, fp_loops=2, fp_reps=2,
                 scan_m=16, verdict_n=(1 << 11, 1 << 12), iters=2, chain=2,
                 ts_videos=1 << 10, ts_cuts=8,
                 frag=(16, 128, 64), frag_iters=2,
                 frag10=(16, 100, 4, 600, 64), frag10_iters=2,
                 race_n=(1 << 11, 1 << 12), race_chain=2,
                 scale_n=(1 << 12, 1 << 13), scale_chain=2,
                 boot=(20, 50), clips=(3, 8), clip_reps=2,
                 e2e_hw=(48, 64), roofline_frames=8, roofline_reps=2,
                 e2e_frames=24, e2e_reps=1, e2e_passes=1,
                 streams=(1, 2), stream_frames=40, stream_reps=1,
                 service=(2, 40), service_phases=2,
                 y4m_hw=(48, 64), y4m_streams=(1, 2), y4m_stream_frames=40,
                 y4m_service=(2, 40)),
}
LEGS = ("fingerprint", "verdict", "timestamp", "fragment", "fragment10m",
        "race_specialized", "scale_verdict", "boot_restore", "batched_clips",
        "decode_roofline", "e2e_modes", "e2e_scaling", "service",
        "e2e_scaling_y4m", "service_y4m")
# The 256-frame block of the JAX harness at its 90x160 geometry.
FP_HEIGHT, FP_WIDTH = 90, 160

# variant -> (contract, scan(q, corpus, rows) -> (frame_min, q_min, q_arg))
SCANS: Dict[str, tuple] = {
    "k2": ("full", lambda q, c, r: hamming.corpus_min_distance(q, c)),
    "k2_frame_min": ("frame_min", lambda q, c, r: (
        hamming.corpus_frame_min_xor(q, c), None, None)),
    "k2_query_nearest": ("query_nearest", lambda q, c, r: (
        None, *hamming.corpus_min_distance(q, c, frame_min=False)[1:])),
    **{f"k4_{mode}": (
        {"full_cols": "full", "twophase": "full"}.get(mode, mode),
        lambda q, c, r, mode=mode: hamming.corpus_scan_tc(q, c, mode, r))
       for mode in hamming.MODES},
}
VERDICT_VARIANTS = tuple(SCANS)
SPECIALIZED_VARIANTS = ("k4_twophase", "k4_frame_min", "k4_query_nearest",
                        "k2", "k2_frame_min", "k2_query_nearest")
SCALE_VARIANTS = ("k4_full", "k4_full_cols", "k4_twophase")


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def card_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or a note that the
    run had none."""
    if dev.type != "cuda":
        return "no CUDA card (device cpu): device times not measured"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[dev.index or 0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_ms(fn: Callable[[int], object], k: int,
              dev: torch.device) -> Optional[float]:
    """Mean device ms of ``fn(0) .. fn(k-1)`` launched back to back on the
    current stream between two CUDA events; None off the card."""
    if dev.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _sync(dev)
    start.record()
    for i in range(k):
        fn(i)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / k


def wall_p50_ms(fn: Callable[[], object], iters: int) -> float:
    """Median host ms of one call whose outputs are copied to the host."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        for o in (out if isinstance(out, tuple) else (out,)):
            if isinstance(o, torch.Tensor):
                o.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _random_rows(n: int, dev: torch.device, gen: torch.Generator) -> torch.Tensor:
    """(n, 2) int32 uniformly random packed rows, made on the device."""
    return torch.randint(-2 ** 31, 2 ** 31, (n, 2), dtype=torch.int32,
                         device=dev, generator=gen)


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def race(n: int, m: int, variants, dev: torch.device, iters: int, chain: int,
         seed: int = 1) -> List[dict]:
    """Time each scan variant on one random (M, N) input; every variant's
    outputs are held against K2's full scan of the same input."""
    gen = _generator(dev, seed)
    corpus = _random_rows(n, dev, gen)
    query = _random_rows(m, dev, gen)
    qs = [_random_rows(m, dev, gen) for _ in range(chain)]
    rows_table = torch.arange(n, dtype=torch.int32, device=dev)
    want = hamming.corpus_min_distance(query, corpus)
    out = []
    for name in variants:
        contract, scan = SCANS[name]
        got = scan(query, corpus, rows_table)                        # warm-up
        agree = all(g is None or torch.equal(g, w) for g, w in zip(got, want))
        wall = wall_p50_ms(lambda: scan(query, corpus, rows_table), iters)
        dev_ms = device_ms(lambda i: scan(qs[i], corpus, rows_table), chain, dev)
        row = {"variant": name, "contract": contract, "n": n, "m": m,
               "device_ms": dev_ms, "wall_p50_ms": wall, "agree": agree}
        if dev_ms is not None:
            row["compares_per_sec"] = m * n / (dev_ms * 1e-3)
        _log(f"race [{name}] ({contract}) M={m} N={n:,}: device "
             f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}, "
             f"wall p50 {wall:.3f} ms, agrees with K2: {agree}")
        if not agree:
            raise RuntimeError(f"scan variant {name} disagrees with K2 at N={n}")
        out.append(row)
    del corpus, qs, rows_table
    return out


def _best(rows: List[dict], contract: str, key: str) -> Optional[dict]:
    cands = [r for r in rows if r["contract"] == contract and r[key] is not None]
    return min(cands, key=lambda r: r[key]) if cands else None


def _frames_per_s(one_pass, carry, frames: int, reps: int):
    """(median, best) frames/s of ``reps`` timed passes after a warm-up
    pass; each pass threads ``carry`` on and ends in one synchronise."""
    carry = one_pass(carry)                                          # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        carry = one_pass(carry)
        times.append(time.perf_counter() - t0)
    return frames / float(np.median(times)), frames / float(np.min(times))


def bench_fingerprint_throughput(dev, sz) -> dict:
    """Single-dispatch streaming throughput, as ``bench.py``'s
    ``bench_fingerprint_throughput`` measures it: ``fp_blocks`` x
    ``fp_block`` contiguous random frames fingerprinted by one K1 launch
    per loop, ``fp_loops`` loops a pass with the scene carry threaded
    through, one synchronise per pass; frames/s per pass, median and best
    of ``fp_reps``. The same frames issued from Python one ``fp_block``
    block at a time (one launch each) are logged beside it."""
    t_blk, n_blk, loops = sz["fp_block"], sz["fp_blocks"], sz["fp_loops"]
    gen = _generator(dev, 0)
    data = torch.randint(0, 256, (n_blk * t_blk, FP_HEIGHT, FP_WIDTH),
                         dtype=torch.uint8, device=dev, generator=gen)
    left, right = phash.hash_operators(FP_HEIGHT, FP_WIDTH, dev)
    carry = fused.initial_fingerprint_carry(FP_HEIGHT, FP_WIDTH, dev)
    frames = n_blk * t_blk * loops

    def stream_pass(carry):
        for _ in range(loops):
            _, _, carry = fused.fingerprint_block(data, carry, left, right)
        _sync(dev)
        return carry

    def block_pass(carry):
        for _ in range(loops):
            for b in range(0, n_blk * t_blk, t_blk):
                _, _, carry = fused.fingerprint_block(data[b:b + t_blk], carry,
                                                      left, right)
        _sync(dev)
        return carry

    med, best = _frames_per_s(stream_pass, carry, frames, sz["fp_reps"])
    blk_med, blk_best = _frames_per_s(block_pass, carry, frames, sz["fp_reps"])
    _log(f"fingerprint: median {med:,.0f} / best {best:,.0f} frames/s, one "
         f"launch over {n_blk * t_blk} frames per loop ({frames} frames per "
         f"pass, {FP_HEIGHT}x{FP_WIDTH}); issued per {t_blk}-frame block: "
         f"median {blk_med:,.0f} / best {blk_best:,.0f} frames/s")
    return {"median": med, "best": best, "per_block_median": blk_med,
            "per_block_best": blk_best}


def bench_verdict_latency(dev, sz, n: int) -> dict:
    """Every scan variant at M=scan_m against ``n`` rows; the fastest device
    time per contract."""
    rows = race(n, sz["scan_m"], VERDICT_VARIANTS, dev, sz["iters"], sz["chain"])
    key = "device_ms" if dev.type == "cuda" else "wall_p50_ms"
    full, fmin = _best(rows, "full", key), _best(rows, "frame_min", key)
    return {"rows": rows, "full": full, "frame_min": fmin}


def bench_timestamp_match(dev, sz) -> float:
    """p50 ms of one timestamp query (8 real cuts + 8 random) against
    ``ts_videos`` rows of ``ts_cuts`` cuts, counts copied back."""
    rng = np.random.default_rng(2)
    n, k = sz["ts_videos"], sz["ts_cuts"]
    corpus = rng.uniform(0, 3600, size=(n, k)).astype(np.float32)
    query = np.concatenate([corpus[min(12345, n - 1), :8],
                            rng.uniform(0, 3600, size=8).astype(np.float32)])
    c = torch.from_numpy(corpus).to(dev)
    lens = torch.full((n,), k, dtype=torch.int32, device=dev)
    q = torch.from_numpy(query).to(dev)
    fn = lambda: timestamp_match_counts(q, c, lens, block_n=65536)  # noqa: E731
    counts = fn()
    if int(counts[min(12345, n - 1)]) < 8:
        raise RuntimeError("timestamp match missed the planted video")
    p50 = wall_p50_ms(fn, sz["iters"])
    _log(f"timestamp match: p50 {p50:.3f} ms vs {n:,} videos")
    return p50


def bench_fragment_search(dev, sz) -> float:
    """p50 ms of one K3 fragment search (``tq`` frames taken from video 123
    at offset 100) over V videos x Tc frames, results copied back."""
    v, tc, tq = sz["frag"]
    rng = np.random.default_rng(7)
    corpus = rng.integers(0, 2 ** 32, size=(v, tc, 2), dtype=np.uint32)
    target, start = min(123, v - 1), 100 if tc >= tq + 100 else 0
    q = np.full((-(-tq // 64) * 64, 2), 0xFFFFFFFF, np.uint32)
    q[:tq] = corpus[target, start:start + tq]
    to = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    c, q_d = to(corpus), to(q)
    lens = torch.full((v,), tc, dtype=torch.int32, device=dev)
    fn = lambda: align.fragment_search(q_d, tq, c, lens)  # noqa: E731
    offs, scores = fn()
    best = int(torch.argmax(scores))
    if best != target or int(offs[best]) != start:
        raise RuntimeError(f"fragment search missed the plant: video {best}")
    p50 = wall_p50_ms(fn, sz["frag_iters"])
    _log(f"fragment search [K3]: p50 {p50:.3f} ms, {tq}-frame fragment vs "
         f"{v:,} videos / {v * tc:,} fingerprints (planted hit found)")
    return p50


def bench_fragment_search_10m(dev, sz) -> float:
    """p50 ms of ``DeviceCorpus.locate_fragment`` over mixed length tiers:
    n_short videos of t_short frames (every 64th a removal) and n_long of
    t_long frames appended in two stages (each migrates a tier)."""
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus

    n_short, t_short, n_long, t_long, tq = sz["frag10"]
    rng = np.random.default_rng(11)
    c = DeviceCorpus(fp_initial_capacity=1 << 22, fp_block_n=8192,
                     hamming_threshold=10, device=dev)
    short_fp = rng.integers(0, 2 ** 32, size=(n_short, t_short, 2),
                            dtype=np.uint32)
    t0 = time.perf_counter()
    for v in range(n_short):
        c.append_fingerprints(v, short_fp[v])
        if v % 64 == 63:
            c.remove_video(v - 32)
    long_fp = rng.integers(0, 2 ** 32, size=(t_long, 2), dtype=np.uint32)
    half = t_long // 2
    for v in range(n_long):
        c.append_fingerprints(n_short + v, np.bitwise_xor(long_fp[:half], v))
        c.append_fingerprints(n_short + v, np.bitwise_xor(long_fp[half:], v))
    build_s = time.perf_counter() - t0
    target = 4321 if n_short > 4321 else n_short // 2
    start = min(100, t_short // 4)
    q = short_fp[target, start:start + tq]     # cut at the video's end
    hits = c.locate_fragment(q, top_k=3)                  # warm: places buckets
    if not hits or hits[0][:2] != (target, start):
        raise RuntimeError(f"fragment search 10m missed the plant: {hits[:1]}")
    p50 = wall_p50_ms(lambda: c.locate_fragment(q, top_k=3), sz["frag10_iters"])
    _log(f"fragment search 10M: p50 {p50:.3f} ms, {tq}-frame fragment vs "
         f"{c.num_fingerprints:,} fingerprints in mixed tiers (build "
         f"{build_s:.1f} s host; planted hit found)")
    return p50


def race_specialized(dev, sz) -> List[dict]:
    """The specialised halves against the full two-phase scan, per size."""
    return [r for n in sz["race_n"] for r in race(
        n, sz["scan_m"], SPECIALIZED_VARIANTS, dev, sz["iters"], sz["race_chain"])]


def scale_verdict(dev, sz) -> List[dict]:
    """K4 full, full_cols and twophase as the corpus grows."""
    return [r for n in sz["scale_n"] for r in race(
        n, sz["scan_m"], SCALE_VARIANTS, dev, sz["iters"], sz["scale_chain"])]


# -- the ingest legs (bench.py:227-900) ------------------------------------------

_FIXTURE_DIR: Optional[str] = None


def _fixture(name: str, write: Callable[[str], None]) -> str:
    """A fixture file under a directory of this process (created once,
    removed at exit), written under a temporary name and moved into place
    with ``os.replace``: two bench runs never share a path, and no reader
    sees a partial file (the reference's fixed temp paths could)."""
    global _FIXTURE_DIR
    if _FIXTURE_DIR is None:
        _FIXTURE_DIR = tempfile.mkdtemp(prefix=f"tvidz-bench-{os.getpid()}-")
        atexit.register(shutil.rmtree, _FIXTURE_DIR, True)
    path = os.path.join(_FIXTURE_DIR, name)
    if not os.path.exists(path):
        base, ext = os.path.splitext(path)
        tmp = f"{base}.part{ext}"
        write(tmp)
        os.replace(tmp, path)
    return path


def _native_or_reason() -> Optional[str]:
    """None when the port's native libav decoder builds and loads here,
    else why not (the legs that need it record null and log this)."""
    from tvidz_tpu_torch.decode import native

    if native.available():
        return None
    why = " ".join(str(native._load_error).split())
    return f"native libav decoder not available ({why[:200]})"


def decoder_probe() -> dict:
    """What this machine offers to write and decode the MJPEG and H.264
    fixtures: the port's native libav decoder (loads or not), libavcodec's
    version through pkg-config, the ffmpeg binary's path, and the versions
    of PIL and cv2 (None where absent)."""
    import importlib

    from tvidz_tpu_torch.decode import native

    out: dict = {"native_libav": native.available()}
    pkg_config = shutil.which("pkg-config")
    if pkg_config is None:
        out["pkg_config_libavcodec"] = None
    else:
        r = subprocess.run([pkg_config, "--modversion", "libavcodec"],
                           capture_output=True, text=True, timeout=60)
        out["pkg_config_libavcodec"] = r.stdout.strip() or None
    out["ffmpeg"] = shutil.which("ffmpeg")
    for mod in ("PIL", "cv2"):
        try:
            out[mod] = str(importlib.import_module(mod).__version__)
        except Exception:  # noqa: BLE001 — absent or broken: either is None
            out[mod] = None
    return out


def _mjpeg(name: str, luma: np.ndarray, quality: int = 90) -> str:
    from tvidz_tpu_torch.decode.mjpeg_avi import write_mjpeg_avi

    return _fixture(name, lambda p: write_mjpeg_avi(p, luma, fps=25.0,
                                                    quality=quality))


def _y4m(name: str, luma: np.ndarray) -> str:
    from tvidz_tpu_torch.decode import write_y4m

    return _fixture(name, lambda p: write_y4m(p, luma, fps=25.0))


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def bench_boot_restore(dev, sz) -> float:
    """Seconds to warm a ``DeviceCorpus`` from a populated store (the boot
    path; bench.py:227): n_videos with 12 timestamps and fp_per_video
    random fingerprints each. Host-side; the corpus syncs to the device
    lazily."""
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
    from tvidz_tpu_torch.corpus.store import Store

    n_videos, fp_per_video = sz["boot"]
    rng = np.random.default_rng(5)
    store = Store("sqlite:///:memory:")
    for v in range(n_videos):
        vid = store.add_video(f"bench_{v}.mp4").id
        store.add_timestamps(vid, [float(x) for x in sorted(rng.uniform(0, 600, 12))])
        store.add_fingerprints(vid, rng.integers(0, 2 ** 32, size=(fp_per_video, 2),
                                                 dtype=np.uint32))
    t0 = time.perf_counter()
    c = DeviceCorpus(device=dev)
    c.load(store)
    dt = time.perf_counter() - t0
    if c.num_fingerprints != n_videos * fp_per_video:
        raise RuntimeError(f"boot restore loaded {c.num_fingerprints} fingerprints")
    store.close()
    _log(f"boot restore: {dt:.3f} s for {n_videos:,} videos / "
         f"{n_videos * fp_per_video:,} fingerprints (host-side)")
    return dt


def bench_batched_clips(dev, sz) -> dict:
    """``FingerprintModel.forward_batch`` over n_clips random clips of
    clip_frames 90x160 frames (bench.py:286): one K1 launch per 64 clips on
    the card. Median frames/s of clip_reps calls, each ending in a copy of
    its outputs to the host."""
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel

    n_clips, clip_frames = sz["clips"]
    cfg = Config()
    cfg.pipeline.block_frames = clip_frames
    model = FingerprintModel(cfg, device=dev)
    gen = _generator(dev, 1)
    clips = torch.randint(0, 256, (n_clips, clip_frames, model.height, model.width),
                          dtype=torch.uint8, device=dev, generator=gen)
    launches = fused.K1.launches
    out = model.forward_batch(clips)
    launches = fused.K1.launches - launches
    [o.cpu() for o in out]
    times = []
    for _ in range(sz["clip_reps"]):
        t0 = time.perf_counter()
        [o.cpu() for o in model.forward_batch(clips)]
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    total = n_clips * clip_frames
    _log(f"batched clips: {n_clips} x {clip_frames}f in {dt * 1e3:.2f} ms "
         f"({total / dt:,.0f} frames/s, {n_clips / dt:,.1f} clips/s; "
         f"{launches} K1 launch(es) a call)")
    return {"frames_per_sec": total / dt, "k1_launches_per_call": launches}


def bench_decode_roofline(sz) -> Optional[dict]:
    """Decode-only frames/s of the native decoder on this host, no device
    work (bench.py:436): an MJPEG fixture (full, lowres, dcskim) and, where
    the encoder has them, mpeg4 and h264 (full, lowres); reps interleaved
    across every (codec, mode), median of ``roofline_reps``. Also the dcskim
    ceiling with the host DCT projection of the coefficient mode."""
    from tvidz_tpu_torch.decode import synthetic_video
    from tvidz_tpu_torch.decode.native import NativeDecoder, encode_video

    why = _native_or_reason()
    if why:
        _log(f"decode roofline: {why}; decode_only_frames_per_sec is null")
        return None
    h, w = sz["e2e_hw"]
    luma, _ = synthetic_video(num_frames=sz["roofline_frames"], height=h, width=w,
                              cut_frames=(min(40, sz["roofline_frames"] // 2),),
                              seed=3)
    fixtures = {"mjpeg": _mjpeg("roofline.avi", luma)}
    for codec, name in (("mpeg4", "roofline.mp4"), ("libx264", "roofline_h264.mp4")):
        try:
            fixtures["h264" if codec == "libx264" else codec] = _fixture(
                name, lambda p, c=codec: encode_video(p, luma, fps=25.0, codec=c,
                                                      bit_rate=8_000_000))
        except Exception as e:  # noqa: BLE001 — no such encoder in this libav
            _log(f"decode roofline: {codec} fixture failed ({e})")
    legs = [(codec, mode, path) for codec, path in fixtures.items()
            for mode in (("full", "lowres", "dcskim") if codec == "mjpeg"
                         else ("full", "lowres"))]
    rates = {(c, m): [] for c, m, _ in legs}
    for _rep in range(sz["roofline_reps"]):
        for codec, mode, path in legs:
            dec = NativeDecoder(lowres=mode == "lowres", dct_dc=mode == "dcskim")
            t0 = time.perf_counter()
            n = sum(b.luma.shape[0] for b in dec.blocks(path, 64, 90, 160))
            rates[(codec, mode)].append(n / (time.perf_counter() - t0))
    out = {f"{c}_{m}": _median(rates[(c, m)]) for c, m, _ in legs}
    for key, rate in out.items():
        _log(f"decode roofline: {key} = {rate:,.0f} frames/s per core (median, "
             "interleaved reps, no device work)")
    if "mjpeg_dcskim" in out:
        blk = np.ascontiguousarray(luma[:64, ::max(1, h // 90), ::max(1, w // 160)])
        phash.phash_project_host(blk)
        reps = []
        for _ in range(sz["roofline_reps"]):
            t0 = time.perf_counter()
            phash.phash_project_host(blk)
            reps.append((time.perf_counter() - t0) / blk.shape[0])
        out["mjpeg_dcskim_coeff_adjusted"] = 1.0 / (1.0 / out["mjpeg_dcskim"]
                                                    + _median(reps))
        _log(f"decode roofline: mjpeg dcskim + projection = "
             f"{out['mjpeg_dcskim_coeff_adjusted']:,.0f} frames/s per core")
    return out


def _e2e_once(model, path: str, lowres=False, dct_dc=False, passes: int = 4) -> float:
    """Decoded frames/s of ``passes`` decodes of ``path`` through one
    ``BlockPrefetcher`` into ``model.forward`` (bench.py:542): host decode
    overlapped with the device, one synchronise at the end."""
    import itertools

    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.decode import get_decoder
    from tvidz_tpu_torch.pipeline.prefetch import BlockPrefetcher

    bt = model.block_frames
    dec = get_decoder(path, lowres=lowres, dct_dc=dct_dc)
    t0 = time.perf_counter()
    carry = model.init_carry()
    frames, acc = 0, None
    depth = Config().pipeline.decode_prefetch_blocks
    blocks = itertools.chain.from_iterable(
        dec.blocks(path, bt, model.height, model.width) for _ in range(max(passes, 1)))
    pf = BlockPrefetcher(blocks, depth=depth) if depth > 0 else None
    for block in (pf if pf is not None else blocks):
        t = block.luma.shape[0]
        buf = model.project_payload(block.luma)
        if t < bt:
            buf = np.concatenate([buf, np.repeat(buf[-1:], bt - t, 0)])
        scores, _fps, carry = model.forward(
            torch.from_numpy(np.ascontiguousarray(buf)).to(model.device), carry)
        acc = scores if acc is None else acc + scores
        frames += t
    acc.cpu()
    if pf is not None:
        pf.close()
    return frames / (time.perf_counter() - t0)


def _e2e_models(dev):
    """(luma model, coefficient model) at the production configuration,
    the payload mode pinned whatever the environment says."""
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel

    cfg, cfg_c = Config(), Config()
    cfg.pipeline.ship_dct_coeffs = False
    cfg_c.pipeline.ship_dct_coeffs = True
    return FingerprintModel(cfg, device=dev), FingerprintModel(cfg_c, device=dev)


def bench_e2e_modes(dev, sz) -> Optional[dict]:
    """Single-stream decode + fingerprint of a 1080p fixture (bench.py:590):
    MJPEG full / lowres / dcskim / dcskim with coefficient shipping, h264
    full / fast where the encoder has libx264; reps interleaved across the
    modes, median of ``e2e_reps``."""
    from tvidz_tpu_torch.decode import synthetic_video
    from tvidz_tpu_torch.decode.native import encode_video

    why = _native_or_reason()
    if why:
        _log(f"e2e: {why}; e2e_decoded_frames_per_sec* and "
             "e2e_h264_frames_per_sec* are null")
        return None
    model, model_c = _e2e_models(dev)
    h, w = sz["e2e_hw"]
    luma, _ = synthetic_video(num_frames=sz["e2e_frames"], height=h, width=w,
                              cut_frames=(min(40, sz["e2e_frames"] // 2),), seed=3)
    mjpeg = _mjpeg(f"e2e_{h}p.avi", luma)
    legs = [("mjpeg_full", mjpeg, {}, model),
            ("mjpeg_lowres", mjpeg, {"lowres": True}, model),
            ("mjpeg_dcskim", mjpeg, {"dct_dc": True}, model),
            ("mjpeg_dcskim_coeff", mjpeg, {"dct_dc": True}, model_c)]
    try:
        h264 = _fixture(f"e2e_{h}p.mp4", lambda p: encode_video(
            p, luma, fps=25.0, codec="libx264", bit_rate=8_000_000))
        legs += [("h264_full", h264, {}, model),
                 ("h264_fast", h264, {"lowres": True}, model)]
    except Exception as e:  # noqa: BLE001 — no libx264 in this libav
        _log(f"e2e h264: fixture failed ({e}); e2e_h264_frames_per_sec* are null")
    for m in (model, model_c):
        s0, f0, _ = m.forward(m.example_payload(), m.init_carry())
        s0.cpu()
    rates = {name: [] for name, _, _, _ in legs}
    for _rep in range(sz["e2e_reps"]):
        for name, path, kw, m in legs:
            rates[name].append(_e2e_once(m, path, passes=sz["e2e_passes"], **kw))
    out = {name: _median(r) for name, r in rates.items()}
    for name, rate in out.items():
        _log(f"e2e {h}p decode+hash [{name}]: {rate:,.0f} frames/s (median of "
             f"{sz['e2e_reps']} interleaved; host decode overlapped with device)")
    return out


def _scaling(dev, modes, paths_for, counts, reps, tag) -> dict:
    """{mode: {n: frames/s}}: ``fingerprint_streams`` over n of the
    fixtures ``paths_for(n)`` for every n of ``counts``, reps interleaved
    across the modes and the counts, median of ``reps``. Each mode is
    (name, lowres, dct_dc, ship_coeffs)."""
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel
    from tvidz_tpu_torch.pipeline.multistream import (
        default_max_active,
        fingerprint_streams,
        warm_dispatch,
    )

    models = {}
    for name, lowres, dct_dc, coeffs in modes:
        cfg = Config()
        cfg.pipeline.decode_lowres = lowres
        cfg.pipeline.decode_dct_dc = dct_dc
        cfg.pipeline.ship_dct_coeffs = coeffs
        models[name] = FingerprintModel(cfg, device=dev)
        warm_dispatch(models[name], min(max(counts), default_max_active()))
        fingerprint_streams(paths_for(1), model=models[name])
    stats = {(name, n): [] for name in models for n in counts}
    for _rep in range(reps):
        for name, model in models.items():
            for n in counts:
                launches = fused.K1.launches
                results, st = fingerprint_streams(paths_for(n), model=model)
                errors = [r.error for r in results if r.error]
                if errors:
                    raise RuntimeError(f"e2e scaling [{name}] {n} streams: {errors}")
                stats[(name, n)].append((st, fused.K1.launches - launches))
    curves = {}
    for name in models:
        curves[name] = {}
        for n in counts:
            st, launches = sorted(stats[(name, n)], key=lambda x: x[0].frames_per_s)[
                len(stats[(name, n)]) // 2]
            curves[name][n] = st.frames_per_s
            _log(f"e2e scaling{tag} [{name}]: {n} stream(s) -> "
                 f"{st.frames_per_s:,.0f} decoded+hashed frames/s total "
                 f"({st.frames} frames in {st.wall_s:.2f} s; decode-starved "
                 f"{st.decode_starved_s:.2f} s, dispatch {st.dispatch_s:.2f} s, "
                 f"resolve-blocked {st.resolve_s:.2f} s, resolve-busy "
                 f"{st.resolve_busy_s:.2f} s; {st.dispatches} passes, "
                 f"{launches} K1 launches, {st.frames / max(st.dispatches, 1):.1f} "
                 f"frames a pass; median of {reps})")
    _log(f"e2e scaling{tag}: host has {os.cpu_count()} CPU core(s)")
    return curves


_SCALING_MODES = (("luma", False, False, False), ("fast", True, False, False),
                  ("dcskim", False, True, False), ("dcskim_coeff", False, True, True))


def bench_e2e_scaling(dev, sz) -> Optional[dict]:
    """N concurrent 1080p MJPEG uploads through ``fingerprint_streams``
    (bench.py:699), in the reference's four modes (luma, lowres ``fast``,
    ``dcskim``, ``dcskim`` with coefficient shipping), N in ``streams``."""
    from tvidz_tpu_torch.decode import synthetic_video

    why = _native_or_reason()
    if why:
        _log(f"e2e scaling: {why}; e2e_streams_frames_per_sec* are null")
        return None
    h, w = sz["e2e_hw"]
    luma, _ = synthetic_video(num_frames=sz["stream_frames"], height=h, width=w,
                              cut_frames=(min(40, sz["stream_frames"] // 2),), seed=3)
    path = _mjpeg(f"streams_{h}p_f{sz['stream_frames']}.avi", luma)
    return _scaling(dev, _SCALING_MODES, lambda n: [path] * n, sz["streams"],
                    sz["stream_reps"], "")


def bench_e2e_scaling_y4m(dev, sz) -> dict:
    """The same engine over Y4M uploads at ``y4m_hw`` (the port's Y4M
    decoder, no libav): N concurrent streams of one fixture, N in
    ``y4m_streams``, luma mode. Not a key of bench.py (its uploads are
    MJPEG); it reads the engine's batching where libav is missing."""
    from tvidz_tpu_torch.decode import synthetic_video

    h, w = sz["y4m_hw"]
    n_frames = sz["y4m_stream_frames"]
    luma, _ = synthetic_video(num_frames=n_frames, height=h, width=w,
                              cut_frames=(min(40, n_frames // 2),), seed=3)
    path = _y4m(f"streams_{h}p_f{n_frames}.y4m", luma)
    return _scaling(dev, (("luma", False, False, False),), lambda n: [path] * n,
                    sz["y4m_streams"], sz["stream_reps"], " [y4m]")["luma"]


def _service_fixtures(n_videos: int, num_frames: int, hw, kind: str):
    """The n_videos + 1 service uploads (disjoint cut windows, so no upload
    is a duplicate of another), written once per process."""
    from tvidz_tpu_torch.decode import synthetic_video

    paths = []
    for i in range(n_videos + 1):
        luma, _ = synthetic_video(num_frames=num_frames, height=hw[0], width=hw[1],
                                  cut_frames=(20 + 8 * i, 24 + 8 * i), seed=100 + i)
        name = f"svc_{hw[0]}p_f{num_frames}_{i:02d}.{'avi' if kind == 'mjpeg' else 'y4m'}"
        paths.append(_mjpeg(name, luma) if kind == "mjpeg" else _y4m(name, luma))
    return paths


def bench_service_e2e(dev, sz, fast: bool = False, kind: str = "mjpeg"
                      ) -> Optional[dict]:
    """The service under concurrent load (bench.py:816): S3 put -> SQS
    notify -> an analysis thread per upload -> the shared block dispatcher
    -> store and corpus -> /status, in process, n_videos uploads at once.
    Phases of the same workload (fresh names, the store cleared between)
    repeat until two in a row differ by less than 15% or ``service_phases``
    ran; the last one (the plateau) is reported, every phase's rate is
    returned under ``phases``. ``fast``: DC-skim decode and coefficient
    shipping. ``kind``: the uploads' format, 1080p MJPEG (bench.py's) or
    Y4M at ``y4m_hw``."""
    import json as _json
    import shutil as _shutil

    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
    from tvidz_tpu_torch.corpus.store import Store
    from tvidz_tpu_torch.service.app import create_app
    from tvidz_tpu_torch.service.fakes import FakeS3, FakeSQS

    tag = (" [fast]" if fast else "") + (" [y4m]" if kind == "y4m" else "")
    if kind == "mjpeg":
        why = _native_or_reason()
        if why:
            _log(f"service e2e{tag}: {why}; its service_e2e keys are null")
            return None
    n_videos, num_frames = sz["y4m_service" if kind == "y4m" else "service"]
    hw = sz["y4m_hw" if kind == "y4m" else "e2e_hw"]
    workdir = tempfile.mkdtemp(prefix=f"tvidz-bench-svc-{os.getpid()}-")
    cfg = Config()
    cfg.pipeline.decode_dct_dc = fast
    cfg.pipeline.ship_dct_coeffs = fast
    cfg.pipeline.decode_lowres = False
    cfg.pipeline.tmp_dir = os.path.join(workdir, "work")
    os.makedirs(cfg.pipeline.tmp_dir)
    sqs, s3 = FakeSQS(), FakeS3(os.path.join(workdir, "s3"))
    sqs.create_queue(cfg.service.sqs_queue)
    s3.create_bucket(cfg.service.s3_bucket)
    app = create_app(config=cfg, store=Store("sqlite:///:memory:"),
                     corpus=DeviceCorpus(device=dev), s3=s3, sqs=sqs, device=dev)
    client = app.wsgi.test_client()
    ext = "avi" if kind == "mjpeg" else "y4m"
    try:
        paths = _service_fixtures(n_videos, num_frames, hw, kind)

        def run_upload(idx, prefix):
            name = f"{prefix}svc-{idx:02d}.{ext}"
            s3.put_file(cfg.service.s3_bucket, name, paths[idx])
            r = client.post("/notify", json_body={"Records": [{"s3": {
                "bucket": {"name": cfg.service.s3_bucket}, "object": {"key": name}}}]})
            if r.status_code != 200:
                raise RuntimeError(f"service e2e: /notify {r.status_code}")
            return name

        def wait_done(names, deadline_s=1200):
            deadline = time.perf_counter() + deadline_s
            pending = set(names)
            while pending:
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"service e2e: stuck on {pending}")
                for name in list(pending):
                    st = client.get(f"/status/{name}").get_json()
                    if st.get("status") == "done":
                        pending.discard(name)
                    elif st.get("status") == "error":
                        raise RuntimeError(f"{name}: {st}")
                time.sleep(0.05)

        wait_done([run_upload(n_videos, "warm-")])   # loads kernels, pools
        phases = []
        for phase in range(1, sz["service_phases"] + 1):
            if phase > 1:
                if client.post("/admin/clear-db").status_code != 200:
                    raise RuntimeError("service e2e: clear-db failed")
                wait_done([run_upload(n_videos, f"warm{phase}-")])
            met0 = client.get("/metrics").get_json()
            t0 = time.perf_counter()
            wait_done([run_upload(i, f"p{phase}-") for i in range(n_videos)])
            dt = time.perf_counter() - t0
            met1 = client.get("/metrics").get_json()
            phases.append((dt, met0, met1))
            _log(f"service e2e{tag} phase {phase}: {n_videos / dt * 60.0:.1f} "
                 "videos/min")
            if phase > 1 and abs(phases[-1][0] / phases[-2][0] - 1.0) < 0.15:
                break
        dt, met0, met1 = phases[-1]
        m0, m1 = met0["block_dispatcher"], met1["block_dispatcher"]
        passes, blocks = m1["passes"] - m0["passes"], m1["blocks"] - m0["blocks"]
        st0, st1 = met0.get("stage_timings", {}), met1.get("stage_timings", {})
        stages = {k: {"s": st1[k]["total_s"] - st0.get(k, {}).get("total_s", 0.0),
                      "n": st1[k]["count"] - st0.get(k, {}).get("count", 0)}
                  for k in st1}
        out = {"videos_per_min": n_videos / dt * 60.0,
               "frames_per_sec": n_videos * num_frames / dt,
               "blocks_per_pass": blocks / passes if passes else 0.0,
               "phases_videos_per_min": [n_videos / p[0] * 60.0 for p in phases],
               "stages": stages}
        _log(f"service e2e{tag}: {n_videos} concurrent {hw[0]}p {kind} uploads of "
             f"{num_frames} frames in {dt:.2f} s (phase {len(phases)}, the "
             f"plateau) = {out['videos_per_min']:.1f} videos/min, "
             f"{out['frames_per_sec']:,.0f} frames/s, dispatcher "
             f"{out['blocks_per_pass']:.2f} blocks/pass ({blocks} blocks in "
             f"{passes} passes); analyzer stage wall summed across threads: "
             f"{_json.dumps(stages)}")
        return out
    finally:
        app.stop()
        _shutil.rmtree(workdir, ignore_errors=True)


# bench.py's record keys (bench.py:1088-1190), each with the leg that
# measures it; every one is in the port's record, null with a reason in
# ``why_null`` (and on an earlier log line) when it was not measured.
RECORD_KEYS = {
    "value": "fingerprint", "best": "fingerprint",
    "vs_baseline": "fingerprint",
    "e2e_decoded_frames_per_sec": "e2e_modes", "vs_baseline_e2e": "e2e_modes",
    "e2e_decoded_frames_per_sec_fast": "e2e_modes",
    "vs_baseline_e2e_fast": "e2e_modes",
    "e2e_decoded_frames_per_sec_dcskim": "e2e_modes",
    "vs_baseline_e2e_dcskim": "e2e_modes",
    "e2e_decoded_frames_per_sec_dcskim_coeff": "e2e_modes",
    "vs_baseline_e2e_dcskim_coeff": "e2e_modes",
    "e2e_h264_frames_per_sec": "e2e_modes",
    "e2e_h264_frames_per_sec_fast": "e2e_modes",
    "decode_only_frames_per_sec": "decode_roofline",
    "verdict_1m_device_ms": "verdict", "verdict_compares_per_sec": "verdict",
    "frame_evidence_1m_device_ms": "verdict",
    "verdict_16m_device_ms": "verdict", "frame_evidence_16m_device_ms": "verdict",
    "fragment_search_1m_p50_ms": "fragment",
    "fragment_search_10m_p50_ms": "fragment10m",
    "e2e_streams_frames_per_sec": "e2e_scaling",
    "e2e_streams_frames_per_sec_fast": "e2e_scaling",
    "e2e_streams_frames_per_sec_dcskim": "e2e_scaling",
    "e2e_streams_frames_per_sec_dcskim_coeff": "e2e_scaling",
    "boot_restore_1m_s": "boot_restore",
    "service_e2e_videos_per_min": "service", "service_e2e_frames_per_sec": "service",
    "service_e2e_blocks_per_pass": "service",
    "service_e2e_fast_videos_per_min": "service",
    "service_e2e_fast_frames_per_sec": "service",
}
# The JAX harness's baseline for vs_baseline* (bench.py:1098).
BASELINE_FRAMES_PER_SEC = 20000.0
_E2E_KEYS = {"mjpeg_full": "", "mjpeg_lowres": "_fast", "mjpeg_dcskim": "_dcskim",
             "mjpeg_dcskim_coeff": "_dcskim_coeff"}


def run(device=None, sizes: str = "full", legs=LEGS) -> dict:
    """Run ``legs`` and return the record: every key of bench.py's record
    (``RECORD_KEYS``; a key not measured is null, with its reason in
    ``why_null``), the race rows, and host-clock numbers under ``host``."""
    dev = backend.resolve_device(device)
    sz = SIZES[sizes]
    cut = [f"{k}={v}" for k, v in sz.items()] if sizes != "full" else []
    if cut:
        _log(f"sizes cut to '{sizes}': {', '.join(cut)}")
    on_card = dev.type == "cuda"
    rec: dict = {"metric": "1080p_frames_fingerprinted_per_sec_per_chip",
                 "unit": "frames/s", "device_only": True, "device": str(dev),
                 "sizes": sizes, **{k: None for k in RECORD_KEYS},
                 "timestamp_match_p50_ms": None, "race": [], "host": {}}
    why: Dict[str, str] = {}

    def put(key, value, reason=None):
        """A measured number under ``key`` on the card; off the card it goes
        under ``host`` (a host-clock number, not the card's)."""
        if value is None:
            why[key] = reason
        elif on_card:
            rec[key] = value
        else:
            rec["host"][key] = value
            why[key] = "device cpu: the host-clock number is under host"

    if "fingerprint" in legs:
        fp = bench_fingerprint_throughput(dev, sz)
        put("value", fp["median"])
        put("best", fp["best"])
        put("vs_baseline", fp["median"] / BASELINE_FRAMES_PER_SEC)
        put("fingerprint_best_frames_per_sec", fp["best"])
        put("fingerprint_per_block_frames_per_sec", fp["per_block_median"])
    if "verdict" in legs:
        for n, tag in zip(sz["verdict_n"], ("1m", "16m")):
            v = bench_verdict_latency(dev, sz, n)
            rec["race"] += v["rows"]
            if on_card:
                rec[f"verdict_{tag}_device_ms"] = v["full"]["device_ms"]
                rec[f"frame_evidence_{tag}_device_ms"] = v["frame_min"]["device_ms"]
                rec[f"verdict_{tag}_variant"] = v["full"]["variant"]
                rec[f"frame_evidence_{tag}_variant"] = v["frame_min"]["variant"]
                if tag == "1m":
                    rec["verdict_compares_per_sec"] = v["full"]["compares_per_sec"]
            else:
                rec["host"][f"verdict_{tag}_wall_p50_ms"] = v["full"]["wall_p50_ms"]
                rec["host"][f"frame_evidence_{tag}_wall_p50_ms"] = v["frame_min"]["wall_p50_ms"]
                for k in (f"verdict_{tag}_device_ms", f"frame_evidence_{tag}_device_ms",
                          "verdict_compares_per_sec"):
                    why[k] = "device cpu: device times not measured"
    if "timestamp" in legs:
        rec["timestamp_match_p50_ms"] = bench_timestamp_match(dev, sz)
    if "fragment" in legs:
        rec["fragment_search_1m_p50_ms"] = bench_fragment_search(dev, sz)
    if "fragment10m" in legs:
        rec["fragment_search_10m_p50_ms"] = bench_fragment_search_10m(dev, sz)
    if "race_specialized" in legs:
        rec["race"] += race_specialized(dev, sz)
    if "scale_verdict" in legs:
        rec["race"] += scale_verdict(dev, sz)
    if "boot_restore" in legs:
        # Host-side on any device (bench.py's own key is the host time).
        rec["boot_restore_1m_s"] = bench_boot_restore(dev, sz)
    if "batched_clips" in legs:
        clips = bench_batched_clips(dev, sz)
        put("batched_clips_frames_per_sec", clips["frames_per_sec"])
        rec["batched_clips_k1_launches_per_call"] = clips["k1_launches_per_call"]
    native_why = _native_or_reason()
    rec["host"]["decoders"] = decoder_probe()
    _log(f"decoders here: {json.dumps(rec['host']['decoders'])}")
    if "decode_roofline" in legs:
        # Host-only by definition: no device work.
        rec["decode_only_frames_per_sec"] = bench_decode_roofline(sz)
        if rec["decode_only_frames_per_sec"] is None:
            why["decode_only_frames_per_sec"] = native_why
    if "e2e_modes" in legs:
        e2e = bench_e2e_modes(dev, sz) or {}
        for name, suffix in _E2E_KEYS.items():
            r = e2e.get(name)
            put(f"e2e_decoded_frames_per_sec{suffix}", r, native_why)
            put(f"vs_baseline_e2e{suffix}",
                None if r is None else r / BASELINE_FRAMES_PER_SEC, native_why)
        h264_why = native_why or "no libx264 encoder in this libav"
        put("e2e_h264_frames_per_sec", e2e.get("h264_full"), h264_why)
        put("e2e_h264_frames_per_sec_fast", e2e.get("h264_fast"), h264_why)
    if "e2e_scaling" in legs:
        curves = bench_e2e_scaling(dev, sz) or {}
        for name, _, _, _ in _SCALING_MODES:
            key = "e2e_streams_frames_per_sec" + ("" if name == "luma" else f"_{name}")
            c = curves.get(name)
            put(key, None if c is None else {str(n): v for n, v in c.items()},
                native_why)
    if "service" in legs:
        for fast, prefix in ((False, "service_e2e"), (True, "service_e2e_fast")):
            svc = bench_service_e2e(dev, sz, fast=fast)
            fields = ("videos_per_min", "frames_per_sec") + (
                () if fast else ("blocks_per_pass",))
            for f in fields:
                put(f"{prefix}_{f}", None if svc is None else svc[f], native_why)
            if svc is not None:
                rec["host"][f"{prefix}_phases_videos_per_min"] = svc["phases_videos_per_min"]
                rec["host"][f"{prefix}_stages"] = svc["stages"]
                if fast:
                    rec["service_e2e_fast_blocks_per_pass"] = svc["blocks_per_pass"]
    if "e2e_scaling_y4m" in legs:
        curve = bench_e2e_scaling_y4m(dev, sz)
        put("e2e_streams_y4m_frames_per_sec", {str(n): v for n, v in curve.items()})
    if "service_y4m" in legs:
        svc = bench_service_e2e(dev, sz, kind="y4m")
        for f in ("videos_per_min", "frames_per_sec", "blocks_per_pass"):
            put(f"service_e2e_y4m_{f}", svc[f])
        rec["host"]["service_e2e_y4m_phases_videos_per_min"] = svc["phases_videos_per_min"]
        rec["host"]["service_e2e_y4m_stages"] = svc["stages"]
    for key, leg in RECORD_KEYS.items():
        if rec[key] is None and key not in why:
            why[key] = f"leg {leg!r} not run" if leg not in legs else "not measured"
    rec["why_null"] = {k: v for k, v in why.items() if rec.get(k) is None}
    for key, reason in rec["why_null"].items():
        _log(f"{key}: null ({reason})")
    return rec


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="tvidz_tpu_torch bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; $TVIDZ_TORCH_DEVICE) or cpu")
    ap.add_argument("--sizes", choices=sorted(SIZES), default="full")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help=f"comma-separated subset of {','.join(LEGS)}")
    args = ap.parse_args(argv)
    legs = tuple(x for x in args.legs.split(",") if x)
    unknown = set(legs) - set(LEGS)
    if unknown:
        ap.error(f"unknown legs {sorted(unknown)}")
    rec = run(args.device, args.sizes, legs)
    print(card_line(backend.resolve_device(args.device)))
    print(json.dumps(rec))
    return 0
