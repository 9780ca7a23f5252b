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
shrinks every leg for that. Which legs the JAX harness has and this one
does not yet is in ROADMAP.md.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
             scale_n=(1 << 24, 1 << 25, 1 << 26, 1 << 27), scale_chain=8)
SIZES = {
    "full": _FULL,
    # chip_smoke.py's short bench phase: the full leg shapes, fewer passes.
    "smoke": {**_FULL, "fp_blocks": 16, "fp_loops": 2, "fp_reps": 3,
              "iters": 5, "chain": 10, "frag_iters": 3},
    "tiny": dict(fp_block=16, fp_blocks=4, fp_loops=2, fp_reps=2,
                 scan_m=16, verdict_n=(1 << 11, 1 << 12), iters=2, chain=2,
                 ts_videos=1 << 10, ts_cuts=8,
                 frag=(16, 128, 64), frag_iters=2,
                 frag10=(16, 100, 4, 600, 64), frag10_iters=2,
                 race_n=(1 << 11, 1 << 12), race_chain=2,
                 scale_n=(1 << 12, 1 << 13), scale_chain=2),
}
LEGS = ("fingerprint", "verdict", "timestamp", "fragment", "fragment10m",
        "race_specialized", "scale_verdict")
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


def run(device=None, sizes: str = "full", legs=LEGS) -> dict:
    """Run ``legs`` and return the record (every key present; a leg not run
    or a device number not measured is null)."""
    dev = backend.resolve_device(device)
    sz = SIZES[sizes]
    cut = [f"{k}={v}" for k, v in sz.items()] if sizes != "full" else []
    if cut:
        _log(f"sizes cut to '{sizes}': {', '.join(cut)}")
    on_card = dev.type == "cuda"
    rec: dict = {"device": str(dev), "sizes": sizes, "value": None,
                 "verdict_1m_device_ms": None, "verdict_16m_device_ms": None,
                 "verdict_compares_per_sec": None,
                 "frame_evidence_1m_device_ms": None,
                 "frame_evidence_16m_device_ms": None,
                 "timestamp_match_p50_ms": None,
                 "fragment_search_1m_p50_ms": None,
                 "fragment_search_10m_p50_ms": None,
                 "race": [], "host": {}}
    if "fingerprint" in legs:
        fp = bench_fingerprint_throughput(dev, sz)
        if on_card:
            rec["value"] = fp["median"]
            rec["fingerprint_best_frames_per_sec"] = fp["best"]
            rec["fingerprint_per_block_frames_per_sec"] = fp["per_block_median"]
        else:
            rec["host"]["fingerprint_frames_per_sec"] = fp["median"]
            rec["host"]["fingerprint_per_block_frames_per_sec"] = fp["per_block_median"]
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
