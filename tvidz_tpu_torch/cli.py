"""tvidz_tpu_torch command-line interface.

    python -m tvidz_tpu_torch analyze video.y4m --db sqlite:///corpus.db
    python -m tvidz_tpu_torch ingest videos/ --db sqlite:///corpus.db
    python -m tvidz_tpu_torch fingerprint video.y4m -o fp.npz
    python -m tvidz_tpu_torch search fragment.y4m --db sqlite:///corpus.db
    python -m tvidz_tpu_torch serve --fake-aws --port 5055
    python -m tvidz_tpu_torch bench [--device cpu] [--sizes tiny]
    python -m tvidz_tpu_torch evict-host host-2 --db sqlite:///shared.db

The same commands and JSON output as ``tvidz_tpu/cli.py``, plus
``--device`` (default ``$TVIDZ_TORCH_DEVICE``, else ``cuda``; ``cpu`` runs
the kernels' plain PyTorch versions; ``serve`` passes it on to the
entrypoint with its other arguments, ``bench`` to ``tvidz_tpu_torch.bench``).
``evict-host`` works on the shared store alone and needs no device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def _local_session(db_url: str, device=None):
    """(analyzer, store, corpus) wired for local files: the 'bucket' is the
    filesystem and keys are paths."""
    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.corpus.store import Store
    from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
    from tvidz_tpu_torch.pipeline.analyzer import Analyzer
    from tvidz_tpu_torch.pipeline.progress import AnalysisRegistry

    config = Config()
    store = Store(db_url)
    corpus = DeviceCorpus(
        max_cuts=config.match.max_cuts,
        words=config.hash.words,
        hamming_threshold=config.match.hamming_threshold,
        device=device,
    )
    corpus.load(store)

    def fetcher(bucket: str, key: str, local_path: str) -> None:
        src = os.path.join(bucket, key) if bucket else key
        if not os.path.exists(src):
            raise FileNotFoundError(src)
        shutil.copy(src, local_path)

    return Analyzer(store, corpus, AnalysisRegistry(), fetcher, config), store, corpus


def _analyze_once(analyzer, directory: str, name: str):
    """One analysis; a store down for the whole run becomes the
    reference-parity error result (the CLI has no retry loop)."""
    from tvidz_tpu_torch.pipeline.analyzer import (
        AnalysisResult,
        TransientAnalysisError,
    )

    try:
        return analyzer.analyze(directory, name)
    except TransientAnalysisError as e:
        return AnalysisResult(
            analysis_key=e.analysis_key,
            video_id=e.video_id if e.video_id is not None else -1,
            status="error", scene_cuts=[], duplicates=[], error=str(e),
        )


def cmd_analyze(args) -> int:
    analyzer, store, corpus = _local_session(args.db, args.device)
    path = os.path.abspath(args.video)
    result = _analyze_once(analyzer, os.path.dirname(path),
                           os.path.basename(path))
    out = {
        "file": args.video,
        "status": result.status,
        "video_id": result.video_id,
        "scene_cuts": result.scene_cuts,
        "duplicates": result.duplicates,
    }
    if result.error:
        out["error"] = result.error
    fps = store.get_fingerprints(result.video_id)
    out["fingerprinted_frames"] = int(fps.shape[0]) if fps is not None else 0
    print(json.dumps(out, indent=None if args.compact else 2))
    return 0 if result.status == "done" else 1


def cmd_fingerprint(args) -> int:
    import numpy as np

    from tvidz_tpu_torch.config import Config
    from tvidz_tpu_torch.decode import get_decoder
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel

    config = Config()
    model = FingerprintModel(config, device=args.device)
    info = get_decoder(args.video).probe(args.video)
    cuts, fps = model.analyze_path(args.video)
    if args.output:
        np.savez(args.output, fingerprints=fps,
                 scene_cuts=np.asarray(cuts, np.float64))
    print(json.dumps({
        "file": args.video,
        "frames": int(fps.shape[0]),
        "fps": info.fps,
        "algorithm": config.hash.algorithm,
        "scene_cuts": cuts,
        "output": args.output,
    }))
    return 0


def cmd_ingest(args) -> int:
    """Batch-build a corpus from a directory of videos."""
    analyzer, store, corpus = _local_session(args.db, args.device)
    exts = tuple(e.strip().lstrip(".") for e in args.ext.split(","))
    files = sorted(
        f for f in os.listdir(args.directory)
        if f.lower().endswith(tuple("." + e for e in exts))
    )
    results = []
    for name in files:
        res = _analyze_once(analyzer, args.directory, name)
        results.append({
            "file": name,
            "status": res.status,
            "cuts": len(res.scene_cuts),
            "duplicates": res.duplicates,
            **({"error": res.error} if res.error else {}),
        })
        print(json.dumps(results[-1]), flush=True)
    done = sum(1 for r in results if r["status"] == "done")
    print(json.dumps({
        "ingested": done, "failed": len(results) - done,
        "corpus_videos": corpus.num_videos,
        "corpus_fingerprints": corpus.num_fingerprints,
    }))
    return 0 if done == len(results) else 1


def cmd_search(args) -> int:
    """Search a video against the corpus without adding it: timestamp
    matches, fingerprint evidence and the best fragment alignments."""
    from tvidz_tpu_torch.models.fingerprint import FingerprintModel

    analyzer, store, corpus = _local_session(args.db, args.device)
    config = analyzer.config
    model = FingerprintModel(config, device=corpus.device)
    cuts, fps = model.analyze_path(args.video)

    ts_matches = corpus.match_timestamps(
        cuts, min_match=config.match.min_match,
        tolerance=config.match.timestamp_tolerance,
    )
    # Each QUERY frame credits its nearest corpus video at most once, as in
    # the analyzer and /search/video.
    fp_counts = corpus.nearest_video_counts(fps)
    fp_matches = sorted(
        ((v, c) for v, c in fp_counts.items() if c >= config.match.fp_min_match),
        key=lambda vc: -vc[1],
    )
    frag = corpus.locate_fragment(fps, top_k=args.top_k)

    def resolve(vid):
        v = store.get_video_by_id(vid)
        return v.filename if v else None

    print(json.dumps({
        "file": args.video,
        "scene_cuts": cuts,
        "timestamp_matches": [
            {"video_id": v, "filename": resolve(v), "matching_timestamps": c}
            for v, c in ts_matches
        ],
        "fingerprint_matches": [
            {"video_id": v, "filename": resolve(v), "matching_frames": c}
            for v, c in fp_matches
        ],
        "best_alignments": [
            {"video_id": v, "filename": resolve(v), "offset_frames": o,
             "match_count": s}
            for v, o, s in frag
        ],
    }, indent=2))
    return 0


def cmd_serve(extra) -> int:
    from tvidz_tpu_torch.service.entrypoint import main as serve_main

    serve_main(extra)
    return 0


def cmd_evict_host(args) -> int:
    """Operator eviction against the SHARED STORE directly (the multi-host
    runbook, docs/multihost.md): the /admin/evict-host route needs a
    healthy serving member; this works when none is reachable — the
    sentinel lands in the collective_watermarks table and every member
    (and the pruner) reacts at its next hygiene pass."""
    from tvidz_tpu_torch.corpus.store import Store

    if not args.host.startswith("host-"):
        print(f"error: expected a host-N member id, got {args.host!r}",
              file=sys.stderr)
        return 2
    store = Store(args.db)
    try:
        try:
            store.evict_collective_member(args.host)
        except KeyError:
            members = sorted(h for h, _s, _u in store.collective_watermarks())
            print(f"error: {args.host} is not a registered collective "
                  f"member (registered: {members or 'none'})",
                  file=sys.stderr)
            return 2
        out = {
            "status": "evicted",
            "host": args.host,
            "max_seq": store.max_collective_seq(),
            "min_live_watermark": store.min_collective_watermark(),
            "members": [
                {"host": h, "seq": s, "evicted": s < 0}
                for h, s, _ in store.collective_watermarks()
            ],
        }
    finally:
        store.close()
    print(json.dumps(out, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tvidz_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_device(p):
        p.add_argument("--device", default=None,
                       help="cuda (default, or $TVIDZ_TORCH_DEVICE) or cpu")

    p = sub.add_parser("analyze", help="analyze a local video against the corpus")
    p.add_argument("video")
    p.add_argument("--db", default="sqlite:///tvidz.db")
    p.add_argument("--compact", action="store_true")
    add_device(p)

    p = sub.add_parser("fingerprint", help="compute cuts + fingerprints only")
    p.add_argument("video")
    p.add_argument("-o", "--output", default=None, help=".npz output path")
    add_device(p)

    p = sub.add_parser("search", help="search a video against the corpus "
                                      "without adding it")
    p.add_argument("video")
    p.add_argument("--db", default="sqlite:///tvidz.db")
    p.add_argument("--top-k", type=int, default=5)
    add_device(p)

    p = sub.add_parser("ingest", help="batch-analyze a directory into the corpus")
    p.add_argument("directory")
    p.add_argument("--db", default="sqlite:///tvidz.db")
    p.add_argument("--ext", default="mp4,avi,mkv,mov,mpg,y4m",
                   help="comma-separated extensions to ingest")
    add_device(p)

    sub.add_parser("serve", help="run the inspector service (arguments pass "
                                 "through to the entrypoint)")
    sub.add_parser("bench", help="time the device legs and race the corpus "
                                 "scans (arguments pass through to "
                                 "tvidz_tpu_torch.bench)")

    p = sub.add_parser("evict-host", help="evict a stalled multi-host member "
                                          "via the shared store (runbook: "
                                          "docs/multihost.md)")
    p.add_argument("host", help="member id, e.g. host-2")
    p.add_argument("--db", required=True,
                   help="the cluster's SHARED store url (sqlite/postgresql)")

    args, extra = parser.parse_known_args(argv)
    if args.cmd == "serve":
        return cmd_serve(extra)
    if args.cmd == "bench":
        from tvidz_tpu_torch import bench

        return bench.main(extra)
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "analyze":
        return cmd_analyze(args)
    if args.cmd == "fingerprint":
        return cmd_fingerprint(args)
    if args.cmd == "search":
        return cmd_search(args)
    if args.cmd == "evict-host":
        return cmd_evict_host(args)
    return cmd_ingest(args)


if __name__ == "__main__":
    sys.exit(main())
