"""Run a fragment-search cell of the benchmark and count what its comparison
compared.

    python3 scripts/fragsearch_ties.py --workload fragsearch-phash64 --seeds <n>,<n>,... [--seconds 51]

Each seed is one untraced run through ``perfbench.core.run_cell``, exactly as
``perfbench/run.py`` makes it; a hook only wraps the kind's reference
(``expected``) to count, over the spans ``verify`` compares:

- ``entries``: the (video, offset, score) entries of the reference's answers;
- ``not_planted``: entries of a video other than the span's planted copy
  (the catalog video its source was copied into): the low-score matches;
- ``equal_scores``: entries whose score another entry of the same answer
  shares, so that their order is the bucket-then-arrival rule's;
- ``tied_offsets``: entries not planted whose best score their video reaches
  at two or more offsets, so that the answer's offset is the first of them;
  ``most_tied_offsets`` is the largest number of such offsets.

Prints, a seed, one JSON line: the result line's ``correct``, ``metrics``
and ``checks``, and these counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def offsets_at_best(query: np.ndarray, rows: np.ndarray, threshold: int) -> int:
    """How many offsets reach the video's best score for ``query``."""
    x = (query[:, None, :] ^ rows[None, :, :]).view(np.uint8)
    dist = _POP8[x].sum(-1, dtype=np.int32)
    t, r = np.nonzero(dist <= threshold)
    per = Counter((r - t).tolist())
    best = max(per.values())
    return sum(1 for c in per.values() if c == best)


def counting_hook(stats: Counter):
    def hook(kind):
        orig = kind.expected
        rows_of = dict(zip(kind.cat_vids, kind.cat_rows))
        rows_of.update(zip(kind.src_vids, kind.sources))

        def expected(catalog, q, threshold):
            want = orig(catalog, q, threshold)
            j = kind.src_names.index(q["filename"])
            host = kind.cat_vids[kind.copies[j][0]]
            s, n = q["start_frame"], q["num_frames"]
            scores = Counter(sc for _, _, sc in want)
            stats["spans"] += 1
            stats["entries"] += len(want)
            stats["equal_scores"] += sum(1 for *_, sc in want if scores[sc] > 1)
            for v, _, _ in want:
                if v == host:
                    continue
                stats["not_planted"] += 1
                k = offsets_at_best(kind.sources[j, s:s + n], rows_of[v], threshold)
                stats["tied_offsets"] += int(k > 1)
                stats["most_tied_offsets"] = max(stats["most_tied_offsets"], k)
            return want

        kind.expected = expected
    return hook


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=int, default=None)
    args = p.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("TVIDZ_")]:
        del os.environ[k]
    os.environ["TVIDZ_LOG_LEVEL"] = "WARNING"
    from perfbench import core

    seconds = args.seconds or core.load_json(
        os.path.join(core.ROOT, "BENCHMARK.json"))["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        stats: Counter = Counter()
        line = core.run_cell(args.workload, seed, seconds, False,
                             hooks=[counting_hook(stats)],
                             say=lambda *a, **k: None)
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "failed": line["failed"], "metrics": line["metrics"],
                          "checks": line["checks"], "device": line["device"],
                          "compared": dict(stats)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
