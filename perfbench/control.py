"""The control of a cell's comparison: a whole run of the cell, with its
kind's control put in the program's place, through the harness's own
comparison. It has to come out as not correct.

    python3 perfbench/control.py --workload <cell> --seeds <n>,<n>,... [--seconds 51]

Each kind states its control (``control_hooks`` in
``perfbench/kinds/<kind>.py``): for uploads, the reference's pHash with
TF32 on in place of the hashes the fingerprint pass makes (the
configuration states float32 with TF32 off); for fragment search, which
states no precision, the program's threshold one below the configuration's
(which states that frames match at a distance of 10 or less).

Prints, a seed, one JSON line: ``correct`` and every number compared beside
its limit. The benchmark's own runs never run it;
``perfbench/tests/test_control.py`` runs it at a size a test can hold.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def put_control_in_place(kind) -> None:
    for hook in kind.control_hooks():
        hook(kind)


def readings(workload: str, seeds, seconds: int, device: str = "cuda",
             root=None) -> list:
    from perfbench import core

    out = []
    for seed in seeds:
        line = core.run_cell(workload, seed, seconds, False, device=device,
                             root=root or core.ROOT,
                             hooks=[put_control_in_place],
                             say=lambda *a, **k: None)
        out.append({"seed": seed, "correct": line["correct"],
                    "failed": line["failed"], "checks": line["checks"]})
    return out


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
    for line in readings(args.workload,
                         [int(s) for s in args.seeds.split(",")], seconds):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
