"""Run one cell of the benchmark on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's deployment of ``tvidz_tpu_torch`` from its configuration
and the seed, warms the cell's own shapes, offers its traffic for
``--seconds``, drains, compares what the timed path produced with the plain
reference, and prints the result as the last line of standard output (the
compared numbers, each beside its limit, also as the last lines of
standard error). ``--trace 1`` profiles the window and reports the cell's
per-layer metrics instead of its end-to-end ones. Exits non-zero, printing
no result, without a CUDA card (or with fewer than the cell asks for).
``--override key=value`` replaces a traffic parameter (a JSON value), for
a rate sweep; the benchmark's own runs never pass it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--override", action="append", default=[])
    args = p.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("TVIDZ_")]:
        del os.environ[k]
    os.environ["TVIDZ_LOG_LEVEL"] = "WARNING"

    import torch

    from perfbench import core

    chips = core.Cell(args.workload).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    overrides = {}
    for item in args.override:
        key, _, value = item.partition("=")
        overrides[key] = json.loads(value)
    line = core.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), overrides=overrides)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
