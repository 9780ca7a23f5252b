"""The repo-root conftest gives each xdist worker its share of the cores
through ``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS``, set in the controlling
process before it starts the workers.

A probe process runs the root conftest's ``pytest_configure`` as the
controlling process would, for a chosen worker count and environment, then
imports torch and reports both variables and torch's intra-op pool. The
last test reads the pools of the process that runs it and of a child.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"
NAMES = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")

# argv: the conftest's path and the worker count ("None" without xdist).
# The native decoders' build is left out.
PROBE = """
import importlib.util, os, sys, types
spec = importlib.util.spec_from_file_location("root_conftest", sys.argv[1])
conftest = importlib.util.module_from_spec(spec)
spec.loader.exec_module(conftest)
conftest._libav_present = lambda: False
workers = None if sys.argv[2] == "None" else int(sys.argv[2])
conftest.pytest_configure(types.SimpleNamespace(
    getoption=lambda name, default=None: workers))
import torch
print(os.environ.get("OMP_NUM_THREADS"), os.environ.get("MKL_NUM_THREADS"),
      torch.get_num_threads())
"""

CHILD = """
import os, torch
print(os.environ.get("OMP_NUM_THREADS"), torch.get_num_threads())
"""


def run(code: str, env: dict, *args: str) -> list:
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, check=True, timeout=120)
    return out.stdout.split()


def probe(workers, **env) -> list:
    base = {k: v for k, v in os.environ.items() if k not in NAMES}
    return run(PROBE, {**base, **env}, str(ROOT_CONFTEST), str(workers))


@pytest.mark.parametrize("workers", [1, 6, 64])
def test_worker_pools_get_their_share_of_the_cores(workers):
    share = str(max(1, len(os.sched_getaffinity(0)) // workers))
    assert probe(workers) == [share, share, share]


def test_a_value_the_environment_sets_wins():
    assert probe(6, OMP_NUM_THREADS="3", MKL_NUM_THREADS="3") == ["3", "3", "3"]


def test_a_run_without_xdist_is_left_as_it_is():
    default = run(CHILD, {k: v for k, v in os.environ.items() if k not in NAMES})[1]
    assert probe(None) == ["None", "None", default]


def test_this_process_and_its_children_share_one_pool_size():
    import torch

    omp = os.environ.get("OMP_NUM_THREADS")
    if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
        # The variables were in the worker's environment when it started,
        # before its plugins loaded numpy and the BLAS.
        with open("/proc/self/environ", "rb") as f:
            initial = dict(item.split(b"=", 1) for item in f.read().split(b"\0")
                           if b"=" in item)
        assert initial[b"OMP_NUM_THREADS"].decode() == omp
        assert initial[b"MKL_NUM_THREADS"].decode() == os.environ["MKL_NUM_THREADS"]
        assert torch.get_num_threads() == int(omp)
    assert run(CHILD, dict(os.environ)) == [str(omp), str(torch.get_num_threads())]
