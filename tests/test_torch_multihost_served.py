"""The served multi-host driver on the port
(``tvidz_tpu_torch.service.integration_multihost``, the port of
``scripts/integration_multihost.py``): two full inspector services, two
ranks of a gloo group with ``[cpu] * 4`` cells each, one shared sqlite
store, driven over sockets — a verdict across ranks, /status from the other
rank, cross-rank fragment searches, /debug/videos on both, op-log pruning,
a remove and online growth. ``--quick``: one cluster boot, so that the
test stays well inside its time limit on a loaded machine; the restart and
eviction legs (two more boots of both ranks) run in the driver's full mode,
and their runner mechanics in tests/test_torch_collective.py."""

import json
import os
import signal
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_driver(argv, timeout):
    """(exit code, stdout, stderr) of a driver run in a session of its own:
    on a timeout the driver and the rank processes it started are killed
    together."""
    proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err


def test_two_process_served_integration():
    rc, out, err = run_driver(
        ["tvidz_tpu_torch.service.integration_multihost", "--device", "cpu",
         "--quick"], timeout=110)
    assert rc == 0, (out[-4000:], err[-1000:])
    assert "[mh-integration] ALL CHECKS PASSED" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["ok"] and len(summary["ranks"]) == 2
    for rank in summary["ranks"]:
        assert set(rank["kernel_launches"]) == {
            "fingerprint_block", "corpus_scan", "corpus_scan_tc",
            "fragment_search"}


def test_two_process_served_integration_over_pg():
    """``--pg --quick``: the shared store both ranks coordinate through (op
    log, watermarks, persistence) is the port's MiniPG over pgwire."""
    rc, out, err = run_driver(
        ["tvidz_tpu_torch.service.integration_multihost", "--device", "cpu",
         "--quick", "--pg"], timeout=110)
    assert rc == 0, (out[-4000:], err[-1000:])
    assert "MiniPG shared store on" in out
    assert "[mh-integration] ALL CHECKS PASSED" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["ok"] and summary["pg"] and len(summary["ranks"]) == 2
