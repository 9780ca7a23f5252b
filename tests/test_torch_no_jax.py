"""The port runs without jax, never imports it, and never falls back to the
CPU on its own."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tvidz_tpu.corpus
import tvidz_tpu.ops
import tvidz_tpu.pipeline
from tvidz_tpu.decode import write_synthetic_y4m
from tvidz_tpu_torch import _reference, backend

ROOT = Path(__file__).resolve().parents[1]

# Runs the port's CLI in a fresh interpreter whose import system refuses
# jax, then reports what got imported.
_NO_JAX_RUNNER = r"""
import json, runpy, sys
class _RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ModuleNotFoundError(f"No module named {name!r} (refused)")
        return None
sys.meta_path.insert(0, _RefuseJax())
sys.path.insert(0, sys.argv[1])
sys.argv = ["tvidz_tpu_torch"] + sys.argv[2:]
try:
    runpy.run_module("tvidz_tpu_torch", run_name="__main__")
except SystemExit as e:
    code = e.code
ops = sys.modules["tvidz_tpu.ops"]
print(json.dumps({"code": code,
                  "jax": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib")),
                  "bare_ops": not hasattr(ops, "fingerprint_block")}))
"""


def test_cli_analyze_runs_with_jax_refused(tmp_path):
    video = tmp_path / "clip.y4m"
    _, planted = write_synthetic_y4m(str(video), num_frames=40, height=36,
                                     width=64, cut_frames=(17,), seed=2)
    env = dict(os.environ, TVIDZ_TMP_DIR=str(tmp_path),
               TVIDZ_LOG_LEVEL="WARNING")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUNNER, str(ROOT), "analyze",
         str(video), "--db", f"sqlite:///{tmp_path / 'c.db'}",
         "--device", "cpu", "--compact"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    result, report = lines[0], lines[-1]
    assert result["status"] == "done" and result["scene_cuts"] == planted
    assert result["fingerprinted_frames"] == 40
    assert report == {"code": 0, "jax": [], "bare_ops": True}


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)
    files = sorted((ROOT / "tvidz_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_bridge_never_replaces_an_imported_module():
    before = {n: sys.modules[n] for n in
              ("tvidz_tpu.ops", "tvidz_tpu.corpus", "tvidz_tpu.pipeline")}
    assert _reference.install_bare_packages() == []
    for name, mod in before.items():
        assert sys.modules[name] is mod
    assert hasattr(tvidz_tpu.ops, "fingerprint_block")   # the real package


def test_device_is_explicit(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(backend.ENV_DEVICE, raising=False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        backend.resolve_device()
    with pytest.raises(RuntimeError):
        backend.resolve_device("cuda")
    assert backend.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    assert backend.resolve_device() == torch.device("cpu")
    with pytest.raises(ValueError):
        backend.resolve_device("meta")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
