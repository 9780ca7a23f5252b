"""The port runs without jax and without the JAX package, never imports
either, and never falls back to the CPU on its own: its CLI (``analyze``,
``search``) and its service entrypoint run in interpreters whose import
system refuses jax and ``tvidz_tpu`` and logs every attempt; afterwards no
module of either is in ``sys.modules``."""

import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.decode import write_synthetic_y4m

ROOT = Path(__file__).resolve().parents[1]

# Runs a module of the port (argv[2]) in a fresh interpreter whose import
# system refuses jax and the JAX package and appends every refused name to
# argv[3], then reports which of their modules got imported: on stdout when
# the module returns, in argv[3] + ".modules" when the process gets SIGTERM
# (a server).
_NO_JAX_RUNNER = r"""
import json, os, runpy, signal, sys
REFUSED = ("jax", "jaxlib", "tvidz_tpu")
LOG = sys.argv[3]
class _RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            with open(LOG, "a") as f:
                f.write(name + "\n")
            raise ModuleNotFoundError(f"No module named {name!r} (refused)")
        return None
def report(code):
    return json.dumps({"code": code,
                       "jax": sorted(m for m in sys.modules
                                     if m.split(".")[0] in ("jax", "jaxlib")),
                       "tvidz_tpu": sorted(m for m in sys.modules
                                           if m.split(".")[0] == "tvidz_tpu")})
def on_term(signum, frame):
    with open(LOG + ".modules", "w") as f:
        f.write(report(None))
    os._exit(0)
signal.signal(signal.SIGTERM, on_term)
sys.meta_path.insert(0, _RefuseJax())
sys.path.insert(0, sys.argv[1])
module = sys.argv[2]
sys.argv = [module] + sys.argv[4:]
code = 0
try:
    runpy.run_module(module, run_name="__main__")
except SystemExit as e:
    code = e.code
print(report(code))
"""


def _run_cli(tmp_path, *argv, module="tvidz_tpu_torch", env_extra=None):
    """(stdout, names whose import was refused) of one port CLI call (or a
    run of another of the port's modules) with jax refused; stdout's last
    line is the runner's report."""
    refused = tmp_path / "refused.log"
    env = dict(os.environ, TVIDZ_TMP_DIR=str(tmp_path),
               TVIDZ_LOG_LEVEL="WARNING", **(env_extra or {}))
    device = ["--device", "cpu"] if module == "tvidz_tpu_torch" else []
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUNNER, str(ROOT), module,
         str(refused), *argv, *device],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, refused.read_text().split() if refused.exists() else []


def test_cli_analyze_runs_with_jax_refused(tmp_path):
    video = tmp_path / "clip.y4m"
    _, planted = write_synthetic_y4m(str(video), num_frames=40, height=36,
                                     width=64, cut_frames=(17,), seed=2)
    out, refused = _run_cli(tmp_path, "analyze", str(video), "--db",
                            f"sqlite:///{tmp_path / 'c.db'}", "--compact")
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    result, report = lines[0], lines[-1]
    assert result["status"] == "done" and result["scene_cuts"] == planted
    assert result["fingerprinted_frames"] == 40
    assert report == {"code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []


def test_cli_search_runs_with_jax_refused(tmp_path):
    """``search`` after ``analyze``: the clip aligns with its stored self at
    offset 0 through fragment search (the plain K3 on the CPU)."""
    video = tmp_path / "clip.y4m"
    write_synthetic_y4m(str(video), num_frames=70, height=36, width=64,
                        cut_frames=(17, 44), seed=3)
    db = f"sqlite:///{tmp_path / 'c.db'}"
    _run_cli(tmp_path, "analyze", str(video), "--db", db, "--compact")
    out, refused = _run_cli(tmp_path, "search", str(video), "--db", db)
    body, report = out.strip().rsplit("\n", 1)
    result, report = json.loads(body), json.loads(report)
    assert report == {"code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []
    top = result["best_alignments"][0]
    assert top["filename"] == "clip.y4m" and top["offset_frames"] == 0
    assert top["match_count"] == 70
    assert result["timestamp_matches"][0]["filename"] == "clip.y4m"


def test_cli_analyze_phash256_runs_with_jax_refused(tmp_path):
    """``analyze`` under ``TVIDZ_HASH_ALGO=phash256``: the hash families
    (ops/hashes over ops/resize and ops/phash) run with jax refused, and
    store 8-word fingerprints."""
    video = tmp_path / "clip.y4m"
    _, planted = write_synthetic_y4m(str(video), num_frames=40, height=36,
                                     width=64, cut_frames=(17,), seed=2)
    out, refused = _run_cli(tmp_path, "analyze", str(video), "--db",
                            f"sqlite:///{tmp_path / 'c.db'}", "--compact",
                            env_extra={"TVIDZ_HASH_ALGO": "phash256"})
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    result, report = lines[0], lines[-1]
    assert result["status"] == "done" and result["scene_cuts"] == planted
    assert report == {"code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []
    from tvidz_tpu_torch.corpus.store import Store
    store = Store(f"sqlite:///{tmp_path / 'c.db'}")
    try:
        assert store.get_fingerprints(1).shape == (40, 8)
    finally:
        store.close()


def test_cli_analyze_ship_coeffs_runs_with_jax_refused(tmp_path):
    """``analyze`` under ``TVIDZ_SHIP_DCT_COEFFS=1``: the host projection
    and the coefficient tail run with jax refused, and the cuts (from the
    host scorer) are the planted ones."""
    video = tmp_path / "clip.y4m"
    _, planted = write_synthetic_y4m(str(video), num_frames=40, height=36,
                                     width=64, cut_frames=(17,), seed=2)
    out, refused = _run_cli(tmp_path, "analyze", str(video), "--db",
                            f"sqlite:///{tmp_path / 'c.db'}", "--compact",
                            env_extra={"TVIDZ_SHIP_DCT_COEFFS": "1"})
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    result, report = lines[0], lines[-1]
    assert result["status"] == "done" and result["scene_cuts"] == planted
    assert report == {"code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []


def test_bench_ingest_legs_run_with_jax_refused(tmp_path):
    """The bench's multistream, service and batched-clips legs (through
    ``pipeline/multistream``, the dispatcher and ``forward_batch``) at tiny
    sizes with jax refused."""
    out, refused = _run_cli(
        tmp_path, "bench", "--sizes", "tiny", "--legs",
        "boot_restore,batched_clips,e2e_scaling_y4m,service_y4m",
        env_extra={"TMPDIR": str(tmp_path)})
    lines = out.strip().splitlines()
    rec, report = json.loads(lines[-2]), json.loads(lines[-1])
    assert report == {"code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []
    assert rec["boot_restore_1m_s"] > 0
    assert set(rec["host"]["e2e_streams_y4m_frames_per_sec"]) == {"1", "2"}


@pytest.mark.parametrize("module", ["tvidz_tpu_torch.ops.hashes",
                                    "tvidz_tpu_torch.ops.resize",
                                    "tvidz_tpu_torch.ops.dct",
                                    "tvidz_tpu_torch.pipeline.multistream",
                                    "tvidz_tpu_torch.bench",
                                    "tvidz_tpu_torch.parallel.mesh_corpus",
                                    "tvidz_tpu_torch.parallel.step"])
def test_hash_modules_import_without_jax(tmp_path, module):
    out, refused = _run_cli(tmp_path, module=module)
    assert json.loads(out.strip().splitlines()[-1]) == {
        "code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []


def test_multihost_modules_import_without_jax(tmp_path):
    """``parallel.distributed`` / ``collective`` and the two multi-host
    drivers import with jax and the JAX package refused."""
    (tmp_path / "mh_imports.py").write_text(
        "import tvidz_tpu_torch.parallel.distributed\n"
        "import tvidz_tpu_torch.parallel.collective\n"
        "import tvidz_tpu_torch.parallel.dryrun\n"
        "import tvidz_tpu_torch.service.integration_multihost\n")
    out, refused = _run_cli(tmp_path, module="mh_imports",
                            env_extra={"PYTHONPATH": str(tmp_path)})
    assert json.loads(out.strip().splitlines()[-1]) == {
        "code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []


def test_soak_multihost_imports_without_jax(tmp_path):
    """The multi-host soak driver imports with jax and the JAX package
    refused, and neither is in ``sys.modules`` afterwards."""
    (tmp_path / "soak_imports.py").write_text(
        "import tvidz_tpu_torch.service.soak_multihost\n")
    out, refused = _run_cli(tmp_path, module="soak_imports",
                            env_extra={"PYTHONPATH": str(tmp_path)})
    assert json.loads(out.strip().splitlines()[-1]) == {
        "code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []


def test_wire_modules_import_without_jax(tmp_path):
    """MiniAWS, MiniPG and the two full-stack drivers import with jax and
    the JAX package refused, and MiniPG serves the port's Store there."""
    (tmp_path / "wire_imports.py").write_text(
        "import tvidz_tpu_torch.service.miniaws\n"
        "import tvidz_tpu_torch.service.integration\n"
        "import tvidz_tpu_torch.service.soak\n"
        "from tvidz_tpu_torch.corpus.store import Store\n"
        "from tvidz_tpu_torch.service.minipg import start_minipg\n"
        "server = start_minipg(auth_mode='md5', users={'u': 'p'})\n"
        "store = Store(f'postgresql://u:p@127.0.0.1:{server.port}/db')\n"
        "assert store.add_video('a.mp4').filename == 'a.mp4'\n"
        "store.close()\n"
        "server.shutdown()\n")
    out, refused = _run_cli(tmp_path, module="wire_imports",
                            env_extra={"PYTHONPATH": str(tmp_path),
                                       "TVIDZ_PG_DRIVER": "pgwire"})
    assert json.loads(out.strip().splitlines()[-1]) == {
        "code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []


def test_dryrun_rank_runs_with_jax_refused(tmp_path):
    """One rank of the dryrun (a one-rank gloo group over ``[cpu] * 2``)
    runs its whole scenario with jax refused."""
    out, refused = _run_cli(
        tmp_path, "--child", "0", "1", str(_free_port()), "--device", "cpu",
        "--cells", "2", "--out", str(tmp_path),
        module="tvidz_tpu_torch.parallel.dryrun")
    assert "[host 0] OK" in out
    assert json.loads(out.strip().splitlines()[-1]) == {
        "code": 0, "jax": [], "tvidz_tpu": []}
    assert refused == []
    rank = json.loads((tmp_path / "rank0.json").read_text())
    assert rank["mesh"] == {"data": 1, "corpus": 2}
    assert rank["results"]["small"]["ts"] == [[113, 3]]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_with_jax_refused(tmp_path, *argv, log_level="WARNING",
                            env_extra=None):
    """Boot the port's service (fake AWS, no poller, CPU, ``argv``) with jax
    refused; once /healthz reads ok, return (GET of a path -> JSON, the
    process). The caller stops it with ``_stop``."""
    port = _free_port()
    env = dict(os.environ, TVIDZ_TMP_DIR=str(tmp_path), TMPDIR=str(tmp_path),
               TVIDZ_FAKE_S3_ROOT=str(tmp_path / "s3"),
               TVIDZ_LOG_LEVEL=log_level, **(env_extra or {}))
    proc = subprocess.Popen(
        [sys.executable, "-c", _NO_JAX_RUNNER, str(ROOT),
         "tvidz_tpu_torch.service.entrypoint", str(tmp_path / "refused.log"),
         "--fake-aws", "--no-poller", "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port), "--db", f"sqlite:///{tmp_path / 's.db'}", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=tmp_path)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return json.loads(r.read())

    try:
        deadline = time.time() + 240
        health = None
        while time.time() < deadline and proc.poll() is None:
            try:
                health = get("/healthz")
                if health["status"] == "ok":
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert health and health["status"] == "ok", proc.stderr.read1()[-3000:]
    except BaseException:
        _stop(tmp_path, proc)
        raise
    return get, proc


def _stop(tmp_path, proc) -> str:
    """Stop a ``_serve_with_jax_refused`` process, check that it imported
    neither jax nor the JAX package, and return its stdout."""
    proc.terminate()
    proc.wait(timeout=30)
    out = proc.stdout.read().decode()
    proc.stdout.close()
    proc.stderr.close()
    refused = tmp_path / "refused.log"
    assert not refused.exists(), refused.read_text()
    modules = json.loads((tmp_path / "refused.log.modules").read_text())
    assert modules == {"code": None, "jax": [], "tvidz_tpu": []}
    return out


def test_service_entrypoint_answers_status_with_jax_refused(tmp_path):
    """Boot the port's service (fake AWS, no poller, CPU) with jax refused
    and answer /status — the route whose reference registry lookup imports
    the JAX analyzer."""
    get, proc = _serve_with_jax_refused(tmp_path)
    try:
        assert get("/status/1723456789-ghost.mp4") == {"status": "pending"}
        assert get("/metrics")["block_dispatcher"]["passes"] == 0
    finally:
        _stop(tmp_path, proc)


def test_service_entrypoint_mesh_on_one_device(tmp_path):
    """``--mesh`` with one device of the chosen type (here the CPU) logs the
    reference's line and serves on the single-card corpus."""
    get, proc = _serve_with_jax_refused(tmp_path, "--mesh", log_level="INFO")
    try:
        assert get("/healthz")["status"] == "ok"
        assert get("/metrics")["corpus_footprint"]["fp_capacity_rows"] > 0
    finally:
        out = _stop(tmp_path, proc)
    assert ("[entrypoint] --mesh requested but only 1 device; falling back "
            "to single-chip corpus") in out


def test_service_entrypoint_refuses_a_cluster(tmp_path, monkeypatch):
    """A cluster the entrypoint cannot join — a coordinator without its
    world size and rank — is refused before the service serves."""
    from tvidz_tpu_torch.service import entrypoint

    monkeypatch.setenv("TVIDZ_COORDINATOR", "localhost:1234")
    monkeypatch.delenv("TVIDZ_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("TVIDZ_PROCESS_ID", raising=False)
    monkeypatch.setenv("TVIDZ_FAKE_S3_ROOT", str(tmp_path / "s3"))
    with pytest.raises(ValueError, match="TVIDZ_NUM_PROCESSES"):
        entrypoint.main(["--device", "cpu", "--mesh", "--fake-aws",
                         "--db", f"sqlite:///{tmp_path / 's.db'}"])


def test_service_entrypoint_joins_a_cluster_with_jax_refused(tmp_path):
    """With ``TVIDZ_COORDINATOR`` set, ``--mesh`` joins the gloo group (a
    cluster of one here, ``[cpu] * 2`` cells) and serves through the op
    log: /metrics carries its hygiene and /admin/evict-host is real."""
    get, proc = _serve_with_jax_refused(
        tmp_path, "--mesh", "--cells-per-device", "2", log_level="INFO",
        env_extra={
            "TVIDZ_COORDINATOR": f"127.0.0.1:{_free_port()}",
            "TVIDZ_NUM_PROCESSES": "1", "TVIDZ_PROCESS_ID": "0",
            "TVIDZ_MH_FP_CAPACITY": "1024"})
    try:
        oplog = get("/metrics")["collective_oplog"]
        assert oplog["members"]["host-0"]["evicted"] is False
        assert get("/healthz")["corpus_fingerprints"] == 0
    finally:
        out = _stop(tmp_path, proc)
    assert ("multi-host cluster joined (1 hosts, mesh {'data': 1, "
            "'corpus': 2})") in out


def test_port_sources_never_import_jax():
    # ``\b`` keeps ``tvidz_tpu_torch`` out of the match.
    pattern = re.compile(r"^\s*(import|from) (jax|tvidz_tpu)\b"
                         r"|import_module\(\s*[\"'](jax|tvidz_tpu)\b", re.M)
    files = sorted((ROOT / "tvidz_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


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
