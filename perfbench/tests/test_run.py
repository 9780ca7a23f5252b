"""Whole runs at a size the CPU holds: the result line's keys, the per-layer
line of a traced run, and the refusal of a process that imported JAX."""

import sys
import types

import pytest

from perfbench import core
from perfbench.tests.tiny import tiny_root

LINE = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def quiet(*a, **k):
    pass


@pytest.mark.parametrize("cell", ["upload-phash64", "fragsearch-phash256"])
def test_line(root, cell):
    line = core.run_cell(cell, 2 ** 33 + 1, 3, False, device="cpu", root=root,
                         say=quiet)
    assert list(line) == LINE
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    c = core.Cell(cell, root)
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    assert set(line["checks"]) == set(c.limits)
    for chk in line["checks"].values():
        assert chk["value"] <= chk["limit"]


def test_traced_line_reads_host_layers_only(root):
    line = core.run_cell("upload-phash64", 77, 3, True, device="cpu",
                         root=root, say=quiet)
    names = set(line["metrics"])
    c = core.Cell("upload-phash64", root)
    assert names <= {m["name"] for m in c.per_layer}
    assert "dispatch_wait_ms.upload" in names and "analyze_ms_per_frame.upload" in names
    assert not any("roofline" in n or "idle" in n or "mfu" in n for n in names)
    assert "breakdown" not in line and "busy_s" not in line["device"]


def test_jax_in_the_process_fails_the_run(root):
    def import_jax(kind):
        sys.modules["jax"] = types.ModuleType("jax")

    try:
        with pytest.raises(RuntimeError, match="jax"):
            core.run_cell("fragsearch-phash256", 5, 1, False, device="cpu",
                          root=root, hooks=[import_jax], say=quiet)
    finally:
        sys.modules.pop("jax", None)
    assert core.forbidden_modules() == []


def test_memory_s3_keeps_the_fakes_checks(tmp_path):
    from perfbench.deploy import MemoryS3
    from tvidz_tpu_torch.service import fakes

    s3, sqs = MemoryS3(str(tmp_path / "s3")), fakes.FakeSQS()
    s3.put_object("b", "quiet.y4m", b"x")
    s3.configure_notification(sqs, "q")
    s3.put_object("b", "a b+c.y4m", b"y" * 20000)
    msgs = sqs.receive(sqs.get_or_create_queue("q"), max_messages=10)
    assert len(msgs) == 1 and "a+b%2Bc.y4m" in msgs[0]["Body"]
    s3.download("b", "a b+c.y4m", str(tmp_path / "copy"))
    assert (tmp_path / "copy").read_bytes() == b"y" * 20000
    with pytest.raises(PermissionError):
        s3.put_object("b", "../../escape", b"z")
    with pytest.raises(FileNotFoundError):
        s3.download("b", "absent.y4m", str(tmp_path / "none"))
    assert list((tmp_path / "s3").rglob("*.y4m")) == []
