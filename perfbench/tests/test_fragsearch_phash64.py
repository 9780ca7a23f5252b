"""The fragsearch-phash64 cell (the default 64-bit deployment's fragment
search) at a size the CPU holds: a whole run comes out correct with every
end-to-end metric the cell names, and its control (the program's threshold
one below the configuration's) comes out as not correct on every seed."""

import pytest

from perfbench import control, core
from perfbench.tests.tiny import tiny_root

CELL = "fragsearch-phash64"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def test_cell_runs_correct_with_its_metrics(root):
    c = core.Cell(CELL, root)
    assert c.cell["config"] == "phash64-16m-search"
    assert c.config["settings"]["hash"]["algorithm"] == "phash"
    assert c.config["settings"]["match"]["hamming_threshold"] == 10
    assert {m["name"] for m in c.end_to_end} == {"search_p95_ms", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        f"{n}.fragsearch" for n in (
            "route_host_ms", "locate_ms_per_request", "k3_roofline",
            "device_idle_pct", "mfu", "k3_device_ms_per_request",
            "locate_queue_ms")}
    line = core.run_cell(CELL, 2 ** 33 + 64, 3, False, device="cpu", root=root,
                         say=lambda *a, **k: None)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"search_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["checks"] == {"spans_wrong": {"value": 0, "limit": 0},
                              "names_wrong": {"value": 0, "limit": 0}}


def test_control_fails(root):
    for reading in control.readings(CELL, [21, 2 ** 35 + 22, 23], 3,
                                    device="cpu", root=root):
        assert reading["correct"] is False and reading["failed"] == 0
        chk = reading["checks"]["spans_wrong"]
        assert chk["value"] > chk["limit"]
