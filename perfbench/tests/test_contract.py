"""BENCHMARK.json holds to the benchmark's contract, and every part a cell
names is found by name under perfbench/."""

import json
import os
import re

import pytest

from perfbench import core
from perfbench.load import load_kind

BENCH = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("perfbench/configs/")
    body = core.load_json(os.path.join(core.ROOT, config["file"]))
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
    assert all(k in body for k in config["reduced"])
    assert config["source"].startswith("https://")
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    c = core.Cell(cell)
    assert set(c.cell) == {"name", "config", "traffic", "chips", "why"}
    assert c.cell["chips"] == 1 and len(c.cell["why"]) <= 200
    kind = c.kind_class()
    assert kind.__module__ == f"perfbench_kind_{c.traffic['kind']}"
    for step in ("setup", "instrument", "run_window", "drain", "verify",
                 "control_hooks"):
        assert step in vars(kind), f"{kind.__name__} lacks its own {step}"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert all(isinstance(v, (int, float)) for v in c.limits.values())


def test_a_new_kind_is_a_new_file(tmp_path):
    kinds = tmp_path / "perfbench" / "kinds"
    kinds.mkdir(parents=True)
    (kinds / "echo.py").write_text(
        "from perfbench.load import Kind\n\n\nclass Echo(Kind):\n    pass\n\n\n"
        "KIND = Echo\n")
    assert load_kind(str(tmp_path), "echo").__name__ == "Echo"
    with pytest.raises(KeyError, match="no traffic kind"):
        load_kind(str(tmp_path), "absent")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moves.get("workloads", CELLS)
    read = core.Cell(metric["workloads"][0]).reader(metric["name"])
    assert callable(read)
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    samples = {"verdict": [1.0, 2.0], "search": [1.0, 2.0]}
    assert core.end_to_end_value(metric["name"], samples, 3.0) > 0


def test_one_layer_name_per_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_paths_hold_only_the_benchmark():
    for dirpath, _, files in os.walk(os.path.join(core.ROOT, "perfbench")):
        for f in files:
            assert re.match(r"^[A-Za-z0-9_.-]+$", f), f
