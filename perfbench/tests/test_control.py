"""The control of each cell, at a size a test holds: a whole run with the
cell's control in the program's place comes out as not correct, through the
harness's own comparison, on the number the control is meant to fail."""

import pytest

from perfbench import control
from perfbench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")), {
        "uploads-poisson": {"rate_per_s": 4.0, "duplicate_share": 0.0}})


@pytest.mark.parametrize("cell,number", [("upload-phash64", "hash_bits_pct"),
                                         ("fragsearch-phash256", "spans_wrong")])
def test_control_fails(root, cell, number):
    for reading in control.readings(cell, [11, 2 ** 35 + 12, 13], 10,
                                    device="cpu", root=root):
        assert reading["correct"] is False and reading["failed"] == 0
        assert reading["checks"][number]["value"] > reading["checks"][number]["limit"]
