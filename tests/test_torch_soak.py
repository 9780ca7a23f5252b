"""The soaks on the CPU: ``service.soak --mesh`` (the port of
``scripts/soak_test.py --mesh``) and ``service.soak_multihost`` (the port of
``scripts/soak_multihost.py``), each at the fewest uploads that still reach
every check: 5 for the mesh soak (the fifth is the first byte copy), 9 for
the multi-host one (the corpus must outgrow the warm timestamp capacity of
8). The op log's bound check is held against made-up ``/metrics`` samples.
"""

import json

import pytest

from tests.test_torch_multihost_served import run_driver
from tvidz_tpu_torch.service import soak_multihost
from tvidz_tpu_torch.service.soak_multihost import MAX_ROWS, OplogSampler

KERNELS = {"fingerprint_block", "corpus_scan", "corpus_scan_tc",
           "fragment_search"}


def _summary(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_soak_mesh():
    rc, out, err = run_driver(
        ["tvidz_tpu_torch.service.soak", "--mesh", "--device", "cpu",
         "--videos", "5"], timeout=240)
    assert rc == 0, (out[-4000:], err[-2000:])
    assert "[soak] ALL CHECKS PASSED" in out
    assert "PASS: corpus sharded over the 8 cells" in out
    assert "PASS: duplicate verdicts (1/1)" in out
    summary = _summary(out)
    assert summary["ok"] and summary["mesh"] and summary["videos"] == 5
    assert set(summary["kernel_launches"]) == KERNELS


def test_soak_multihost():
    rc, out, err = run_driver(
        ["tvidz_tpu_torch.service.soak_multihost", "--device", "cpu",
         "--videos", "9"], timeout=240)
    assert rc == 0, (out[-4000:], err[-2000:])
    assert "[mh-soak] ALL CHECKS PASSED" in out
    assert "PASS: soak3 names exactly its original" in out
    assert "PASS: soak7 names exactly its original" in out
    summary = _summary(out)
    assert summary["ok"] and summary["videos"] == 9
    assert 0 < summary["oplog_max_rows"] <= MAX_ROWS
    final = summary["oplog_final"]
    assert final["rows"] <= 2 and final["lag_ops"] == 0
    assert final["lag_alarm"] is False
    assert summary["corpus_videos"] == 9 > soak_multihost.TS_CAPACITY
    assert [set(r["kernel_launches"]) for r in summary["ranks"]] == [KERNELS] * 2


HEALTHY = {"rows": 1, "lag_ops": 0, "lag_alarm": False}


@pytest.mark.parametrize("rows, final, failed", [
    ([3, 17, 40, 64, 9, 1], HEALTHY, []),
    ([3, 17, 65, 9, 1], HEALTHY, ["op-log rows bounded"]),
    ([], HEALTHY, ["op-log rows bounded"]),
    ([0, 0, 0], HEALTHY, ["op-log rows bounded"]),
    ([5, 12, 3], {"rows": 3, "lag_ops": 0, "lag_alarm": False},
     ["final log pruned"]),
    ([5, 12, 3], {"rows": 1, "lag_ops": 2, "lag_alarm": False},
     ["final log pruned"]),
    ([5, 12, 3], {"rows": 1, "lag_ops": 0, "lag_alarm": True},
     ["no lag alarm"]),
    ([5, 12, 3], {}, ["final log pruned", "no lag alarm"]),
], ids=["bounded", "over_64", "never_sampled", "never_grew", "final_rows",
        "final_lag", "alarm", "no_final_metrics"])
def test_oplog_bound_check(rows, final, failed):
    """The reference's op-log checks on a made-up ``/metrics`` sequence:
    the largest sampled row count is in (0, 64], and the final log holds
    at most 2 rows, no lag and no alarm."""
    sampler = OplogSampler()
    for n in rows:
        sampler.observe({"rows": n, "lag_ops": n // 4})
    assert sampler.max_rows == max(rows, default=0)
    got = [name for name, ok, _ in sampler.checks(final) if not ok]
    assert len(got) == len(failed)
    assert all(g.startswith(f) for g, f in zip(got, failed))


def test_upload_plan_copies_name_their_original():
    plan = soak_multihost.upload_plan(12)
    copies = {i: want for i, _, want in plan if want}
    assert copies == {3: "soak0.y4m", 7: "soak4.y4m", 11: "soak8.y4m"}
    seed = {i: s for i, s, _ in plan}
    assert all(seed[i] == seed[i - 3] for i in copies)
    originals = [s for i, s, want in plan if not want]
    assert len(set(originals)) == len(originals)
