"""The multi-process dryrun on the port (``tvidz_tpu_torch.parallel.dryrun``,
the port of ``scripts/dryrun_multihost.py``): two rank processes on gloo,
``[cpu] * 4`` cells each — the global (data 1, corpus 8) mesh of the
reference's 8-device process — with the corpus sharded across the rank
boundary. Every rank's results must be identical, and equal to the JAX
package's single-process ``MultiHostShardedCorpus`` running the same
scenario in this process."""

import json

import pytest

from tests.test_torch_multihost_served import run_driver
from tvidz_tpu_torch.parallel import dryrun


def test_two_process_dryrun_equals_the_reference(tmp_path):
    import jax

    from tvidz_tpu.parallel import distributed as jdist

    if jax.device_count() < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    rc, out, err = run_driver(
        ["tvidz_tpu_torch.parallel.dryrun", "--processes", "2", "--device",
         "cpu", "--cells", "4", "--out", str(tmp_path)], timeout=110)
    assert rc == 0, (out[-2000:], err[-3000:])
    assert "dryrun_multihost OK" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["ok"] and summary["mesh"] == {"data": 1, "corpus": 8}
    assert "[host 0] OK" in err and "[host 1] OK" in err
    ranks = [json.loads((tmp_path / f"rank{i}.json").read_text())
             for i in range(2)]
    assert ranks[0]["results"] == ranks[1]["results"]

    jmesh = jdist.make_multihost_mesh()
    assert dict(jmesh.shape) == summary["mesh"]
    want = dryrun.small_scenario(
        lambda **kw: jdist.MultiHostShardedCorpus(jmesh, **kw), 0, 1)
    assert ranks[0]["results"]["small"] == json.loads(json.dumps(want))
