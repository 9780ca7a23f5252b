"""The port's full-stack drivers on the CPU, each a subprocess that starts
the service as its own process:

- ``service.integration --real-clients --pg`` (the port of
  ``scripts/integration_test.py``): presigned uploads to the port's MiniAWS,
  the S3 notification to SQS over HTTP, every store operation over pgwire
  to the port's MiniPG, and the failover leg — MiniPG down when the third
  upload arrives, back on the same port once a store operation of that
  analysis failed;
- ``service.soak --videos 8`` (the port of ``scripts/soak_test.py``).
"""

import json

import pytest
import torch

from tests.test_torch_multihost_served import run_driver
from tvidz_tpu_torch import backend
from tvidz_tpu_torch.service import (
    integration,
    integration_multihost,
    soak,
    soak_multihost,
)


@pytest.mark.parametrize("driver", [integration, soak, integration_multihost,
                                    soak_multihost],
                         ids=["integration", "soak", "integration_multihost",
                              "soak_multihost"])
def test_drivers_run_on_the_card_unless_asked(monkeypatch, driver):
    """Each driver (and the service it starts) runs on the card by default:
    without one it raises before it starts anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(backend.ENV_DEVICE, raising=False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        driver.main([])


def test_integration_real_clients_over_pg():
    rc, out, err = run_driver(
        ["tvidz_tpu_torch.service.integration", "--device", "cpu",
         "--real-clients", "--pg"], timeout=240)
    assert rc == 0, (out[-4000:], err[-2000:])
    assert "[integration] ALL CHECKS PASSED" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["ok"] and summary["real_clients"] and summary["pg"]
    failover = summary["failover"]
    assert failover["op"] == "add_video" and failover["upload3"] == "done"
    assert summary["rows_after_failover"] == 3
    assert set(summary["kernel_launches"]) == {
        "fingerprint_block", "corpus_scan", "corpus_scan_tc", "fragment_search"}


def test_soak_eight_uploads():
    rc, out, err = run_driver(
        ["tvidz_tpu_torch.service.soak", "--device", "cpu", "--videos", "8"],
        timeout=240)
    assert rc == 0, (out[-4000:], err[-2000:])
    assert "[soak] ALL CHECKS PASSED" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["ok"] and summary["videos"] == 8
    assert summary["registry_held"] <= 28 and summary["videos_per_s"] > 0
