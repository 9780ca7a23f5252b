"""The reference's own regression tests of the analysis pipeline, the block
prefetcher and the store, run against the port on the CPU: each test
function of the three reference modules below is one case of
``test_reference``, run unchanged through ``use_port``
(tests/test_torch_event_wiring.py), 17 cases in all.
"""

import importlib

import pytest

from tests.test_torch_event_wiring import (
    reference_cases,
    reference_fixtures,
    run_reference,
)

MODULES = [importlib.import_module(f"tests.test_{m}") for m in (
    "pipeline", "prefetch", "store")]
globals().update(reference_fixtures(*MODULES))


@pytest.mark.parametrize(
    "module, test", [c for m in MODULES for c in reference_cases(m)])
def test_reference(request, monkeypatch, module, test):
    run_reference(request, monkeypatch, module, test)
