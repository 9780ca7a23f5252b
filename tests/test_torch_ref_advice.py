"""The reference's own regression tests of the ADVICE r2-r4 fixes, the
review fixes and the baseline configurations, run against the port on the
CPU: each test function of the five reference modules below is one case of
``test_reference``, run unchanged through ``use_port``
(tests/test_torch_event_wiring.py), 36 cases, and one case in the port's
form where the reference's body is bound to JAX, 37 in all.
"""

import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_event_wiring import (
    reference_cases,
    reference_fixtures,
    run_reference,
)
from tvidz_tpu_torch.ops import golden, hamming
from tvidz_tpu_torch.parallel.mesh import make_mesh
from tvidz_tpu_torch.parallel.sharded_search import sharded_nearest

MODULES = [importlib.import_module(f"tests.test_{m}") for m in (
    "advice_r2", "advice_r3", "advice_r4", "review_fixes", "baseline_configs")]
globals().update(reference_fixtures(*MODULES))
# Enters ``with mesh:`` and hands jnp arrays in: its port form is below.
IN_PORT_FORM = {
    "tests.test_review_fixes": ("test_sharded_nearest_matches_single_chip",)}


@pytest.mark.parametrize("module, test", [
    c for m in MODULES for c in reference_cases(
        m, without=IN_PORT_FORM.get(m.__name__, ()))])
def test_reference(request, monkeypatch, module, test):
    run_reference(request, monkeypatch, module, test)


def test_sharded_nearest_matches_single_chip(rng, monkeypatch):
    """tests/test_review_fixes.py:141 on the port: ``sharded_nearest`` over
    ``make_mesh(8)`` (``[cpu] * 8``) gives golden's per-query minimum and
    the single-device scan's first-index argmin, with a planted exact
    match; the same data as the reference's case."""
    monkeypatch.setenv("TVIDZ_TORCH_DEVICE", "cpu")
    mesh = make_mesh(8)
    q = rng.integers(0, 2**32, size=(8, 2), dtype=np.uint32)
    corpus = rng.integers(0, 2**32, size=(512, 2), dtype=np.uint32)
    corpus[300] = q[2]
    qt, ct = (torch.from_numpy(a.view(np.int32)) for a in (q, corpus))
    d, idx = sharded_nearest(qt, ct, mesh)
    h = golden.hamming_matrix(q, corpus)
    np.testing.assert_array_equal(d.numpy(), h.min(axis=1))
    one_min, one_arg = hamming.corpus_query_nearest(qt, ct)
    assert torch.equal(d, one_min) and torch.equal(idx, one_arg)
    assert int(idx[2]) == 300
    for i in range(8):
        assert h[i, int(idx[i])] == int(d[i])
