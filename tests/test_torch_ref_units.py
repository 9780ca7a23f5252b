"""The reference's own unit tests of the shared block dispatcher, analysis
checkpoints and the device corpus, run against the port on the CPU: each
test function of the three reference modules below is one case of
``test_reference``, run unchanged through ``use_port``
(tests/test_torch_event_wiring.py), 21 cases, and three cases in the
port's form where the reference's body reaches a JAX-only hook or
signature, 24 in all. (``tests/test_torch_{dispatcher,checkpoint,
device_corpus}.py`` are the parity tests of the same modules.)
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_event_wiring import (
    port_module,
    reference_cases,
    reference_fixtures,
    run_reference,
    use_port,
)
from tvidz_tpu_torch import backend
from tvidz_tpu_torch.corpus import device_corpus as port_dc
from tvidz_tpu_torch.ops import fused

MODULES = [importlib.import_module(f"tests.test_{m}") for m in (
    "dispatcher", "checkpoint", "device_corpus")]
ref_checkpoint, ref_device_corpus = MODULES[1:]
globals().update(reference_fixtures(*MODULES))
IN_PORT_FORM = {
    "tests.test_checkpoint": ("test_checkpoint_blob_roundtrip",),
    "tests.test_device_corpus": ("test_bulk_load_presizes_each_index_once",
                                 "test_pallas_dispatch_policy"),
}


@pytest.mark.parametrize("module, test", [
    c for m in MODULES for c in reference_cases(
        m, without=IN_PORT_FORM.get(m.__name__, ()))])
def test_reference(request, monkeypatch, module, test):
    run_reference(request, monkeypatch, module, test)


def test_checkpoint_blob_roundtrip(rng, monkeypatch):
    """tests/test_checkpoint.py:20, its body unchanged: the port's
    ``initial_fingerprint_carry`` takes the device as an argument
    (ops/fused.py), so the CPU is passed."""
    use_port(monkeypatch, ref_checkpoint)
    monkeypatch.setattr(
        ref_checkpoint, "initial_fingerprint_carry",
        functools.partial(fused.initial_fingerprint_carry,
                          device=torch.device("cpu")))
    ref_checkpoint.test_checkpoint_blob_roundtrip(rng)


def test_bulk_load_presizes_each_index_once(rng, monkeypatch):
    """tests/test_device_corpus.py:80, its body unchanged: it patches
    ``DeviceCorpus._grow_fp`` on the class, so it gets the port's class
    itself in place of ``use_port``'s CPU-pinned partial; the device comes
    from ``TVIDZ_TORCH_DEVICE=cpu``."""
    use_port(monkeypatch, ref_device_corpus)
    monkeypatch.setattr(ref_device_corpus, "DeviceCorpus", port_dc.DeviceCorpus)
    monkeypatch.setattr(port_module("tvidz_tpu.corpus.device_corpus"),
                        "DeviceCorpus", port_dc.DeviceCorpus)
    ref_device_corpus.test_bulk_load_presizes_each_index_once(rng, monkeypatch)


def test_dispatch_policy(rng, monkeypatch):
    """tests/test_device_corpus.py:241's counterpart. The reference probes
    its Pallas fragment kernel per shape class and falls back to XLA; the
    port has no fallback: the tensor's device decides. A CPU corpus answers
    every search through the plain versions without building or launching
    a kernel, and a device other than ``cpu`` or ``cuda`` is refused. (The
    wrappers refuse such tensors too: tests/test_torch_fused.py,
    test_torch_hamming.py and test_torch_align.py; a CUDA tensor launches
    the kernel: the ``cuda``-marked tests of tests/test_torch_cuda.py and
    chip_smoke.py's launch counts.)"""
    def no_build(kernel):
        raise AssertionError(f"{kernel.name} built for a CPU corpus")

    monkeypatch.setattr(backend.Kernel, "library", no_build)
    before = {k.name: k.launches for k in backend.KERNELS}
    c = port_dc.DeviceCorpus(device="cpu", fp_initial_capacity=256,
                             fp_block_n=128, ts_initial_capacity=4)
    fps = {}
    for vid in range(1, 6):
        fps[vid] = rng.integers(0, 2**32, size=(300, 2), dtype=np.uint32)
        c.append_fingerprints(vid, fps[vid])
        c.upsert_timestamps(vid, [float(vid), vid + 1.5])
    assert c.match_timestamps([3.0, 4.5], min_match=2) == [(3, 2)]
    assert c.search_fingerprints(fps[4][:32], min_match=8)[0][0] == 4
    assert c.nearest_video_counts(fps[2][100:116]).get(2) == 16
    vid, offset, score = c.locate_fragment(fps[5][40:100])[0]
    assert (vid, offset, score) == (5, 40, 60)
    assert {k.name: k.launches for k in backend.KERNELS} == before
    with pytest.raises(ValueError, match="unsupported device"):
        port_dc.DeviceCorpus(device="meta")
