"""Device-mesh construction.

Port of ``tvidz_tpu/parallel/mesh.py``. The mesh has two axes:

- ``data``   — batches of clips and queries (data parallelism);
- ``corpus`` — the fingerprint and timestamp corpus rows (the corpus
  sharded over the cards; per-shard evidence is combined across them).

The reference's ``jax.sharding.Mesh`` runs one SPMD program over it. On
PyTorch one process drives every local card: a mesh is a (data, corpus)
grid of ``torch.device``s, a sharded tensor is one tensor per cell
(``parallel.sharded_search.Sharded``), each kernel launches once per shard
on its device, and results are gathered onto the mesh's first device with
``.to`` (peer copies between cards). A device may repeat: ``[cuda:0] * 8``
(or ``[cpu] * 8`` in the tests) is the counterpart of the reference's
8-device virtual CPU mesh, and runs every shard on one card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tvidz_tpu_torch import backend

DATA_AXIS = "data"
CORPUS_AXIS = "corpus"
# Cells of a CPU mesh made without ``devices`` or ``n_devices``: the
# reference tests' virtual CPU device count (tests/conftest.py).
CPU_CELLS = 8


def mesh_shape_for(n_devices: int, corpus_fraction: int = 4) -> Tuple[int, int]:
    """(data, corpus) sizes: favour the corpus axis (the big-memory
    dimension) while keeping both axes > 1 where possible."""
    if n_devices == 1:
        return (1, 1)
    corpus = 1
    # Largest power-of-2 divisor of n_devices, capped at corpus_fraction.
    while corpus * 2 <= min(corpus_fraction, n_devices) and n_devices % (corpus * 2) == 0:
        corpus *= 2
    if corpus == 1 and n_devices % 2 == 0:
        corpus = 2
    data = n_devices // corpus
    return (data, corpus)


class Mesh:
    """A (data, corpus) grid of devices: ``devices[d][c]`` is cell (d, c)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(row) for row in devices)
        self.shape: Dict[str, int] = {DATA_AXIS: len(self.devices),
                                      CORPUS_AXIS: len(self.devices[0])}

    @property
    def home(self) -> torch.device:
        """Cell (0, 0): where gathered results land."""
        return self.devices[0][0]

    @property
    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in row-major cell order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def make_mesh(
    n_devices: Optional[int] = None,
    data_size: Optional[int] = None,
    corpus_size: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices``, shaped
    ``(data_size, corpus_size)`` or ``mesh_shape_for(n)``.

    Without ``devices`` the device is ``backend.resolve_device()``'s
    (``TVIDZ_TORCH_DEVICE``, else ``cuda``; raises without a card unless
    the CPU was asked for): every visible card, or on the CPU ``[cpu] * n``
    with ``n = n_devices`` or 8, the reference's virtual CPU device count."""
    if devices is None:
        device = backend.resolve_device()
        if device.type == "cpu":
            devices = [device] * (n_devices or CPU_CELLS)
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [backend.resolve_device(d) for d in devices]
    n = n_devices or len(devices)
    if data_size and corpus_size:
        shape = (data_size, corpus_size)
    else:
        shape = mesh_shape_for(n)
    if shape[0] * shape[1] != n or n > len(devices):
        raise ValueError(f"mesh shape {shape} does not fit {n} of "
                         f"{len(devices)} devices")
    return Mesh([devices[d * shape[1]:(d + 1) * shape[1]] for d in range(shape[0])])
