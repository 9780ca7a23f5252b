"""Multi-stream dispatch helpers, on PyTorch.

The part of ``tvidz_tpu/pipeline/multistream.py`` the shared block
dispatcher needs: the power-of-two batch bucket and the warm pass. The
multistream engine itself (decoder threads, transfer pump, resolver) is not
ported yet (ROADMAP queue A).
"""

from __future__ import annotations

from tvidz_tpu_torch.models.fingerprint import FingerprintModel


def _bucket(k: int) -> int:
    """Next power of two >= k: the batch sizes a warm pass visits."""
    return 1 << (k - 1).bit_length()


def warm_dispatch(model: FingerprintModel, max_streams: int) -> None:
    """Run one ``forward_streams`` pass at every bucket up to
    ``max_streams`` concurrent streams. Nothing compiles per shape here;
    the pass loads the kernels and fills the allocator's pools before the
    first real burst."""
    bt = model.block_frames
    k = 1
    while True:
        lumas = tuple(model.example_payload() for _ in range(k))
        carries = [model.init_carry() for _ in range(k)]
        scores, fps, _ = model.forward_streams(lumas, carries, [bt] * k)
        scores.cpu(), fps.cpu()
        if k >= max_streams:
            return
        k = _bucket(k + 1)
