"""tvidz_tpu_torch — tvidz's fingerprinting and duplicate detection on PyTorch
and CUDA, for one NVIDIA H100.

A port of ``tvidz_tpu`` (JAX on a TPU), which stays in the repository as the
reference each module is tested against. The layout mirrors it:

- ``ops``      — scene scores, pHash, the fused fingerprint block (kernel
                 K1, ``csrc/fingerprint_block.cu``), the packed-Hamming corpus
                 scan (kernel K2, ``csrc/corpus_scan.cu``) and timestamp
                 matching; each kernel sits beside its plain PyTorch version.
- ``models``   — ``FingerprintModel``, the per-block streaming path.
- ``corpus``   — ``DeviceCorpus``: host mirrors plus device tensors.
- ``pipeline`` — ``Analyzer`` and checkpoints.
- ``cli``      — ``python -m tvidz_tpu_torch analyze|ingest|fingerprint``.

It imports torch and never jax; the reference's jax-free host modules
(decode, store, config, golden models) come in through ``_reference``.
"""

__version__ = "0.1.0"
