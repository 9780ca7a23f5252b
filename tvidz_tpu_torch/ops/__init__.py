"""Compute ops of the port: plain PyTorch, plus the hand-written CUDA kernels
K1 (``fused.fingerprint_block``) and K2 (``hamming.corpus_min_distance``)."""
