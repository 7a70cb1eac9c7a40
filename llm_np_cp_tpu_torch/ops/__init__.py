"""Ops: norms, activations, RoPE, attention, sampling (plain PyTorch), and
the hand-written CUDA kernels under ``ops/cuda``."""
