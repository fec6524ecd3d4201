"""Kernels of the port: hand-written CUDA with plain PyTorch versions beside them."""
