"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
torch oracles; ``ops`` dispatches by device."""
