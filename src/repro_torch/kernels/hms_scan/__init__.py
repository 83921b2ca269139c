"""The HMS engine's sequential scan (CUDA kernel + plain PyTorch version)."""
