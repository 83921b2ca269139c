"""Flash attention forward (CUDA kernel + plain PyTorch version)."""
