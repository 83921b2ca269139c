"""Mamba2 SSD chunked scan (CUDA kernel + plain PyTorch version)."""
