"""Paged decode attention over a KV page pool (CUDA kernel + plain PyTorch
version)."""
