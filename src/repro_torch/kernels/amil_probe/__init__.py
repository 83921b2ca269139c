"""Batched AMIL residency probe (CUDA kernel + plain PyTorch version)."""
