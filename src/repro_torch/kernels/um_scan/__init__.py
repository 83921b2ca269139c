"""The UM paging engine's sequential scan (CUDA kernel + plain PyTorch
version)."""
