"""PyTorch / CUDA port of the HMS DRAM-cache reproduction.

``repro_torch.core.simulate`` runs the trace-driven HMS simulator with its
sequential scan as a hand-written CUDA kernel (``repro_torch.kernels``).
The package imports torch and numpy only; the JAX package ``repro`` is its
reference and is never imported here.
"""
