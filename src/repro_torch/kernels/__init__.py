"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  ``repro_torch._build`` compiles every ``*/csrc/*.cu`` into one
shared library at first use on a CUDA device."""
