"""Where the port's entry points run: the CUDA card unless the caller asks
for the CPU, never falling back to the CPU silently."""

from __future__ import annotations

import torch


def resolve_device(device, entry: str) -> torch.device:
    """``None`` means the card; raises if it is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch: no CUDA device is available ({entry} runs on the "
            "card by default); pass device='cpu' to run the kernels' plain "
            "versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
