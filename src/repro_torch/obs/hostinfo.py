"""Host + repo identity for run records (a port of the reference package's
``repro.obs.hostinfo``).

``git_info`` answers *which commit produced this record, and was the
working tree clean when it did?*  It is resolved once per process (the
ledger stamps every record with it) and degrades to ``None`` outside a git
checkout rather than failing.  ``host_metadata`` names the machine and the
toolchain: where the reference names its JAX version and backend, the port
names torch, its CUDA version and the card (name, power limit and driver,
from ``nvidia-smi``), all ``None`` on a host without a card.
"""

from __future__ import annotations

import functools
import os
import subprocess
from typing import Dict, Optional


@functools.lru_cache(maxsize=1)
def git_info() -> Dict[str, Optional[object]]:
    """``{"git_sha": <40-hex or None>, "git_dirty": <bool or None>}`` for
    the checkout this package runs from."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        sha = subprocess.run(
            ["git", "-C", here, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
        if sha is None:
            return {"git_sha": None, "git_dirty": None}
        dirty = bool(subprocess.run(
            ["git", "-C", here, "status", "--porcelain"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip())
        return {"git_sha": sha, "git_dirty": dirty}
    except (OSError, subprocess.SubprocessError):
        return {"git_sha": None, "git_dirty": None}


def _smi() -> Dict[str, Optional[str]]:
    """The first card's power limit and driver version from ``nvidia-smi``
    (``None`` each when it is missing or fails)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return {"gpu_power_limit": None, "driver": None}
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return {"gpu_power_limit": None, "driver": None}
    parts = [p.strip() for p in lines[0].split(",")]
    return {"gpu_power_limit": parts[1] if len(parts) > 1 else None,
            "driver": parts[2] if len(parts) > 2 else None}


@functools.lru_cache(maxsize=1)
def host_metadata() -> Dict[str, object]:
    """Process-stable host descriptor: platform, Python and torch versions,
    the card, and the git identity.  The ledger adds the ``device`` of each
    call to it."""
    import platform

    import torch

    gpu = {"gpu": None, "gpu_power_limit": None, "driver": None}
    if torch.cuda.is_available():
        gpu = {"gpu": torch.cuda.get_device_name(0), **_smi()}
    return {
        "cpu_count": os.cpu_count(),
        "platform": platform.platform(),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        **gpu,
        **git_info(),
    }
