"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``kernels/*/csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``), one process per source, all started together, and the
objects are linked into one shared library with a plain C interface.  The
library lands in ``build/repro_torch/`` at the checkout root, named by a
hash of the sources and flags, so an unchanged tree reuses it and a
changed one rebuilds.  Nothing here includes PyTorch's headers: pointers
and the stream travel as integers (``tensor.data_ptr()``,
``torch.cuda.current_stream().cuda_stream``).

Each C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on anything but 0.  Each wrapper calls :func:`count` once per
launch, so a run can show that it went through its kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    # policy, slot, meta, offsets, lanes, cache, lines_alloc, ctc,
    # sets_alloc, ways_alloc, e_ways, n_domains, y, stream
    "hms_scan_launch": (_I, _P, _P, _P, _I, _P, _L, _P, _I, _I, _I, _I, _P,
                        _P),
    "ema_scan_launch": (_P, _L, ctypes.c_double, _P, _P),
    "amil_probe_launch": (_P, _I, _P, _P, _L, _P, _P, _P, _I, _P),
    # q, k, v, o, B, S, T, H, KV, hd, causal, softcap, scale, dtype, stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _F, _F, _I, _P),
    # q, k_pages, v_pages, block_table, lengths, o, workspace, counters, B,
    # KV, G, gp, hd, pool, page, n_pages, n_split, softcap, scale, dtype,
    # stream
    "paged_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _F, _F, _I, _P),
    # x, dt, A, B, C, bc_row, init, y, final_state, b, l, h, g, p, n,
    # chunk, dtype, stream
    "ssd_scan_launch": (_P, _P, _P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P),
    # p, n, chunk, dtype
    "ssd_scan_blocks_per_sm": (_I, _I, _I, _I),
}

launches: Dict[str, int] = {}
build_info: Dict[str, object] = {}
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def sources() -> List[Path]:
    return sorted(_PKG.glob("kernels/*/csrc/*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_PKG.glob("kernels/*/csrc/*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "repro_torch: nvcc not found (set CUDA_HOME or put nvcc on "
            "PATH); the CUDA kernels are built from source at first use")
    return found


def _compile(so: Path, tag: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:             # wait for every job, then judge
        out, err = proc.communicate()
        logs.append(f"== {src.name}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, so)
    build_info.update(seconds=time.perf_counter() - t0, log="".join(logs),
                      sources=[str(s.relative_to(_PKG.parent.parent))
                               for s in sources()])


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            tag = _digest()
            so = BUILD_DIR / f"librepro_torch_{tag}.so"
            if not so.exists():
                _compile(so, tag)
            lib = ctypes.CDLL(str(so))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            build_info.setdefault("seconds", 0.0)
            build_info["path"] = str(so)
            _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def count(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def reset_counts() -> None:
    for k in list(launches):
        launches[k] = 0


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(name: str, t) -> int:
    """The element-type enum of the attention kernels' C entries
    (0 float32, 1 bfloat16); any other type raises."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise ValueError(f"{name}: dtype {t.dtype} not supported (float32 or "
                         "bfloat16)")
    return codes[t.dtype]


def placement(name: str, *tensors) -> str:
    """"cpu" when every tensor lies on the CPU (the wrapper runs the plain
    version), "cuda" when all lie on one CUDA device (it launches the
    kernel); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return "cuda"
    raise ValueError(f"{name}: tensors on {sorted(kinds)}; expected all on "
                     "one CUDA device (or all on the CPU)")


def assert_in_range(name: str, index, bound: int) -> None:
    """Device-side check that every ``index`` lies in [0, bound), queued
    without a host sync; a violation fails the stream like torch's own
    index checks."""
    import torch
    if index.numel():
        lo, hi = torch.aminmax(index)
        torch._assert_async((lo >= 0) & (hi < bound),
                            f"{name}: index out of [0, {bound})")
