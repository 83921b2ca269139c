"""Public wrapper: the SSD chunked scan in the model layout.

On CUDA tensors :func:`ssd` launches the kernel in ``csrc/ssd_scan.cu``
(bf16: ``ssd_mma_kernel`` on the tensor cores; float32: ``ssd_fma_kernel``
on the FMA pipes); on CPU tensors it runs the plain version
(``ref.ssd_plain``).  Any other placement raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import _build
from .ref import ssd_plain

# (ssm_head_dim, ssm_state, ssm_chunk) the kernels are built for: every SSM
# config of ``repro_torch.configs``, full and smoke
KERNEL_SHAPES = ((64, 128, 128), (64, 64, 128), (16, 16, 128))
DESIGNS = {torch.bfloat16: "mma", torch.float32: "fma"}


def check_kernel_shape(p: int, n: int, chunk: int, dtype: torch.dtype) -> str:
    """The kernel design that runs this (head dim, state, chunk) and element
    type on the card ("mma" for bf16, "fma" for float32); raises
    ValueError for any other."""
    if dtype not in DESIGNS:
        raise ValueError(f"ssd: dtype {dtype} not supported (float32 or "
                         "bfloat16)")
    if (p, n, chunk) not in KERNEL_SHAPES:
        raise ValueError(f"ssd: head dim {p}, state {n}, chunk {chunk}; the "
                         f"kernel takes (p, n, chunk) in {KERNEL_SHAPES}")
    return DESIGNS[dtype]


def _row_stride(name: str, t) -> int:
    """Element stride between the (batch, position) rows of a (b, l, g, n)
    tensor whose (g, n) block is dense, e.g. a column slice of one
    projection; raises for other layouts."""
    b, l, g, n = t.shape
    if t.stride(3) != 1 or (g > 1 and t.stride(2) != n):
        raise ValueError(f"ssd: {name} rows must be dense (g, n) blocks, got "
                         f"strides {t.stride()}")
    rs = t.stride(1)
    if b > 1 and t.stride(0) != l * rs:
        raise ValueError(f"ssd: {name} batch stride {t.stride(0)} is not "
                         f"l x row stride {l} x {rs}")
    return rs


def ssd(x, dt, A, B, C, chunk: int,
        initial_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, l, h, p), dt (b, l, h) float32, A (h,) float32, B/C
    (b, l, g, n), initial_state (b, h, p, n) float32 or None (zeros).
    Returns (y (b, l, h, p) in x's type, final_state (b, h, p, n) float32).

    Any length ``l``: positions past it up to the chunk boundary act as
    ``dt = 0, x = 0``, the reference's zero padding."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or B.shape != C.shape:
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}; expected (b, l, h, p), (b, l, h),"
                         " (h,) and two equal (b, l, g, n)")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, l, h) or A.shape != (h,) or B.shape[:2] != (b, l) \
            or g == 0 or h % g:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} do not agree (h a multiple of g)")
    if initial_state is not None and initial_state.shape != (b, h, p, n):
        raise ValueError(f"ssd: initial_state {tuple(initial_state.shape)}, "
                         f"expected {(b, h, p, n)}")
    tensors = (x, dt, A, B, C) + (
        () if initial_state is None else (initial_state,))
    if _build.placement("ssd_scan", *tensors) == "cpu":
        return ssd_plain(x, dt, A, B, C, chunk, initial_state=initial_state)
    code = _build.dtype_code("ssd_scan", x)
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError("ssd: x, B and C differ in dtype")
    f32 = [t for t in (dt, A, initial_state) if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("ssd: dt, A and initial_state must be float32")
    design = check_kernel_shape(p, n, chunk, x.dtype)
    if not all(t.is_contiguous() for t in [x] + f32):
        raise ValueError("ssd: x, dt, A and initial_state must be "
                         "contiguous")
    rs = _row_stride("B", B)
    if _row_stride("C", C) != rs:
        raise ValueError("ssd: B and C rows differ in stride")
    # the bf16 kernel copies 16-byte pieces of x, B and C rows and reads
    # the initial state as float pairs
    if design == "mma" and (
            any(v % 16 for v in (x.data_ptr(), B.data_ptr(), C.data_ptr(),
                                 rs * B.element_size()))
            or (initial_state is not None and initial_state.data_ptr() % 8)):
        raise ValueError("ssd: bf16 x, B and C must start on 16-byte "
                         "addresses with B/C rows a multiple of 16 bytes "
                         "apart, and initial_state on 8")
    y = torch.empty_like(x)
    state = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), rs,
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, l, h, g, p, n, chunk, code,
            _build.stream_ptr(x))
    _build.check(err, "ssd_scan")
    _build.count("ssd_scan")
    _build.count("ssd_scan." + design)
    return y, state


def blocks_per_sm(p: int, n: int, chunk: int, dtype: torch.dtype) -> int:
    """CTAs of the kernel for this shape and type that one SM of the current
    card holds at once (CUDA's occupancy calculator); needs the card."""
    design = check_kernel_shape(p, n, chunk, dtype)
    return int(_build.library().ssd_scan_blocks_per_sm(
        p, n, chunk, 1 if design == "mma" else 0))
