"""Public wrapper: the SSD chunked scan in the model layout.

On CUDA tensors :func:`ssd` launches the kernel in ``csrc/ssd_scan.cu``;
on CPU tensors it runs the plain version (``ref.ssd_plain``).  Any other
placement raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import _build
from .ref import ssd_plain

HEAD_DIM = 64             # the kernel's head dim (ssm_head_dim)
STATE_DIMS = (64, 128)    # its state dims (ssm_state)
CHUNKS = (128,)           # its chunk lengths (ssm_chunk)


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
    if p != HEAD_DIM or n not in STATE_DIMS or chunk not in CHUNKS:
        raise ValueError(f"ssd: head dim {p}, state {n}, chunk {chunk}; the "
                         f"kernel takes {HEAD_DIM}, {STATE_DIMS}, {CHUNKS}")
    if not all(t.is_contiguous() for t in [x] + f32):
        raise ValueError("ssd: x, dt, A and initial_state must be "
                         "contiguous")
    rs = _row_stride("B", B)
    if _row_stride("C", C) != rs:
        raise ValueError("ssd: B and C rows differ in stride")
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
    return y, state
