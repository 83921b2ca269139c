"""Public wrapper: the SSD chunked scan in the model layout.

On CUDA tensors :func:`ssd` launches the kernel in ``csrc/ssd_scan.cu``
(bf16: ``ssd_mma_kernel``; float32: ``ssd_mma3_kernel``, its operands split
into three bf16 pieces; both on the tensor cores); on CPU tensors it runs
the plain version (``ref.ssd_plain``).  Any other placement raises.

Training goes through :class:`SSD`, a ``torch.autograd.Function``: its
forward is :func:`ssd`, its backward :func:`ssd_backward`, the kernels of
``csrc/ssd_scan_bwd.cu`` (on the tensor cores, designs by type as the
forward's: :data:`BWD_DESIGNS`) on CUDA tensors and
``ref.ssd_plain_backward`` on CPU tensors.
Neither direction catches a refused shape or a failed launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import _build
from .ref import ssd_plain, ssd_plain_backward

# (ssm_head_dim, ssm_state, ssm_chunk) the kernels are built for: every SSM
# config of ``repro_torch.configs``, full and smoke
KERNEL_SHAPES = ((64, 128, 128), (64, 64, 128), (16, 16, 128))
DESIGNS = {torch.bfloat16: "mma", torch.float32: "mma3"}
# the backward's (ssd_scan_bwd.cu): bf16 operands with the float32 factors
# rounded to bf16, or every operand in three bf16 pieces
BWD_DESIGNS = {torch.bfloat16: "mma", torch.float32: "mma3"}


def check_kernel_shape(p: int, n: int, chunk: int, dtype: torch.dtype) -> str:
    """The kernel design that runs this (head dim, state, chunk) and element
    type on the card ("mma" for bf16, "mma3" for float32); raises
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


def _check_shapes(name: str, x, dt, A, B, C, initial_state):
    """(b, l, h, p, g, n) of a call; raises on shapes that do not agree."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or B.shape != C.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}; expected (b, l, h, p), (b, l, h),"
                         " (h,) and two equal (b, l, g, n)")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, l, h) or A.shape != (h,) or B.shape[:2] != (b, l) \
            or g == 0 or h % g:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} do not agree (h a multiple of g)")
    if initial_state is not None and initial_state.shape != (b, h, p, n):
        raise ValueError(f"{name}: initial_state "
                         f"{tuple(initial_state.shape)}, expected "
                         f"{(b, h, p, n)}")
    return b, l, h, p, g, n


def _kernel_checks(name: str, x, dt, A, B, C, chunk: int, f32) -> tuple:
    """(dtype code, design, B/C row stride) of a launch on the card; raises
    on a type, shape, layout or alignment the kernels do not take.
    ``f32``: the float32 tensors of the call besides dt and A (None for an
    absent one)."""
    code = _build.dtype_code(name, x)
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"{name}: x, B and C differ in dtype")
    f32 = [t for t in (dt, A, *f32) if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError(f"{name}: dt, A and the states must be float32")
    design = check_kernel_shape(x.shape[3], B.shape[3], chunk, x.dtype)
    if not all(t.is_contiguous() for t in [x] + f32):
        raise ValueError(f"{name}: x, dt, A and the states must be "
                         "contiguous")
    rs = _row_stride("B", B)
    if _row_stride("C", C) != rs:
        raise ValueError(f"{name}: B and C rows differ in stride")
    # the kernels copy 16-byte pieces of x, B and C rows and read the
    # states as float pairs
    if any(v % 16 for v in (x.data_ptr(), B.data_ptr(), C.data_ptr(),
                            rs * B.element_size())) \
            or any(t.data_ptr() % 8 for t in f32[2:]):
        raise ValueError(f"{name}: x, B and C must start on 16-byte "
                         "addresses with B/C rows a multiple of 16 bytes "
                         "apart, and the states on 8")
    return code, design, rs


def ssd(x, dt, A, B, C, chunk: int,
        initial_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, l, h, p), dt (b, l, h) float32, A (h,) float32, B/C
    (b, l, g, n), initial_state (b, h, p, n) float32 or None (zeros).
    Returns (y (b, l, h, p) in x's type, final_state (b, h, p, n) float32).

    Any length ``l``: positions past it up to the chunk boundary act as
    ``dt = 0, x = 0``, the reference's zero padding."""
    b, l, h, p, g, n = _check_shapes("ssd", x, dt, A, B, C, initial_state)
    tensors = (x, dt, A, B, C) + (
        () if initial_state is None else (initial_state,))
    if _build.placement("ssd_scan", *tensors) == "cpu":
        return ssd_plain(x, dt, A, B, C, chunk, initial_state=initial_state)
    code, design, rs = _kernel_checks("ssd", x, dt, A, B, C, chunk,
                                      (initial_state,))
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


def ssd_backward(x, dt, A, B, C, chunk: int,
                 initial_state: Optional[torch.Tensor], dy,
                 dstate: Optional[torch.Tensor] = None):
    """(dx, ddt, dA, dB, dC, dinit): the gradients of :func:`ssd` at its
    inputs for the gradients ``dy`` of y and ``dstate`` of the final state
    (None: zero); dx, dB and dC in x's type (dB and dC dense), ddt, dA and
    dinit float32 (dinit None without an initial state).  On the card the
    launches of ``csrc/ssd_scan_bwd.cu`` (with more than one chunk or an
    initial state, the walks over the chunks for the entering states and
    the leaving state gradients; one CTA a chunk and head; the fixed-order
    sums over the heads of a group and over chunks and batch rows), no
    atomics.  On the CPU the plain version."""
    b, l, h, p, g, n = _check_shapes("ssd_backward", x, dt, A, B, C,
                                     initial_state)
    if dy.shape != x.shape or (dstate is not None
                               and dstate.shape != (b, h, p, n)):
        raise ValueError(f"ssd_backward: dy {tuple(dy.shape)}, dstate "
                         f"{None if dstate is None else tuple(dstate.shape)}"
                         f"; expected {tuple(x.shape)} and {(b, h, p, n)}")
    tensors = [t for t in (x, dt, A, B, C, initial_state, dy, dstate)
               if t is not None]
    if _build.placement("ssd_scan_bwd", *tensors) == "cpu":
        return ssd_plain_backward(x, dt, A, B, C, chunk, initial_state, dy,
                                  dstate)
    code, _, rs = _kernel_checks("ssd_backward", x, dt, A, B, C, chunk,
                                 (initial_state, dstate))
    if dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("ssd_backward: dy must be contiguous in x's type")
    dev, f32 = x.device, torch.float32
    nc = -(-l // chunk)
    dx = torch.empty_like(x)
    ddt = torch.empty(b, l, h, dtype=f32, device=dev)
    dA = torch.empty(h, dtype=f32, device=dev)
    dB = torch.empty(b, l, g, n, dtype=x.dtype, device=dev)
    dC = torch.empty_like(dB)
    dinit = None if initial_state is None else \
        torch.empty(b, h, p, n, dtype=f32, device=dev)
    # the entering states and leaving state gradients of chunks 1 .. and
    # 0 .. nc - 2; the heads' dB/dC partials; the chunks' dA partials
    states, dstates = (torch.empty(b, h, nc - 1, p, n, dtype=f32, device=dev)
                       if nc > 1 else None for _ in range(2))
    part_bc = torch.empty(2, h, b, l, n, dtype=f32, device=dev)
    part_a = torch.empty(nc, b, h, dtype=f32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), rs, ptr(initial_state), dy.data_ptr(),
            ptr(dstate), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), ptr(dinit), ptr(states),
            ptr(dstates), part_bc.data_ptr(), part_a.data_ptr(), b, l, h, g,
            p, n, chunk, code, _build.stream_ptr(x))
    _build.check(err, "ssd_scan_bwd")
    _build.count("ssd_scan_bwd")
    _build.count("ssd_scan_bwd." + BWD_DESIGNS[x.dtype])
    return dx, ddt, dA, dB, dC, dinit


class SSD(torch.autograd.Function):
    """The SSD scan with a gradient: :func:`ssd` forward, saving its inputs
    (not the per-chunk states: the backward recomputes them), and
    :func:`ssd_backward`.  An output whose gradient is unused (the final
    state, in training) reaches the backward as None, not as zeros:
    the kernel takes a null dstate."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, chunk: int):
        y, state = ssd(x, dt, A, B, C, chunk, initial_state=initial_state)
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, init = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dinit = ssd_backward(
            x, dt, A, B, C, ctx.chunk, init, dy.contiguous(),
            None if dstate is None else dstate.contiguous())
        return dx, ddt, dA, dB, dC, dinit, None


def blocks_per_sm(p: int, n: int, chunk: int, dtype: torch.dtype) -> int:
    """CTAs of the kernel for this shape and type that one SM of the current
    card holds at once (CUDA's occupancy calculator); needs the card."""
    design = check_kernel_shape(p, n, chunk, dtype)
    return int(_build.library().ssd_scan_blocks_per_sm(
        p, n, chunk, 1 if design == "mma" else 0))


def bwd_blocks_per_sm(p: int, n: int, chunk: int, dtype: torch.dtype) -> dict:
    """CTAs per SM of the backward's chunk kernel and walk kernel for this
    shape and type (CUDA's occupancy calculator); needs the card."""
    code = 1 if check_kernel_shape(p, n, chunk, dtype) == "mma" else 0
    lib = _build.library()
    return {k: int(lib.ssd_scan_bwd_blocks_per_sm(p, n, chunk, code, w))
            for k, w in (("chunk", 0), ("walk", 1))}
