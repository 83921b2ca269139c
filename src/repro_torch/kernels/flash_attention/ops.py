"""Public wrapper: model-layout flash attention.

On CUDA tensors :func:`flash_attention` launches a kernel chosen by the
inputs' type, both on the tensor cores: bf16 the wgmma kernel in
``csrc/flash_attention_wgmma.cu``, float32 the ``mma.sync`` kernel in
``csrc/flash_attention_mma3.cu``, whose operands are split into three bf16
pieces each (a float32 product on the tensor cores would be TF32).  That
is dispatch on the type, not a fallback: a call the kernel refuses raises.
On CPU tensors it runs the plain version in ``ref.py``.  Any other
placement raises.

Training goes through :func:`flash_attention_trainable`, a
``torch.autograd.Function``: its forward is the same kernel, asked to write
each query row's log-sum-exp as well, and its backward is the kernels of
``csrc/flash_attention_bwd.cu`` on the tensor cores, chosen by type as
the forward's are (:data:`BWD_DESIGNS`: bf16 ``mma``, float32 ``mma3``)
(on CPU tensors, the plain ``flash_attention_backward_reference``).
Neither direction catches a refused shape or a failed launch.
"""

from __future__ import annotations

import math

import torch

from ... import _build
from .ref import flash_attention_backward_reference, flash_attention_reference

HEAD_DIMS = (16, 32, 64, 80, 128)   # the kernels' instantiations
DESIGNS = {torch.bfloat16: "wgmma", torch.float32: "mma3"}
# the backward's: mma.sync on bf16 operands, or on three bf16 pieces of
# each float32 operand
BWD_DESIGNS = {torch.bfloat16: "mma", torch.float32: "mma3"}


def check_kernel_shape(hd: int, dtype: torch.dtype) -> str:
    """The kernel design that runs this head dim and element type on the
    card ("wgmma" for bf16, "mma3" for float32); raises for any other."""
    if dtype not in DESIGNS:
        raise ValueError(f"flash_attention: dtype {dtype} not supported "
                         "(float32 or bfloat16)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    return DESIGNS[dtype]


def _shape(q, k, v, causal: bool):
    """(B, S, T, H, KV, hd) of a call; raises on a mismatch."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         "(B, S, H, hd) and two equal (B, T, KV, hd)")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)} (batch, head_dim, or "
                         "H a multiple of KV)")
    if causal and S > T:
        raise ValueError(f"flash_attention: causal with S {S} > T {T}")
    return B, S, T, H, KV, hd


def _kernel_checks(name: str, tensors, hd: int) -> tuple:
    """(dtype code, design) of a launch on the card; raises on a type,
    head dim, layout or alignment the kernels do not take."""
    q = tensors[0]
    code = _build.dtype_code(name, q)
    if any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name}: the attention tensors differ in dtype")
    design = check_kernel_shape(hd, q.dtype)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the attention tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the attention tensors must be 16-byte "
                         "aligned")
    return code, design


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            softcap: float = 0.0, with_lse: bool = False):
    """(out, lse): :func:`flash_attention`'s output and, ``with_lse``, each
    query row's log-sum-exp of its scores, float32 (B, H, S) (else
    None)."""
    B, S, T, H, KV, hd = _shape(q, k, v, causal)
    if _build.placement("flash_attention", q, k, v) == "cpu":
        if not with_lse:
            return flash_attention_reference(q, k, v, causal=causal,
                                             softcap=softcap), None
        return flash_attention_reference(q, k, v, causal=causal,
                                         softcap=softcap, return_lse=True)
    code, design = _kernel_checks("flash_attention", (q, k, v), hd)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device) \
        if with_lse else None
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, B, S, T, H, KV, hd,
            int(causal), float(softcap), 1.0 / math.sqrt(hd), code,
            _build.stream_ptr(q))
    _build.check(err, f"flash_attention ({design})")
    _build.count("flash_attention")
    _build.count(f"flash_attention.{design}")
    if with_lse:
        _build.count("flash_attention.lse")
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, softcap: float = 0.0):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) -> (B, S, H, hd).

    Query head h reads KV head h // (H // KV); queries sit at the end of the
    key timeline (offset T - S), so causal attention needs S <= T."""
    return flash_attention_forward(q, k, v, causal=causal,
                                   softcap=softcap)[0]


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                             softcap: float = 0.0):
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), from its output
    ``out``, its log-sum-exp ``lse`` (``flash_attention_forward``'s) and
    the output's gradient ``dout``, each in its input's type.  On the card
    the launches of ``csrc/flash_attention_bwd.cu`` (D = rowsum(dO O); dK
    and dV per (key tile, query head); where H > KV, the sum of the heads'
    float32 partials in head order; dQ), no atomics; on the CPU the plain
    version."""
    B, S, T, H, KV, hd = _shape(q, k, v, causal)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (B, H, S):
        raise ValueError(f"flash_attention_backward: out {tuple(out.shape)}"
                         f", dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    where = _build.placement("flash_attention_bwd", q, k, v, out, lse, dout)
    if where == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal=causal, softcap=softcap)
    code, _ = _kernel_checks("flash_attention_bwd", (q, k, v, out, dout), hd)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous "
                         "float32")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dsum = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    G = H // KV
    part = torch.empty(2, G, B, T, KV, hd, dtype=torch.float32,
                       device=q.device) if G > 1 else None
    design = BWD_DESIGNS[q.dtype]
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), B, S, T, H, KV, hd,
            int(causal), float(softcap), 1.0 / math.sqrt(hd), code,
            _build.stream_ptr(q))
    _build.check(err, f"flash_attention_bwd ({design})")
    _build.count("flash_attention_bwd")
    _build.count(f"flash_attention_bwd.{design}")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward kernel with its log-sum-exp,
    the backward kernels for dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, softcap: float):
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           softcap=softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.softcap = causal, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            softcap=ctx.softcap)
        return dq, dk, dv, None, None


def flash_attention_trainable(q, k, v, *, causal: bool = True,
                              softcap: float = 0.0):
    """:func:`flash_attention` as an autograd Function (for training)."""
    return FlashAttention.apply(q, k, v, causal, float(softcap))


def blocks_per_sm(hd: int) -> int:
    """CTAs of the float32 kernel (design "mma3") at this head dim that one
    SM of the current card holds at once (CUDA's occupancy calculator);
    needs the card."""
    check_kernel_shape(hd, torch.float32)
    return int(_build.library().flash_attention_blocks_per_sm(hd))


def bwd_blocks_per_sm(hd: int, dtype: torch.dtype) -> tuple:
    """(dK/dV, dQ): CTAs of the backward's two tile kernels at this head dim
    and type that one SM of the current card holds at once; needs the
    card."""
    check_kernel_shape(hd, dtype)
    code = 0 if dtype == torch.float32 else 1      # the C entries' codes
    lib = _build.library()
    return tuple(int(lib.flash_attention_bwd_blocks_per_sm(hd, code, which))
                 for which in (0, 1))
