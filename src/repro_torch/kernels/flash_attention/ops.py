"""Public wrapper: model-layout flash attention.

On CUDA tensors :func:`flash_attention` launches a kernel chosen by the
inputs' type, both on the tensor cores: bf16 the wgmma kernel in
``csrc/flash_attention_wgmma.cu``, float32 the ``mma.sync`` kernel in
``csrc/flash_attention_mma3.cu``, whose operands are split into three bf16
pieces each (a float32 product on the tensor cores would be TF32).  That
is dispatch on the type, not a fallback: a call the kernel refuses raises.
On CPU tensors it runs the plain version in ``ref.py``.  Any other
placement raises.
"""

from __future__ import annotations

import math

import torch

from ... import _build
from .ref import flash_attention_reference

HEAD_DIMS = (16, 32, 64, 80, 128)   # the kernels' instantiations
DESIGNS = {torch.bfloat16: "wgmma", torch.float32: "mma3"}


def check_kernel_shape(hd: int, dtype: torch.dtype) -> str:
    """The kernel design that runs this head dim and element type on the
    card ("wgmma" for bf16, "mma3" for float32); raises for any other."""
    if dtype not in DESIGNS:
        raise ValueError(f"flash_attention: dtype {dtype} not supported "
                         "(float32 or bfloat16)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    return DESIGNS[dtype]


def flash_attention(q, k, v, *, causal: bool = True, softcap: float = 0.0):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) -> (B, S, H, hd).

    Query head h reads KV head h // (H // KV); queries sit at the end of the
    key timeline (offset T - S), so causal attention needs S <= T."""
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
    if _build.placement("flash_attention", q, k, v) == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         softcap=softcap)
    code = _build.dtype_code("flash_attention", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v differ in dtype")
    design = check_kernel_shape(hd, q.dtype)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, KV, hd, int(causal), float(softcap),
            1.0 / math.sqrt(hd), code, _build.stream_ptr(q))
    _build.check(err, f"flash_attention ({design})")
    _build.count("flash_attention")
    _build.count(f"flash_attention.{design}")
    return out


def blocks_per_sm(hd: int) -> int:
    """CTAs of the float32 kernel (design "mma3") at this head dim that one
    SM of the current card holds at once (CUDA's occupancy calculator);
    needs the card."""
    check_kernel_shape(hd, torch.float32)
    return int(_build.library().flash_attention_blocks_per_sm(hd))
