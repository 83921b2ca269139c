"""Public wrapper: model-layout flash attention.

On CUDA tensors :func:`flash_attention` launches the kernel in
``csrc/flash_attention.cu``; on CPU tensors it runs the plain version in
``ref.py``.  Any other placement raises.
"""

from __future__ import annotations

import math

import torch

from ... import _build
from .ref import flash_attention_reference

HEAD_DIMS = (16, 32, 64, 80, 128)   # the kernel's instantiations


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
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, KV, hd, int(causal), float(softcap),
            1.0 / math.sqrt(hd), code, _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    _build.count("flash_attention")
    return out
