"""Public wrapper: paged decode attention.

On CUDA tensors :func:`paged_decode_attention` launches the kernel in
``csrc/paged_attention.cu``; on CPU tensors it runs the plain version in
``ref.py``.  Any other placement raises.  A live page whose table entry
lies outside the pool fails a device-side assert inside the kernel (see
the source note), so the wrapper queues no check of its own.
"""

from __future__ import annotations

import math

import torch

from ... import _build
from .ref import paged_attention_reference



def paged_decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                           softcap: float = 0.0):
    """q: (B, 1, H, hd), one token per sequence; k_pages/v_pages:
    (pool, page, KV, hd); block_table: int32 (B, n_pages); lengths: int32
    (B,).  Returns (B, 1, H, hd).  Query head h reads KV head h // (H // KV)."""
    if q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 4 \
            or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}; expected (B, 1, H, hd) "
                         "and two equal (pool, page, KV, hd)")
    B, _, H, hd = q.shape
    pool, page, KV, hd2 = k_pages.shape
    if hd2 != hd or KV == 0 or H % KV:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} does "
                         f"not match the pools {tuple(k_pages.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"paged_decode_attention: block_table "
                         f"{tuple(block_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    for name, t in (("block_table", block_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise ValueError(f"paged_decode_attention: {name} must be int32, "
                             f"got {t.dtype}")
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    if _build.placement("paged_attention", q, k_pages, v_pages, block_table,
                        lengths) == "cpu":
        return paged_attention_reference(
            qg, k_pages, v_pages, block_table, lengths,
            softcap=softcap).reshape(B, 1, H, hd)
    code = _build.dtype_code("paged_attention", q)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_decode_attention: q and the pools differ in "
                         "dtype")
    tensors = (q, k_pages, v_pages, block_table, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    n_pages = block_table.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    # split each sequence's pages over enough CTAs for ~2 per SM
    n_split = max(1, min(n_pages, -(-2 * sms // max(1, B * KV))))
    out = torch.empty_like(q)
    ws = torch.empty(B * KV * n_split * G * (hd + 2), dtype=torch.float32,
                     device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), B, KV, G, hd, pool, page, n_pages, n_split,
            float(softcap), 1.0 / math.sqrt(hd), code, _build.stream_ptr(q))
    _build.check(err, "paged_attention")
    _build.count("paged_attention")
    return out
