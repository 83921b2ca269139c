"""Public wrapper: paged decode attention.

On CUDA tensors :func:`paged_decode_attention` launches the kernel in
``csrc/paged_attention.cu``; on CPU tensors it runs the plain version in
``ref.py``.  Any other placement raises.  A live page whose table entry
lies outside the pool fails a device-side assert inside the kernel (see
the source note), so the wrapper queues no check of its own.  The kernel
is one launch: the CTA that finishes a (sequence, KV head) last merges its
splits, counted on int32 tickets that the kernel leaves zero.  The tickets
are one buffer per device, so calls on one device run on one stream at a
time (as the serving path's do).
"""

from __future__ import annotations

import math

import torch

from ... import _build
from .ref import paged_attention_reference

HEAD_DIMS = (16, 32, 64, 80, 128)   # head dims the kernel is held to
MAX_GP = 8                          # query heads per CTA (G > 8: chunks)
MAX_SPLITS = 64                     # CTAs per (sequence, KV head)

_counters = {}                      # device -> int32 tickets, kept zero


def check_kernel_shape(hd: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel takes this head dim and element type."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_decode_attention: dtype {dtype} not "
                         "supported (float32 or bfloat16)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")


def _ticket_counters(device, n: int):
    """The kernel's per-(sequence, KV head) ticket counters: zeroed once
    when (re)allocated, and every call leaves them zero again."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


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
    check_kernel_shape(hd, q.dtype)
    tensors = (q, k_pages, v_pages, block_table, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_decode_attention: q and the pools must be "
                         "16-byte aligned")
    n_pages = block_table.shape[1]
    gp = min(MAX_GP, 1 << (G - 1).bit_length())
    pairs = B * KV * -(-G // gp)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    # split each sequence's pages over enough CTAs to fill the card once
    n_split = max(1, min(n_pages, MAX_SPLITS, -(-sms // max(1, pairs))))
    out = torch.empty_like(q)
    ws = torch.empty(pairs * n_split * gp * (hd + 4), dtype=torch.float32,
                     device=q.device)
    counters = _ticket_counters(q.device, pairs)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), B, KV, G, gp, hd, pool, page,
            n_pages, n_split, float(softcap), 1.0 / math.sqrt(hd), code,
            _build.stream_ptr(q))
    _build.check(err, "paged_attention")
    _build.count("paged_attention")
    return out
