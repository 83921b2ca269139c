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

The split mode serves a cache split over ``model`` by head dim: each
rank holds a slice of every head's dim, so attention takes two launches
around a sum over the ranks.  :func:`paged_decode_scores` gives the
slice's float32 products q . k of every (head, token), which the ranks
sum; :func:`paged_decode_apply` turns the summed scores into the softmax
and its product with the rank's slice of V.  Both kernels load 8 bytes a
lane (a 4-element bf16 slice is one load), or one element where the slice
is not a multiple of 8 bytes.  They take slices of up to ``SPLIT_MAX``
values; their launches count as ``paged_attention_scores`` and
``paged_attention_apply``, the whole-head kernel's as ``paged_attention``.
"""

from __future__ import annotations

import math

import torch

from ... import _build
from .ref import (paged_apply_reference, paged_attention_reference,
                  paged_scores_reference)

HEAD_DIMS = (16, 32, 64, 80, 128)   # head dims the kernel is held to
MAX_GP = 8                          # query heads per CTA (G > 8: chunks)
MAX_SPLITS = 64                     # CTAs per (sequence, KV head)
SPLIT_MAX = 64                      # head-dim slice of the split mode

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


def _split_args(name, B, H, pages, block_table, lengths):
    """Checks shared by the split mode's two wrappers; (pool, page, KV, d,
    n_pages)."""
    if pages.dim() != 4:
        raise ValueError(f"{name}: pool {tuple(pages.shape)}; expected "
                         "(pool, page, KV, d)")
    pool, page, KV, d = pages.shape
    if KV == 0 or H % KV:
        raise ValueError(f"{name}: {H} heads over {KV} KV heads")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} "
                         f"/ lengths {tuple(lengths.shape)} do not match "
                         f"batch {B}")
    for what, t in (("block_table", block_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {what} must be int32, got {t.dtype}")
    return pool, page, KV, d, block_table.shape[1]


def _split_kernel_checks(name, d, tensors, aligned):
    if d > SPLIT_MAX:
        raise ValueError(f"{name}: a head-dim slice of {d} values (at most "
                         f"{SPLIT_MAX})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def paged_decode_scores(q, k_pages, block_table, lengths):
    """The split mode's scores.  q: (B, 1, H, d), a head-dim slice of each
    query head; k_pages: (pool, page, KV, d), the same slice of the paged
    keys; block_table int32 (B, n_pages); lengths int32 (B,).  Returns
    float32 (B, H, n_pages * page): q . k over the slice, unscaled, for
    every token before the length.  The kernel leaves the entries at or
    past the length unwritten (undefined; ``paged_decode_apply`` never
    reads them); the plain version sets them to 0."""
    name = "paged_decode_scores"
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{name}: q {tuple(q.shape)}; expected (B, 1, H, d)")
    B, _, H, _ = q.shape
    pool, page, KV, d, n_pages = _split_args(name, B, H, k_pages,
                                             block_table, lengths)
    if q.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match the "
                         f"pool {tuple(k_pages.shape)}")
    G = H // KV
    qg = q.reshape(B, KV, G, d)
    if _build.placement(name, q, k_pages, block_table, lengths) == "cpu":
        return paged_scores_reference(qg, k_pages, block_table, lengths)
    code = _build.dtype_code(name, q)
    if k_pages.dtype != q.dtype:
        raise ValueError(f"{name}: q and the pool differ in dtype")
    _split_kernel_checks(name, d, (q, k_pages, block_table, lengths),
                         (q, k_pages))
    gp = min(MAX_GP, 1 << (G - 1).bit_length())
    out = torch.empty((B, H, n_pages * page), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = _build.library().paged_scores_launch(
            q.data_ptr(), k_pages.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, KV, G, gp, d, pool, page,
            n_pages, code, _build.stream_ptr(q))
    _build.check(err, "paged_attention_scores")
    _build.count("paged_attention_scores")
    return out


def paged_decode_apply(scores, v_pages, block_table, lengths, *,
                       scale: float, softcap: float = 0.0):
    """The split mode's softmax and product with V.  scores: float32 (B,
    H, n_pages * page), the products q . k summed over the head dim;
    v_pages: (pool, page, KV, d), this rank's slice of the paged values.
    Returns (B, 1, H, d) in v's type: softmax(softcap(scores * scale))
    over the tokens before each length, times V; the scores at or past a
    length are not read."""
    name = "paged_decode_apply"
    if scores.dim() != 3 or scores.dtype != torch.float32:
        raise ValueError(f"{name}: scores {scores.dtype} "
                         f"{tuple(scores.shape)}; expected float32 (B, H, T)")
    B, H, _ = scores.shape
    pool, page, KV, d, n_pages = _split_args(name, B, H, v_pages,
                                             block_table, lengths)
    if scores.shape[2] != n_pages * page:
        raise ValueError(f"{name}: scores over {scores.shape[2]} tokens, the "
                         f"table over {n_pages * page}")
    G = H // KV
    if _build.placement(name, scores, v_pages, block_table,
                        lengths) == "cpu":
        return paged_apply_reference(
            scores, v_pages, block_table, lengths, scale=scale,
            softcap=softcap).reshape(B, 1, H, d)
    code = _build.dtype_code(name, v_pages)
    _split_kernel_checks(name, d, (scores, v_pages, block_table, lengths),
                         (scores, v_pages))
    gp = min(MAX_GP, 1 << (G - 1).bit_length())
    pairs = B * KV * -(-G // gp)
    sms = torch.cuda.get_device_properties(
        scores.device).multi_processor_count
    n_split = max(1, min(n_pages, MAX_SPLITS, -(-sms // max(1, pairs))))
    out = torch.empty((B, 1, H, d), dtype=v_pages.dtype,
                      device=scores.device)
    ws = torch.empty(pairs * n_split * gp * (d + 2), dtype=torch.float32,
                     device=scores.device)
    counters = _ticket_counters(scores.device, pairs)
    with torch.cuda.device(scores.device):
        err = _build.library().paged_apply_launch(
            scores.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), B, KV, G, gp, d, pool, page, n_pages,
            n_split, float(softcap), float(scale), code,
            _build.stream_ptr(scores))
    _build.check(err, "paged_attention_apply")
    _build.count("paged_attention_apply")
    return out
