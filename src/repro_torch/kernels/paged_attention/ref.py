"""Plain PyTorch version of the paged decode attention kernel: gather the
pages into a dense (B, T, KV, hd) cache, then masked float32 attention (the
formula of the JAX package's ``paged_attention_reference``), with the
unnormalized probabilities rounded to the value type before the product
with V, as the kernels round them (the identity in float32)."""

from __future__ import annotations

import math

import torch


def paged_attention_reference(q, k_pages, v_pages, block_table, lengths, *,
                              softcap: float = 0.0):
    """q: (B, KV, G, hd); k_pages/v_pages: (pool, page, KV, hd);
    block_table: int32 (B, n_pages); lengths: int32 (B,) -> (B, KV, G, hd)."""
    B, KV, G, hd = q.shape
    page = k_pages.shape[1]
    n_pages = block_table.shape[1]
    T = n_pages * page
    idx = block_table.long()
    k = k_pages[idx].reshape(B, T, KV, hd).float()
    v = v_pages[idx].reshape(B, T, KV, hd).float()
    logits = torch.einsum("bkgh,btkh->bkgt", q.float(), k) \
        * (1.0 / math.sqrt(hd))
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = torch.arange(T, device=q.device)[None, :] \
        < lengths.long()[:, None]                              # (B, T)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgt,btkh->bkgh", p.to(v_pages.dtype).float(), v)
    return (out / p.sum(dim=-1)[..., None]).to(q.dtype)


def paged_scores_reference(q, k_pages, block_table, lengths):
    """The split mode's first launch.  q: (B, KV, G, d), a head-dim slice
    of every query head; k_pages: (pool, page, KV, d), the same slice of
    the cache -> float32 (B, KV * G, T), T = n_pages * page: the partial
    products q . k of the slice (no scale) for t < length, 0 past it (the
    kernel leaves those unwritten)."""
    B, KV, G, d = q.shape
    page = k_pages.shape[1]
    T = block_table.shape[1] * page
    k = k_pages[block_table.long()].reshape(B, T, KV, d).float()
    s = torch.einsum("bkgh,btkh->bkgt", q.float(), k)
    live = torch.arange(T, device=q.device)[None, :] < lengths.long()[:, None]
    s = torch.where(live[:, None, None, :], s, torch.zeros_like(s))
    return s.reshape(B, KV * G, T)


def paged_apply_reference(scores, v_pages, block_table, lengths, *,
                          scale: float, softcap: float = 0.0):
    """The split mode's second launch.  scores: float32 (B, H, T), the
    products q . k summed over the head dim's slices; v_pages: (pool, page,
    KV, d), this rank's slice of the values -> (B, KV, H / KV, d) in v's
    type: the scores times ``scale``, softcapped, masked past each length
    (whatever they hold there, NaN included)
    and softmaxed in float32 as :func:`paged_attention_reference` does, the
    probabilities rounded to the value type before the product with V."""
    B, H, T = scores.shape
    KV, d = v_pages.shape[2], v_pages.shape[3]
    v = v_pages[block_table.long()].reshape(B, T, KV, d).float()
    logits = scores.view(B, KV, H // KV, T) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = torch.arange(T, device=scores.device)[None, :] \
        < lengths.long()[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgt,btkh->bkgh", p.to(v_pages.dtype).float(), v)
    return (out / p.sum(dim=-1)[..., None]).to(v_pages.dtype)
