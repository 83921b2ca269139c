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
