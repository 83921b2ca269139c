"""Quantized (int8 + per-chunk scale) gradient all-reduce with error
feedback (the port of the JAX package's ``parallel/compress.py``).

Ring all-reduce moves ~2x the gradient bytes per rank; quantizing the
exchanged chunks to int8 cuts the wire volume ~4x (scales are negligible).
The schedule is reduce-scatter-then-all-gather expressed as
``all_to_all_single`` + local sum + ``all_gather_into_tensor``, with the
quantizer applied to every wire transfer, in the reference's arithmetic
order (``amax``, ``max(amax, 1e-12) / 127``, round half to even, clip,
int8).  Error feedback (each quantization's residual carried into the next
round) keeps the convergence loss negligible.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist


def quantize(x: torch.Tensor, dim: Optional[int] = None):
    """Symmetric int8 quantization with a float32 scale per tensor (or per
    slice along ``dim``, kept as a size-1 dim)."""
    a = x.abs()
    amax = a.max() if dim is None else a.amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _mesh_group(mesh, axis_name: str):
    return mesh.get_group(axis_name), \
        int(mesh.shape[mesh.mesh_dim_names.index(axis_name)])


def _ar_body(flat: torch.Tensor, group, n: int) -> torch.Tensor:
    """flat: float32 (n * chunk,), this rank's whole gradient."""
    chunks = flat.view(n, -1)
    q, s = quantize(chunks, dim=1)
    # reduce-scatter: rank i receives chunk i from everyone
    q_x, s_x = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_x, q, group=group)
    dist.all_to_all_single(s_x, s, group=group)
    partial = dequantize(q_x, s_x).sum(dim=0)            # (chunk,)
    q2, s2 = quantize(partial[None, :], dim=1)
    # all-gather the reduced chunks
    qg = q2.new_empty((n * q2.shape[1],))
    sg = s2.new_empty((n,))
    dist.all_gather_into_tensor(qg, q2[0], group=group)
    dist.all_gather_into_tensor(sg, s2[0], group=group)
    return dequantize(qg.view(n, -1), sg.view(n, 1)).reshape(-1)


def quantized_allreduce(grads: Mapping[str, torch.Tensor], mesh,
                        axis_name: str = "data") -> Dict[str, torch.Tensor]:
    """Sum a gradient dict over mesh dim ``axis_name`` with an int8 wire
    format.  Each rank enters with its own gradients; every rank leaves
    with the (quantized) sum, each leaf in its own type."""
    group, n = _mesh_group(mesh, axis_name)
    names = list(grads)
    flat = torch.cat([grads[k].to(torch.float32).reshape(-1)
                      for k in names])
    size = flat.shape[0]
    pad = (-size) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    out = _ar_body(flat, group, n)[:size]
    res, off = {}, 0
    for k in names:
        g = grads[k]
        res[k] = out[off:off + g.numel()].view(g.shape).to(g.dtype)
        off += g.numel()
    return res


class ErrorFeedback:
    """Carry quantization residuals across steps (a dict of tensors)."""

    def __init__(self):
        self.residual: Optional[Dict[str, torch.Tensor]] = None

    def apply(self, grads: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        if self.residual is not None:
            grads = {k: g + self.residual[k] for k, g in grads.items()}
        q = {k: dequantize(*quantize(g)) for k, g in grads.items()}
        self.residual = {k: grads[k] - q[k] for k in grads}
        return q
