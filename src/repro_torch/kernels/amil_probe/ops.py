"""Public wrapper: batched AMIL residency probe.

On CUDA tensors :func:`amil_probe` launches the kernel in
``csrc/amil_probe.cu``; on CPU tensors it runs the plain version in
``ref.py``.  Any other placement raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import _build
from .ref import amil_probe_reference

_SMEM_LIMIT = 227 * 1024          # dynamic shared memory of one H100 block


def amil_probe(meta, slots, tags):
    """meta int32[num_slots]; slots/tags int32[N] -> int32[N] x 3."""
    if _build.placement("amil_probe", meta, slots, tags) == "cpu":
        return amil_probe_reference(meta, slots, tags)
    for name, t in (("meta", meta), ("slots", slots), ("tags", tags)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"amil_probe: {name} must be 1-D int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if slots.shape != tags.shape:
        raise ValueError("amil_probe: slots and tags differ in shape")
    n_slots = meta.shape[0]
    if not 0 < n_slots * 4 <= _SMEM_LIMIT:
        raise ValueError(f"amil_probe: a {n_slots}-lane table does not fit "
                         "one block's shared memory")
    meta, slots, tags = (t.contiguous() for t in (meta, slots, tags))
    _build.assert_in_range("amil_probe slots", slots, n_slots)
    n = slots.shape[0]
    hit, dirty, aff = (torch.empty_like(slots) for _ in range(3))
    if n == 0:
        return hit, dirty, aff
    lib = _build.library()
    with torch.cuda.device(meta.device):
        sms = torch.cuda.get_device_properties(meta.device) \
            .multi_processor_count
        err = lib.amil_probe_launch(
            meta.data_ptr(), n_slots, slots.data_ptr(), tags.data_ptr(), n,
            hit.data_ptr(), dirty.data_ptr(), aff.data_ptr(), 2 * sms,
            _build.stream_ptr(meta))
    _build.check(err, "amil_probe")
    _build.count("amil_probe")
    return hit, dirty, aff


def probe(meta, slots, tags, block: int = 256):
    """meta int32[num_slots]; slots/tags int32[N] (N padded here to a
    multiple of ``block``, with slot 0 / tag -1, as the reference does)."""
    (N,) = slots.shape
    pad = (-N) % block
    if pad:
        slots = F.pad(slots, (0, pad))
        tags = F.pad(tags, (0, pad), value=-1)
    hit, dirty, aff = amil_probe(meta, slots, tags)
    return hit[:N], dirty[:N], aff[:N]
