"""Public wrapper: batched AMIL residency probe.

On CUDA tensors :func:`amil_probe` launches the kernel in
``csrc/amil_probe.cu`` (one launch a call; the kernel checks the slots'
range itself): a table of up to ``MAX_LANES`` lanes is staged in one
CTA's shared memory, a larger one is read from device memory (through
L2) by the same kernel's other design.  On CPU tensors it runs the plain
version in ``ref.py``.  Any other placement raises.
"""

from __future__ import annotations

import torch

from ... import _build
from .ref import amil_probe_reference

_SMEM_LIMIT = 227 * 1024          # shared memory of one H100 block
_TABLE_OFFSET = 16                # the kernel's mbarrier, ahead of the table
# the largest table the kernel stages in shared memory on an H100: 58,108
# int32 lanes (the kernel asks the device for its own limit)
MAX_LANES = (_SMEM_LIMIT - _TABLE_OFFSET) // 4


def amil_probe(meta, slots, tags):
    """meta int32[num_slots]; slots/tags int32[N] -> int32[N] x 3.

    On the card a slot outside [0, num_slots) fails the stream (a
    device-side assert, as torch's own index checks do)."""
    if _build.placement("amil_probe", meta, slots, tags) == "cpu":
        return amil_probe_reference(meta, slots, tags)
    for name, t in (("meta", meta), ("slots", slots), ("tags", tags)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"amil_probe: {name} must be 1-D int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if slots.shape != tags.shape:
        raise ValueError("amil_probe: slots and tags differ in shape")
    n_slots = meta.shape[0]
    if n_slots == 0:
        raise ValueError("amil_probe: an empty table")
    meta, slots, tags = (t.contiguous() for t in (meta, slots, tags))
    hit, dirty, aff = (torch.empty_like(slots) for _ in range(3))
    n = slots.shape[0]
    if n == 0:
        return hit, dirty, aff
    with torch.cuda.device(meta.device):
        err = _build.library().amil_probe_launch(
            meta.data_ptr(), n_slots, slots.data_ptr(), tags.data_ptr(), n,
            hit.data_ptr(), dirty.data_ptr(), aff.data_ptr(),
            meta.device.index, _build.stream_ptr(meta))
    _build.check(err, "amil_probe")
    _build.count("amil_probe")
    return hit, dirty, aff


def probe(meta, slots, tags):
    """The reference's ``ops.probe``: meta int32[num_slots]; slots/tags
    int32[N].  The reference pads N to its Pallas block; the kernel takes
    any N, so nothing is padded here."""
    return amil_probe(meta, slots, tags)
