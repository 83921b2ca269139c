"""Carry a simulation's inputs into the port.

A simulator has no weights: the state a user brings is a trace and a
config.  These helpers build the port's :class:`~repro_torch.core.Trace`
from plain arrays and its :class:`~repro_torch.core.HMSConfig` from a
dict — e.g. ``dataclasses.asdict`` of a config made elsewhere, nested
``energy`` included — so the same point can be simulated by two
implementations without either importing the other.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np

from .core.timing import EnergyParams, HMSConfig
from .core.traces import Trace


def trace_from_arrays(name: str, col, is_write, footprint: int,
                      phase_id=None,
                      phase_names: Sequence[str] = ()) -> Trace:
    """A validated :class:`Trace` from column indices, a write mask, the
    footprint in bytes and (for scenario traces) per-request phase ids."""
    return Trace(str(name), np.asarray(col, dtype=np.int64),
                 np.asarray(is_write, dtype=bool), int(footprint),
                 phase_id=None if phase_id is None else np.asarray(phase_id),
                 phase_names=tuple(phase_names))


def config_from_dict(d: Mapping[str, object]) -> HMSConfig:
    """An :class:`HMSConfig` from its field dict.  ``energy`` may be a
    dict of :class:`EnergyParams` fields or an ``EnergyParams``.  Unknown
    fields raise ``TypeError``, as the dataclass constructor does."""
    kw = dict(d)
    energy: Optional[object] = kw.pop("energy", None)
    if isinstance(energy, Mapping):
        energy = EnergyParams(**energy)
    elif energy is not None and not isinstance(energy, EnergyParams):
        energy = EnergyParams(**dataclasses.asdict(energy))
    if energy is not None:
        kw["energy"] = energy
    return HMSConfig(**kw)
