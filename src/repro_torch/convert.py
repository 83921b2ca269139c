"""Carry inputs made elsewhere into the port.

A simulation's state is a trace and a config: :func:`trace_from_arrays`
builds the port's :class:`~repro_torch.core.Trace` from plain arrays and
:func:`config_from_dict` its :class:`~repro_torch.core.HMSConfig` from a
dict (e.g. ``dataclasses.asdict`` of a config made elsewhere, nested
``energy`` included).  A model's state is its weights:
:func:`model_params_from_jax` turns the JAX package's parameter tree, as
numpy arrays, into a state dict of the port's
:class:`~repro_torch.models.Transformer`.  A training state is the weights
and the optimizer's: :func:`adamw_state_from_jax` carries the reference's
``{"master", "m", "v", "step"}`` into the port's AdamW state, and
:func:`jax_leaf_order` maps the port's parameter names onto the leaves of
the JAX parameter tree in the order ``jax.tree`` flattens them (the
checkpoint's leaf order).  Neither package imports the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

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


_FLOAT32_LEAVES = ("scale", "A_log", "D", "dt_bias", "wg")
_STACKS = {"blocks": "n_layers", "enc_blocks": "n_enc_layers",
           "vision_blocks": "n_vision_layers"}      # stack -> its depth


def model_params_from_jax(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """A :class:`~repro_torch.models.Transformer` state dict (CPU tensors)
    from the JAX parameter tree of the same config (any family), given as
    nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``).

    The stacked ``params["blocks"]``, ``params["enc_blocks"]`` and
    ``params["vision_blocks"]`` leaves are split along their leading layer
    axis into ``blocks.{i}.*`` (likewise ``enc_blocks.{i}.*``,
    ``vision_blocks.{i}.*``), or for the hybrid's ``blocks`` along its two
    axes (super-block, Mamba2 layer) into ``blocks.{s}.{j}.*``;
    ``shared.*`` and the other top-level leaves are carried as they are.
    Norm scales, the MoE router ``wg`` and the SSM's ``A_log``, ``D`` and
    ``dt_bias`` stay float32, every other leaf takes ``cfg.torch_dtype``;
    bf16 values handed over as float32 come back exactly.  Load with
    ``model.load_state_dict(...)``."""
    return _split_tree(params, cfg, float32=False)


def adamw_state_from_jax(state: Mapping, cfg) -> Dict[str, object]:
    """The port's AdamW state (``repro_torch.optim.adamw``, CPU tensors)
    from the reference's ``{"master", "m", "v", "step"}`` of the same
    config, as numpy arrays: each tree split by :func:`model_params_from_jax`'s
    names and kept float32, ``step`` an int32 0-d tensor."""
    out: Dict[str, object] = {k: _split_tree(state[k], cfg, float32=True)
                              for k in ("master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32)
    return out


def jax_leaf_order(names: Iterable[str], cfg) -> List[Tuple[Tuple[str, ...],
                                                            List[str]]]:
    """The JAX parameter tree's leaves in the order ``jax.tree`` flattens
    them (dict keys sorted at every level, so key paths in lexicographic
    order), each as (key path, the port's parameter names it stacks): one
    name for an unstacked leaf, the layers in order for a stacked one
    (``blocks``, ``enc_blocks``, ``vision_blocks``; the hybrid's blocks
    super-block by super-block, its Mamba2 layers within each).  ``names``:
    the port model's parameter names."""
    groups: Dict[Tuple[str, ...], list] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "blocks" and cfg.family == "hybrid":
            index, path = (int(parts[1]), int(parts[2])), \
                ("blocks", *parts[3:])
        elif parts[0] in _STACKS:
            index, path = (int(parts[1]),), (parts[0], *parts[2:])
        else:
            index, path = (), tuple(parts)
        groups.setdefault(path, []).append((index, name))
    return [(path, [n for _, n in sorted(members)])
            for path, members in sorted(groups.items())]


def stack_shape(path: Tuple[str, ...], cfg) -> Tuple[int, ...]:
    """The leading layer axes of the JAX leaf at ``path``: () for an
    unstacked leaf."""
    if path[0] not in _STACKS:
        return ()
    if path[0] == "blocks" and cfg.family == "hybrid":
        return (cfg.n_layers // cfg.attn_every, cfg.attn_every)
    return (getattr(cfg, _STACKS[path[0]]),)


def _split_tree(params: Mapping, cfg, float32: bool) -> Dict[str,
                                                              torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, leaf) -> None:
        dt = torch.float32 if float32 or name.rsplit(".", 1)[-1] \
            in _FLOAT32_LEAVES else cfg.torch_dtype
        out[name] = torch.from_numpy(
            np.array(leaf, dtype=np.float32)).to(dt)

    def walk(prefix: str, tree: Mapping, index: tuple) -> None:
        for key, val in tree.items():
            name = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(name, val, index)
            else:
                put(name, np.asarray(val)[index])

    walk("", {k: v for k, v in params.items() if k not in _STACKS}, ())
    for stack, depth in _STACKS.items():
        if stack not in params:
            continue
        if stack == "blocks" and cfg.family == "hybrid":
            for s in range(cfg.n_layers // cfg.attn_every):
                for j in range(cfg.attn_every):
                    walk(f"blocks.{s}.{j}", params[stack], (s, j))
            continue
        for i in range(getattr(cfg, depth)):
            walk(f"{stack}.{i}", params[stack], (i,))
    return out
