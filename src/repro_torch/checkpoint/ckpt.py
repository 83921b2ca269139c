"""Atomic checkpoints in the JAX package's on-disk layout (the port of
``checkpoint/ckpt.py``).

Layout: ``<dir>/step_<n>/`` holding ``manifest.json`` (step, leaf count,
dtypes, shapes and the ``extra`` dict: the data iterator's state and the
step) and one ``leaf_<i>.npy`` per leaf, bf16 written as float32 (a
lossless upcast).  Writes go to ``<dir>/.tmp_<n>`` and are renamed into
place, so a crash mid-write never corrupts the latest checkpoint
(:func:`latest_step` skips step directories without a manifest).

A training state is written as the reference's tree
``{"params": ..., "opt": {"master", "m", "v", "step"}}`` flattened the way
``jax.tree`` flattens it (sorted keys: the optimizer's m, master, step and
v, then the parameters), with each stacked layer leaf assembled from the
port's per-layer parameters (``convert.jax_leaf_order``).  So either
package restores the other's checkpoint: the reference's ``restore`` reads
only the leaf count, the leaf files and ``extra``.  The reference's
``treedef`` entry (a serialized JAX tree) is not written; the port's
manifests name the layout in its place.

``AsyncCheckpointer`` snapshots to host memory synchronously and writes on
a worker thread, keeping the last ``keep`` checkpoints; a failed write is
raised by the next ``wait()``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..convert import jax_leaf_order, stack_shape

_MANIFEST = "manifest.json"
LAYOUT = "jax-flatten-order {params, opt: {master, m, v, step}}"


def _host(x) -> np.ndarray:
    """A leaf as a numpy array for ``np.save`` (bf16 as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return str(np.asarray(x).dtype)


def save(path: str, step: int, leaves: Sequence[Any],
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save of ``leaves`` (tensors or arrays, in the
    order they are restored).  Returns the final checkpoint directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = os.path.join(path, f".tmp_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": LAYOUT,
        "n_leaves": len(leaves),
        "dtypes": [_dtype_name(x) for x in leaves],
        "shapes": [list(x.shape) for x in leaves],
        "extra": extra or {},
    }
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), _host(leaf))
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and os.path.exists(
                os.path.join(path, d, _MANIFEST)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(path: str, like: Sequence[Any], step: Optional[int] = None):
    """Read the checkpoint at ``step`` (default: the latest complete one)
    into leaves shaped and typed as ``like`` (tensors): returns (CPU
    tensors, step, extra).  The leaf count and every shape are checked."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["n_leaves"] != len(like):
        raise ValueError(f"checkpoint/model structure mismatch: "
                         f"{manifest['n_leaves']} leaves, expected "
                         f"{len(like)}")
    out = []
    for i, ref in enumerate(like):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        if list(arr.shape) != list(ref.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != expected "
                             f"{tuple(ref.shape)}")
        out.append(torch.from_numpy(arr).to(ref.dtype))
    return out, step, manifest["extra"]


# ---------------------------------------------------------------------------
# A training state as the reference's leaves.
# ---------------------------------------------------------------------------

def _tree_leaves(named: Dict[str, torch.Tensor], cfg) -> List[torch.Tensor]:
    """One tree of the model's parameters (or an optimizer state keyed like
    them) as the JAX tree's leaves: each stack of layers as one tensor."""
    out = []
    for path, names in jax_leaf_order(named, cfg):
        lead = stack_shape(path, cfg)
        if not lead:
            out.append(named[names[0]])
            continue
        t = torch.stack([named[n] for n in names])
        out.append(t.reshape(lead + t.shape[1:]))
    return out


def state_leaves(params: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
                 cfg) -> List[torch.Tensor]:
    """``{"params": params, "opt": opt_state}`` as the reference's flattened
    leaves: the optimizer's m, master, step and v, then the parameters."""
    return (_tree_leaves(opt_state["m"], cfg)
            + _tree_leaves(opt_state["master"], cfg)
            + [opt_state["step"]]
            + _tree_leaves(opt_state["v"], cfg)
            + _tree_leaves(params, cfg))


@torch.no_grad()
def load_state_leaves(leaves: Sequence[torch.Tensor],
                      params: Dict[str, torch.Tensor],
                      opt_state: Dict[str, Any], cfg,
                      place: Optional[Callable[[str, torch.Tensor],
                                               torch.Tensor]] = None) -> None:
    """Copy :func:`state_leaves`-ordered ``leaves`` into the parameters and
    the optimizer state in place (each to its tensor's device and type).
    ``place(name, whole)``: the part of a whole per-layer tensor that the
    tensor ``name`` holds (a rank's shard on a mesh)."""
    it = iter(leaves)

    def fill(named):
        for path, names in jax_leaf_order(named, cfg):
            leaf = next(it)
            lead = stack_shape(path, cfg)
            parts = leaf.reshape((len(names),) + leaf.shape[len(lead):]) \
                if lead else leaf[None]
            for n, part in zip(names, parts):
                named[n].copy_(part if place is None else place(n, part))

    fill(opt_state["m"])
    fill(opt_state["master"])
    opt_state["step"].copy_(next(it))
    fill(opt_state["v"])
    fill(params)


class AsyncCheckpointer:
    """Snapshot to host synchronously, persist on a worker thread."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save(self, step: int, leaves: Sequence[Any], extra=None):
        self.wait()
        host = [x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else np.array(x)
                for x in leaves]

        def work():
            try:
                save(self.path, step, host, extra)
                self._gc()
            except BaseException as e:   # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.path)
            if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)
