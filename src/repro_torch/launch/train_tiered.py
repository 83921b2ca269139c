"""Tiered training launcher (the port's copy of the JAX package's
``examples/train_tiered.py``).

Trains an LM whose parameters + optimizer state exceed a configured
fast-tier budget: the memtier ``WeightStreamer`` scores every leaf with the
paper's DRAM-affinity machinery (write-intensive optimizer state pins in
the fast tier; read-only streamed weights bypass to the host tier) and
stages streamed leaves in and out around each step.  On the card the tiers
are device memory and pinned host memory; ``--device cpu`` runs the
kernels' plain versions on the host, where both tiers are host memory.

    python -m repro_torch.launch.train_tiered --device cpu
    python -m repro_torch.launch.train_tiered --arch qwen2.5-3b --steps 4 \\
        --seq 128 --batch 8

The reference's flags and defaults (a ~6M-parameter model derived from
granite-8b's smoke config), plus ``--device`` (default the card) and
``--arch``, which trains a registered config at its published widths
instead of the derived one.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import torch

from ..configs import get_config
from ..data.synthetic import for_model
from ..memtier import WeightStreamer
from ..models import init_params
from ..models.config import ModelConfig
from ..optim import adamw
from . import steps as steps_lib


def tiered_config(d_model: int, layers: int, vocab: int) -> ModelConfig:
    """The reference example's model: granite-8b's smoke config at the
    given width, depth and vocabulary."""
    base = get_config("granite-8b", smoke=True)
    return dataclasses.replace(
        base, name="tiered", n_layers=layers, d_model=d_model,
        n_heads=max(4, d_model // 64), n_kv_heads=max(2, d_model // 128),
        d_ff=d_model * 4, vocab=vocab, head_dim=None).validate()


def state_bytes(model, opt_state) -> int:
    """Bytes of the parameters and the whole AdamW state."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    for key in ("master", "m", "v"):
        n += sum(t.numel() * t.element_size()
                 for t in opt_state[key].values())
    return n + opt_state["step"].element_size()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: ModelConfig, model, *, steps: int, seq: int, batch: int,
        fast_frac: float, log: Callable[[str], None] = print) -> dict:
    """Tiered training of ``model`` (its parameters on their device) for
    ``steps`` steps of ``launch.steps.make_train_step`` on ``for_model(cfg,
    seq, batch)`` (AdamW's defaults, as the reference example), with a
    fast-tier budget of ``fast_frac`` of the state.
    Prints the reference example's lines through ``log``.  Returns the
    losses and grad norms, each step's stage-in / step / flush-out
    seconds (the device synchronized at each boundary), device memory
    after each flush-out (on the card), the streamer, the model and the
    optimizer state."""
    dev = next(model.parameters()).device
    opt = adamw.init(dict(model.named_parameters()))
    nbytes = state_bytes(model, opt)
    nparams = sum(p.numel() for p in model.parameters())
    budget = int(nbytes * fast_frac)
    log(f"{nparams:,} params; state {nbytes/2**20:.0f} MiB; "
        f"fast-tier budget {budget/2**20:.0f} MiB")

    ws = WeightStreamer(model, opt, fast_budget_bytes=budget)
    log(f"placement: {len(ws.placement.pinned)} leaves pinned "
        f"({ws.placement.fast_bytes/2**20:.0f} MiB), "
        f"{len(ws.placement.streamed)} streamed "
        f"({ws.placement.slow_bytes/2**20:.0f} MiB)")

    step = steps_lib.make_train_step(cfg)
    data = for_model(cfg, seq, batch)
    out = {"losses": [], "grad_norms": [], "stage_in_s": [], "step_s": [],
           "flush_out_s": [], "mem_after_flush": []}
    t0 = time.time()
    for i in range(steps):
        _sync(dev)
        ta = time.perf_counter()
        model, opt = ws.stage_in(model, opt)
        _sync(dev)
        tb = time.perf_counter()
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(i).items()}
        model, opt, m = step(model, opt, b)
        _sync(dev)
        tc = time.perf_counter()
        ws.flush_out(model, opt)
        td = time.perf_counter()
        out["stage_in_s"].append(tb - ta)
        out["step_s"].append(tc - tb)
        out["flush_out_s"].append(td - tc)
        if dev.type == "cuda":
            out["mem_after_flush"].append(torch.cuda.memory_allocated(dev))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:4d} loss {out['losses'][-1]:.4f} "
                f"({(time.time()-t0)/(i+1):.2f}s/step)")
    gb_in = ws.bytes_streamed_in / 2**30
    gb_out = ws.bytes_streamed_out / 2**30
    log(f"streamed {gb_in:.2f} GiB in / {gb_out:.2f} GiB out over "
        f"{steps} steps; pinned set never moved "
        f"(write-filtered fast tier)")
    out.update(streamer=ws, model=model, opt_state=opt)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--fast-frac", type=float, default=0.4,
                    help="fast-tier budget as a fraction of total state")
    ap.add_argument("--arch", default=None,
                    help="a registered config at its published widths "
                    "(default: the model derived from granite-8b's smoke "
                    "config by --d-model, --layers and --vocab)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (get_config(args.arch) if args.arch else
           tiered_config(args.d_model, args.layers, args.vocab))
    model = init_params(0, cfg, device=args.device)
    run(cfg, model, steps=args.steps, seq=args.seq, batch=args.batch,
        fast_frac=args.fast_frac)


if __name__ == "__main__":
    main()
