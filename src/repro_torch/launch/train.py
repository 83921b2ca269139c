"""Training launcher: ``python -m repro_torch.launch.train --arch
qwen2.5-3b --seq 128 --batch 8`` trains seeded random weights on the
synthetic token stream on the CUDA card; ``--device cpu --smoke`` trains a
smoke config through the kernels' plain versions on the host.  The
reference's flags, plus ``--device`` and ``--dtype`` (the model's type,
default the config's).

Under ``torchrun`` (``WORLD_SIZE`` > 1) each process joins the default
group (gloo for ``--device cpu``, NCCL for ``cuda``, rank r on
``cuda:LOCAL_RANK``) and trains on a (world / mp, mp) mesh of ``data`` x
``model`` (``--model-parallel`` mp), e.g. ``torchrun --nproc-per-node 4 -m
repro_torch.launch.train --device cpu --smoke --model-parallel 2``; rank 0
prints the final line.  In one process it trains without a mesh whatever
``--model-parallel`` says, as the reference does on one device."""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default=None)
    args = ap.parse_args(argv)

    import os

    import torch.distributed as dist

    from ..configs import ShapeSpec, get_config
    from ..data.synthetic import for_model
    from ..launch.mesh import make_mesh_for
    from ..train import TrainConfig, Trainer

    world = int(os.environ.get("WORLD_SIZE", "1"))
    device, mesh, rank = args.device, None, 0
    if world > 1:
        cpu = args.device == "cpu"
        dist.init_process_group("gloo" if cpu else "nccl")
        rank = dist.get_rank()
        if not cpu:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
            import torch
            torch.cuda.set_device(device)
        mesh = make_mesh_for(world, args.model_parallel,
                             "cpu" if cpu else "cuda")

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=args.dtype).validate()
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    data = for_model(cfg, args.seq, args.batch)
    tr = Trainer(cfg, shape, data,
                 TrainConfig(total_steps=args.steps,
                             ckpt_dir=args.ckpt_dir,
                             microbatches=args.microbatches),
                 mesh=mesh, device=device)
    try:
        out = tr.run()
    finally:
        if world > 1:
            dist.destroy_process_group()
    if rank == 0:
        print(f"final loss {out['final_loss']:.4f} after {out['steps']} "
              f"steps (stragglers={out['stragglers']}, "
              f"recoveries={out['recoveries']})")


if __name__ == "__main__":
    main()
