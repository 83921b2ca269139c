"""Training launcher: ``python -m repro_torch.launch.train --arch
qwen2.5-3b --seq 128 --batch 8`` trains seeded random weights on the
synthetic token stream on the CUDA card; ``--device cpu --smoke`` trains a
smoke config through the kernels' plain versions on the host.  The
reference's flags, plus ``--device`` and ``--dtype`` (the model's type,
default the config's).  ``--model-parallel`` above 1 needs ``parallel/``,
which is not ported yet."""

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
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs parallel/, which is not ported yet "
            "(ROADMAP A10)")

    from ..configs import ShapeSpec, get_config
    from ..data.synthetic import for_model
    from ..train import TrainConfig, Trainer

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=args.dtype).validate()
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    data = for_model(cfg, args.seq, args.batch)
    tr = Trainer(cfg, shape, data,
                 TrainConfig(total_steps=args.steps,
                             ckpt_dir=args.ckpt_dir,
                             microbatches=args.microbatches),
                 device=args.device)
    out = tr.run()
    print(f"final loss {out['final_loss']:.4f} after {out['steps']} steps "
          f"(stragglers={out['stragglers']}, recoveries={out['recoveries']})")


if __name__ == "__main__":
    main()
