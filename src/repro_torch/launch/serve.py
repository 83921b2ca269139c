"""Serving launcher: ``python -m repro_torch.launch.serve --arch qwen2.5-3b
--requests 8`` serves random-weight requests on the CUDA card
(``--device cpu`` runs the kernels' plain versions on the host).  Every
registered arch serves, of every family: e.g. ``--arch mamba2-1.3b``
(ssm), ``--arch zamba2-2.7b`` (hybrid), ``--arch phi3.5-moe-42b`` (moe),
``--arch whisper-tiny`` (encdec) or ``--arch pixtral-12b`` (vlm).  The
default ``--max-len`` (256, the ``ServeConfig`` default) holds the smoke
configs; the full pixtral-12b puts its 1024 image positions ahead of
every prompt, so it needs a ``--max-len`` that holds ``n_patches`` +
prompt + new tokens of every batch (the engine's slots are never
released), e.g. 4096."""

from __future__ import annotations

import argparse

import numpy as np

from ..serving import Engine, Request, ServeConfig


def requests(Request, vocab: int, n: int, max_new: int):
    """The launcher's traffic: ``n`` prompts of 4-11 tokens drawn from
    ``default_rng(0)``, as the JAX launcher draws them."""
    rng = np.random.default_rng(0)
    return [Request(rid, rng.integers(1, vocab, size=rng.integers(4, 12))
                    .astype(np.int32), max_new=max_new) for rid in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-len", type=int, default=ServeConfig.max_len)
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..models import init_params

    cfg = get_config(args.arch, smoke=args.smoke)
    model = init_params(0, cfg, device=args.device)
    eng = Engine(cfg, model, ServeConfig(max_len=args.max_len),
                 device=args.device)
    for req in requests(Request, cfg.vocab, args.requests, args.max_new):
        eng.submit(req)
    outs = eng.run()
    for rid, toks in sorted(outs.items()):
        print(f"req {rid}: {toks.tolist()}")
    print("kv stats:", eng.kv_stats)


if __name__ == "__main__":
    main()
