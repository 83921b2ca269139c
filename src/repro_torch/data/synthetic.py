"""Deterministic, shardable synthetic token pipeline (the port's copy of
the JAX package's ``data/synthetic.py``: numpy only, every batch bit-equal
to the reference's for the same (seed, step, shard)).

``batch_at(step)`` is a pure function of (seed, step, shard) — the iterator
has *no* hidden state beyond the step counter, so checkpoint/restore and
elastic resharding replay the exact same stream (a restarted or re-scaled
job sees identical data; stragglers can recompute any batch).  Documents are
emulated with geometric lengths and EOS separators so the LM loss has real
structure.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512
    # modality side-channels (enc-dec / vlm stubs)
    enc_seq: int = 0
    enc_dim: int = 0
    n_patches: int = 0
    patch_dim: int = 0


class SyntheticTokens:
    """Markov-ish synthetic LM stream (counter-based, stateless)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.step = 0

    # -- pure batch generation ------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        bsz = cfg.global_batch // self.num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard]))
        shape = (bsz, cfg.seq_len + 1)
        # run-repeat structure: tokens repeat in geometric runs, so the
        # stream has real next-token signal (P(next == current) ~ 0.75)
        # that a trained LM must capture — the loss curve is meaningful.
        base = rng.integers(1, cfg.vocab, size=shape, dtype=np.int32)
        new_run = rng.random(shape) < 0.25
        new_run[:, 0] = True
        pos = np.arange(shape[1], dtype=np.int64)[None, :]
        run_start = np.maximum.accumulate(np.where(new_run, pos, 0), axis=1)
        toks = np.take_along_axis(base, run_start, axis=1).astype(np.int32)
        toks = np.maximum(toks, 1)
        # EOS-delimited documents
        doc_end = rng.random(shape) < (1.0 / max(2, cfg.mean_doc_len))
        toks = np.where(doc_end, cfg.eos_id, toks)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.enc_seq:
            out["enc_frames"] = rng.standard_normal(
                (bsz, cfg.enc_seq, cfg.enc_dim), dtype=np.float32)
        if cfg.n_patches:
            out["patches"] = rng.standard_normal(
                (bsz, cfg.n_patches, cfg.patch_dim), dtype=np.float32)
        return out

    # -- stateful iterator facade --------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "shard": self.shard,
                "num_shards": self.num_shards}

    def load_state_dict(self, st: Dict[str, int]) -> None:
        self.step = int(st["step"])


def for_model(model_cfg, seq_len: int, global_batch: int,
              seed: int = 0, shard: int = 0, num_shards: int = 1
              ) -> SyntheticTokens:
    extra = {}
    if model_cfg.family == "encdec":
        extra = dict(enc_seq=model_cfg.enc_seq,
                     enc_dim=model_cfg.frontend_dim or model_cfg.d_model)
    if model_cfg.family == "vlm":
        extra = dict(n_patches=model_cfg.n_patches,
                     patch_dim=model_cfg.vision_d_model)
        seq_len = max(1, seq_len - model_cfg.n_patches)
    return SyntheticTokens(
        DataConfig(vocab=model_cfg.vocab, seq_len=seq_len,
                   global_batch=global_batch, seed=seed, **extra),
        shard=shard, num_shards=num_shards)
