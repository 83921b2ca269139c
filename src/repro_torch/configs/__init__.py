"""Architecture & input-shape registry (a copy of the JAX package's
``configs``: the same ids, configurations and smoke variants).

Each ``<arch>.py`` exports ``CONFIG`` (the exact published configuration) and
``SMOKE`` (a reduced same-family variant for CPU smoke tests).  Shapes follow
the assignment: train_4k / prefill_32k / decode_32k / long_500k, where the
decode/long shapes lower ``serve_step`` (one token against a KV/state cache)
and long_500k only applies to sub-quadratic families.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from ..models.config import ModelConfig

ARCHS = [
    "grok1_314b",
    "phi35_moe_42b",
    "granite_8b",
    "qwen25_3b",
    "internlm2_20b",
    "command_r_plus_104b",
    "whisper_tiny",
    "pixtral_12b",
    "zamba2_2p7b",
    "mamba2_1p3b",
]

# public ids (--arch flag) -> module name (the assigned 10-arch pool).
ARCH_IDS = {
    "grok-1-314b": "grok1_314b",
    "phi3.5-moe-42b": "phi35_moe_42b",
    "granite-8b": "granite_8b",
    "qwen2.5-3b": "qwen25_3b",
    "internlm2-20b": "internlm2_20b",
    "command-r-plus-104b": "command_r_plus_104b",
    "whisper-tiny": "whisper_tiny",
    "pixtral-12b": "pixtral_12b",
    "zamba2-2.7b": "zamba2_2p7b",
    "mamba2-1.3b": "mamba2_1p3b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


# The paper's own §IV-B evaluation models (outside the assigned pool).
PAPER_CASES = {"gpt3-xl": "GPT3_XL", "bert-enlarged-24b": "BERT_ENLARGED"}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in PAPER_CASES:
        mod = importlib.import_module(".paper_cases", __name__)
        cfg = mod.SMOKE if smoke else getattr(mod, PAPER_CASES[arch])
        return cfg.validate()
    mod_name = ARCH_IDS.get(arch, arch).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f".{mod_name}", __name__)
    return (mod.SMOKE if smoke else mod.CONFIG).validate()


def cell_is_valid(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch x shape) is a defined dry-run cell (per assignment)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention family: long_500k requires "
                       "sub-quadratic attention (skip noted in DESIGN.md)")
    return True, ""


def all_cells(smoke: bool = False) -> List[Tuple[str, str]]:
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=smoke)
        for sname, sh in SHAPES.items():
            ok, _ = cell_is_valid(cfg, sh)
            if ok:
                cells.append((arch, sname))
    return cells
