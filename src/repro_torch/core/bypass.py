"""SCM-aware DRAM-cache bypass policy (§III-C), as plain torch functions.

The policy collapses three access dimensions into one score:

  * spatial locality   — columns accessed per row activation amortize SCM's
                         long tRCD (Eq. 1 numerator is divided by them);
  * write intensity    — writes add the tWR gap between SCM and DRAM;
  * hotness            — per-page activation counters multiply the penalty
                         into the *DRAM-affinity* score.

Scores are discretized to ``n_levels`` between 0 and the maximum observed so
far, compared first against a discretized moving average (level-1 filter, no
DRAM traffic), then against the victim line's stored affinity level (level-2,
one metadata access), with probabilistic decay ``p_dec`` of the victim's
level when the fill is rejected.

Every float32 / float64 type sits where the reference keeps it: scores,
levels and probabilities are float32, the moving average float64.
"""

from __future__ import annotations

import torch

from .timing import DeviceTiming

_U32 = 0xFFFFFFFF


def scm_penalty_score(ncols, has_write, dram: DeviceTiming, scm: DeviceTiming):
    """Eq. 1, using the static pre-computation of §III-C1.

    Because column-access latency is identical between SCM and DRAM, the
    numerator collapses to (tRCD_scm - tRCD_dram) for read-only activations
    plus (tWR_scm - tWR_dram) when the activation includes a write.
    """
    ncols = torch.as_tensor(ncols).to(torch.float32).clamp_min(1.0)
    num = (scm.rcd - dram.rcd) + torch.as_tensor(
        has_write, device=ncols.device).to(torch.float32) * (scm.wr - dram.wr)
    return num / ncols


def discretize(score, max_seen, n_levels: int):
    """Discretize ``score`` into ``n_levels`` fixed intervals of [0, max]."""
    max_seen = torch.as_tensor(max_seen).to(torch.float32).clamp_min(1e-6)
    lvl = torch.floor(
        torch.as_tensor(score).to(torch.float32) / max_seen * n_levels
    ).to(torch.int32)
    return lvl.clamp(0, n_levels - 1)


def ema_update(avg, value, weight: float):
    """Moving average; a new value has weight ``weight`` (1% in the paper)."""
    return (1.0 - weight) * avg + weight * value


def affinity_score(penalty, act_count, use_counter: bool):
    """DRAM-affinity score = SCM-penalty x per-page activation counter.

    §IV-A disables the counter "for simplicity" (constant 1); we keep both
    modes behind ``use_counter``.
    """
    act = torch.as_tensor(act_count).to(torch.float32)
    if use_counter:
        return penalty * act.clamp_min(1.0)
    return penalty * torch.ones_like(act)


def p_dec(act_count, max_act):
    """Victim decay probability: page activations / max activations seen."""
    max_act = torch.as_tensor(max_act).to(torch.float32).clamp_min(1.0)
    return (torch.as_tensor(act_count).to(torch.float32) / max_act).clamp(
        0.0, 1.0)


def xorshift32(state):
    """Cheap stateless PRNG step for the decay dice, on int64 tensors (or
    Python ints) holding uint32 values: torch has no uint32 left shift on
    the CPU, so every shift left is masked back to 32 bits."""
    state = state & _U32
    state = state ^ ((state << 13) & _U32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & _U32)
    return state


def uniform01(state):
    """Map a uint32 PRNG state (held in int64) to [0, 1) as float32."""
    return torch.as_tensor(state).to(torch.float32) * (1.0 / 4294967296.0)
