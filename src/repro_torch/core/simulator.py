"""Trace-driven HMS / DRAM-cache simulator on PyTorch, with its sequential
scan as a CUDA kernel.

The model is the reference package's (§III of the paper): a direct-mapped
DRAM cache over SCM with AMIL or TAD tags, the Configurable Tag Cache, the
two-level SCM-aware bypass policy, prior-work policies, and the shared-bus,
separate-bus, SCM-only and infinite-HBM organizations.  Runtime is the
bottleneck model of ``_finish``; counters are float64.

Engine layout (one ``simulate`` call, or one config group of
``simulate_many``):

  * ``traces.preprocess`` and ``traces.shard_plan`` (NumPy, host) decompose
    addresses, segment the MSHR activation runs and partition the trace into
    S state-disjoint shards; ``tsplit.split_positions`` cuts each shard into
    T temporal segments.  (S, T) comes from ``costmodel.plan_hms_split``
    (or :func:`set_forced_shards` / ``costmodel.set_forced_tsplit``).
  * The per-request-pure precompute runs in torch on the device, once per
    config: SCM penalty scores, running maxima, discretized levels, the
    xorshift dice and fill candidacy.  The float64 penalty EMA is a
    sequential recurrence; it runs as the ``ema_scan`` kernel.
  * The stateful core — packed DRAM-cache words and CTC rows — is the
    ``hms_scan`` kernel.  Its lanes are configs x shards x segments, each
    lane with its own CTC ways and sets; one warp per (lane, CTC set) walks
    that set's requests in order (without a CTC, per row-group residue) and
    emits one int32 decision word per request.  With T > 1 the segments
    start from boundary guesses and the stitch (``tsplit.stitch``) relaunches
    the kernel with each guess replaced by its predecessor's output until
    nothing changes: one launch and one host sync a round, on device
    tensors.  The whole run is guarded by the degradation ladder
    (``repro_torch.resilience.guard``): (S, T) -> (S, 1) -> (1, 1), an OOM
    bisecting a batch; no rung leaves the card.
  * The converged round's decision words are scattered back to trace order
    and every counter is reduced vectorially on the device, once per config
    (segment sums per phase for scenario traces); ``_finish`` turns the
    counters into runtime, traffic and energy on the host in NumPy float64,
    so the totals of a phased trace are ``np.sum`` of its per-phase vector.

The ``hbm`` organization and any HMS footprint that overflows the HMS
capacity add the Unified-Memory paging model (``repro_torch.um``), whose
scan is the ``um_scan`` kernel: one warp per UM spec x temporal segment.
:func:`simulate_many` runs every UM point of a batch in one ``um_scan``
call first.

On the CPU (``device="cpu"``) the kernels' plain PyTorch versions run
instead.

Every guarded scan call is accounted with ``repro_torch.obs``: the
sentinel counts it under its fingerprint (:func:`_fingerprint`, the
reference's format), and with collection on it emits one schema-4
``RunRecord`` (single-tier organizations one each too) inside the
reference's spans (``shard_plan``, ``preprocess``, ``scan``, ``stitch``,
``single_tier``, ``postprocess``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
import types
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import _build, obs
from .._device import resolve_device
from ..resilience import guard as _guard
from ..resilience import sweepckpt as _sweepckpt
from ..resilience import validate as _rvalidate
from ..um import engine as _um
from . import bypass as bp
from . import costmodel
from . import ctc as ctc_mod
from . import tsplit
from .timing import COLUMN_BYTES, POLICIES_WITH_CTC, UM_PAGE_BYTES, HMSConfig
from .traces import Trace, chain_depth, preprocess, shard_plan

_COUNTERS = (
    # bus traffic, in 32B columns
    "demand_dram_rd", "demand_dram_wr", "demand_scm_rd", "demand_scm_wr",
    "probe_cols", "meta_wr_cols",
    "fill_scm_rd", "fill_dram_wr", "wb_dram_rd", "wb_scm_wr",
    # bank busy cycles (pre bank-parallelism division)
    "dram_busy", "scm_busy",
    # fractional activation-event counts (for energy)
    "dram_acts", "scm_acts", "scm_wr_acts",
    # policy events
    "hit_r", "hit_w", "miss_r", "miss_w",
    "bypass_l1", "bypass_l2", "fills", "dirty_evicts", "aff_decs",
    "ctc_hit", "ctc_miss",
)

_RNG_SEED = 0x9E3779B9


@dataclasses.dataclass
class SimResult:
    name: str
    config: HMSConfig
    runtime_cycles: float
    terms: Dict[str, float]           # bottleneck terms, cycles
    counters: Dict[str, float]
    traffic_bytes: Dict[str, float]   # per-category bus traffic
    hit_rate_read: float
    hit_rate_write: float
    ctc_hit_rate: float
    bypass_l1_frac: float             # fraction of bypasses decided at level 1
    energy_pj: Dict[str, float]
    power_w: float
    # Phase attribution (scenario traces): counters[k] ==
    # float(np.sum(phase_counters[k])) bit-for-bit, because the totals are
    # *computed* as that sum.  Empty/None for unphased traces.
    phase_names: tuple = ()
    phase_counters: Dict[str, np.ndarray] | None = None

    @property
    def total_traffic(self) -> float:
        return float(sum(self.traffic_bytes.values()))

    def phase_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase derived metrics: request count, hit rates, bypass rate,
        CTC hit rate, and DRAM/SCM bus traffic in bytes."""
        if not self.phase_counters:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        for i, name in enumerate(self.phase_names):
            c = {k: float(v[i]) for k, v in self.phase_counters.items()}
            dram_cols, scm_cols = _bus_cols(c)
            tot_r = c["hit_r"] + c["miss_r"]
            tot_w = c["hit_w"] + c["miss_w"]
            tot_ctc = c["ctc_hit"] + c["ctc_miss"]
            misses = c["miss_r"] + c["miss_w"]
            # single-tier organizations track no hit/miss events; every
            # request is exactly one demand access there
            requests = tot_r + tot_w
            if requests == 0.0:
                requests = (c["demand_dram_rd"] + c["demand_dram_wr"]
                            + c["demand_scm_rd"] + c["demand_scm_wr"])
            out[name] = {
                "requests": requests,
                "hit_rate_read": c["hit_r"] / tot_r if tot_r else 0.0,
                "hit_rate_write": c["hit_w"] / tot_w if tot_w else 0.0,
                "bypass_rate": (c["bypass_l1"] + c["bypass_l2"]) / misses
                if misses else 0.0,
                "ctc_hit_rate": c["ctc_hit"] / tot_ctc if tot_ctc else 1.0,
                "fills": c["fills"],
                "dram_bytes": dram_cols * COLUMN_BYTES,
                "scm_bytes": scm_cols * COLUMN_BYTES,
                "scm_write_cols": c["demand_scm_wr"] + c["wb_scm_wr"],
            }
            if "um_faults" in c:
                # UM paging attribution (oversubscribed runs): exact, since
                # the whole-trace totals are these sums
                out[name].update({
                    "um_faults": c["um_faults"],
                    "um_migrated_pages": c["um_migrated"],
                    "um_writeback_pages": c["um_writebacks"],
                    "um_remote_cols": c["um_remote_cols"],
                    "um_link_bytes": (c["um_migrated"] + c["um_writebacks"])
                    * UM_PAGE_BYTES + c["um_remote_cols"] * COLUMN_BYTES,
                })
        return out


# ---------------------------------------------------------------------------
# Engine shapes: the (S, T) plan and the bucketed allocations.
# ---------------------------------------------------------------------------

def set_max_shards(cap: int) -> int:
    """Set the shard-count cap (1 = sequential engine); returns the old
    cap.  Delegates to :func:`repro_torch.core.costmodel.set_max_shards`."""
    return costmodel.set_max_shards(cap)


def set_forced_shards(n: int | None) -> int | None:
    """Pin the shard count S (bypassing the cost model); ``None`` restores
    automatic selection.  Counters are identical at every S.  Returns the
    previous value.  Delegates to
    :func:`repro_torch.core.costmodel.set_forced_shards`."""
    if n is not None and int(n) < 1:
        raise ValueError(f"shard count must be >= 1, got {n}")
    return costmodel.set_forced_shards(n)


def _bucket(n: int) -> int:
    """Next power of two — state arrays are allocated at bucketed sizes
    (indices never reach the slack, so counters are unaffected)."""
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class _EngineKey:
    policy: str
    n: int                  # trace length
    shards: int             # spatial shards S (1 = sequential scan)
    depth: int              # padded per-shard scan length
    lines_alloc: int        # per-lane DRAM-cache slot allocation (bucketed)
    ctc_sets_alloc: int     # per-lane CTC set allocation (bucketed)
    ctc_ways_alloc: int
    ctc_sectors: int
    phases: int = 1         # counter segments (scenario phase count)
    t_segments: int = 1     # temporal segments T (1 = no splitting)
    replay: int = 0         # replay-prefix steps per segment (T > 1 only)


def _engine_key(trace: Trace, cfg: HMSConfig) -> _EngineKey:
    return group_engine_key(trace, [cfg])


# The planner's decision behind each engine key (prediction + rejected
# alternatives), for the drift sentinel and the ledger's plan telemetry.
_PLAN_BY_KEY: Dict[_EngineKey, costmodel.SplitPlan] = {}


def group_engine_key(trace: Trace,
                     configs: Sequence[HMSConfig]) -> _EngineKey:
    """The engine key ``simulate_many`` uses for a batch of scan configs of
    one (policy, sectors) group: (S, T) from the cost model for the batch,
    allocations the group's bucketed maxima, so it can differ from any
    single config's ``_engine_key``."""
    cfgs = [c.validate() for c in configs]
    policies = {c.policy for c in cfgs}
    sectors = {c.ctc_sectors_per_line for c in cfgs}
    if len(policies) != 1 or len(sectors) != 1:
        raise ValueError("group_engine_key wants configs from one "
                         "static-structure group (one policy, one sector "
                         "count)")
    replay = tsplit.replay_prefix()
    with obs.span("shard_plan", policy=cfgs[0].policy, configs=len(cfgs)):
        split = costmodel.plan_hms_split(plan_depth(trace, cfgs),
                                         len(cfgs), replay)
        key = _shape_key(trace, cfgs, split.shards, split.t_segments,
                         replay)
    _PLAN_BY_KEY[key] = split
    return key


def plan_depth(trace: Trace, configs: Sequence[HMSConfig]):
    """``depth_of(S)`` for the planner: the longest chain the scan kernel
    walks at S shards (:func:`~repro_torch.core.traces.chain_depth`), the
    group's maximum.  The reference costs the padded shard depth, the
    length of its per-shard scan; the port's kernel walks each (lane, CTC
    set) chain on its own, so under a CTC policy its depth does not fall
    with S."""
    return lambda s: max(chain_depth(trace, c, s) for c in configs)


def _shape_key(trace: Trace, cfgs: Sequence[HMSConfig], shards: int,
               t_segments: int = 1, replay: int = 0) -> _EngineKey:
    """The engine key of one config group at a given (S, T): allocations
    are the group's bucketed maxima; a T above the shard depth is cut to
    it (segments need >= 1 core step)."""
    plans = [shard_plan(trace, c, shards) for c in cfgs]
    depth = max(p["depth"] for p in plans)
    t_seg = max(1, min(t_segments, depth))
    policy = cfgs[0].policy
    use_ctc = policy in POLICIES_WITH_CTC
    return _EngineKey(
        policy=policy, n=trace.n, shards=shards, depth=depth,
        lines_alloc=_bucket(max(p["lines_bound"] for p in plans)),
        # non-CTC policies carry no CTC state; allocate the minimum
        ctc_sets_alloc=_bucket(max(p["n_sets_local"] for p in plans))
        if use_ctc else 1,
        ctc_ways_alloc=_bucket(max(c.ctc_ways for c in cfgs))
        if use_ctc else 1,
        ctc_sectors=cfgs[0].ctc_sectors_per_line, phases=trace.n_phases,
        t_segments=t_seg, replay=replay if t_seg > 1 else 0)


def _runtime_params(cfg: HMSConfig,
                    n_sets_local: int = -1) -> Dict[str, np.ndarray]:
    """The engine's runtime scalars, in the reference's types: timings are
    exact small integers carried as float32, the EMA weight float64.
    ``n_sets_local`` is the *shard-local* CTC set count from the plan."""
    dram, scm = cfg.dram_timing, cfg.scm_timing
    amil = cfg.tag_layout == "amil"
    return {
        "dram_rcd": np.float32(dram.rcd), "dram_wr": np.float32(dram.wr),
        "dram_rp": np.float32(dram.rp),
        "scm_rcd": np.float32(scm.rcd), "scm_wr": np.float32(scm.wr),
        "scm_rp": np.float32(scm.rp),
        "ema_weight": np.float64(cfg.ema_weight),
        "n_levels": np.int32(cfg.n_levels),
        "use_act_counter": np.bool_(cfg.use_activation_counter),
        "bear_fill_prob": np.float32(cfg.bear_fill_prob),
        "redcache_threshold": np.int32(cfg.redcache_threshold),
        "ctc_ways": np.int32(cfg.ctc_ways),
        "ctc_sets": np.int32(cfg.ctc_sets if n_sets_local < 0
                             else n_sets_local),
        "probe_cost": np.float32(1.0 if amil else float(cfg.lines_per_row)),
        "meta_wr_cost": np.float32(1.0 if amil else 0.0),
        "cpl": np.float32(cfg.columns_per_line),
    }


# ---------------------------------------------------------------------------
# Dice stream: one xorshift32 step per request from a fixed seed, so the
# stream depends on trace position only.  Generated in int64 with 32-bit
# masks (torch has no uint32 left shift on the CPU); chains are cached per
# power-of-two length, like the reference's.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dice_chain(m: int) -> np.ndarray:
    s = _RNG_SEED
    out = [0] * m
    for i in range(m):
        s = out[i] = bp.xorshift32(s)
    return np.asarray(out, dtype=np.int64)


def _dice(n: int, device) -> torch.Tensor:
    chain = torch.from_numpy(_dice_chain(_bucket(max(1, n)))[:n])
    return bp.uniform01(chain.to(device))


# ---------------------------------------------------------------------------
# The HMS engine: device precompute + scan kernel + counter reduction.
# ---------------------------------------------------------------------------

def _engine_inputs(trace: Trace, cfg: HMSConfig, pre, key: _EngineKey,
                   dev: torch.device) -> Dict[str, torch.Tensor]:
    # packed-word layout limits, raised before anything reaches the device
    _rvalidate.check_hms_packing(
        trace.name, tag_max=int(pre["tag"].max(initial=0)),
        n_levels=cfg.n_levels)
    plan = shard_plan(trace, cfg, key.shards)
    _rvalidate.check_hms_packing(
        trace.name, rg_max=int(plan["rg_local"].max(initial=0)))
    pos = plan["pos"]
    if plan["depth"] < key.depth:       # pad to the engine's (group) depth
        pad = np.full((key.shards, key.depth - plan["depth"]), trace.n,
                      np.int32)
        pos = np.concatenate([pos, pad], axis=1)
    if key.t_segments > 1:
        # cut each shard row into T temporal segments: the lanes become
        # S*T, scatter positions keep replay/pad steps on the dropped
        # sentinel, gather positions re-execute the replay window
        lanes = key.shards * key.t_segments
        sp = tsplit.split_positions(pos, trace.n, key.t_segments, key.replay)
        spos = sp["spos"].reshape(lanes, -1)
        gpos = sp["gpos"].reshape(lanes, -1)
        replay = sp["replay"].reshape(lanes, -1) if key.replay > 0 else None
    else:
        spos, gpos, replay = pos, np.minimum(pos, trace.n - 1), None

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    xs = {
        "slot": to(plan["slot_local"]),
        "tag": to(pre["tag"]),
        "is_write": to(pre["is_write"]),
        "row_group": to(plan["rg_local"]),
        "sector": to(pre["sector"]),
        "run_ncols": to(pre["run_ncols"]),
        "run_haswrite": to(pre["run_haswrite"]),
        "page_act": to(pre["page_act"]),
        "max_act": to(pre["max_act"]),
        # tag layout folds into per-request data + cost scalars
        "excluded": to(pre["amil_excluded"] & (cfg.tag_layout == "amil")),
        "dice": _dice(trace.n, dev),
        # (lanes, L) scatter positions (pad and replay steps == n) and
        # gather positions
        "pos": to(spos.astype(np.int64)),
        "gpos": to(gpos.astype(np.int64)),
    }
    if replay is not None:
        xs["replay"] = to(replay)
    if trace.n_phases > 1:
        xs["phase"] = to(trace.phase_id.astype(np.int64))
    return xs


def _scan_streams(key: _EngineKey, xs, p, dev):
    """The precompute: per-request-pure work, then the two packed input
    streams of the scan kernel in (lanes, L) layout, gathered at
    ``xs["gpos"]`` with the live bit on real core steps.  Returns ``(slot,
    meta, derived)``, ``derived`` holding what the counter reduction reads
    again (and, with a replay prefix, ``meta_warm``: the stitch's warm-up
    stream, replay steps live too)."""
    from ..kernels.hms_scan import ops as scan_ops   # kernels import core

    policy = key.policy

    def f32(name):
        return torch.tensor(float(p[name]), dtype=torch.float32, device=dev)

    dram = types.SimpleNamespace(rcd=f32("dram_rcd"), wr=f32("dram_wr"),
                                 rp=f32("dram_rp"))
    scm = types.SimpleNamespace(rcd=f32("scm_rcd"), wr=f32("scm_wr"),
                                rp=f32("scm_rp"))
    ncols = xs["run_ncols"]
    is_write = xs["is_write"]
    page_act = xs["page_act"]
    dice = xs["dice"]
    excluded = xs["excluded"]
    n_levels = int(p["n_levels"])

    pen = bp.scm_penalty_score(ncols, xs["run_haswrite"], dram, scm)
    pen64 = pen.to(torch.float64)
    pen_max = torch.cummax(pen64, 0).values
    pen_ema = scan_ops.ema_scan(pen64, float(p["ema_weight"]))
    req_lvl = bp.discretize(pen, pen_max, n_levels)
    avg_lvl = bp.discretize(pen_ema, pen_max, n_levels)
    aff = bp.affinity_score(pen, page_act, bool(p["use_act_counter"]))
    aff_max = torch.cummax(aff.to(torch.float64), 0).values
    req_aff_lvl = bp.discretize(aff, aff_max, n_levels)
    pass1 = req_lvl > avg_lvl
    dec_ok = dice < bp.p_dec(page_act, xs["max_act"])

    # fill candidacy before the (stateful) accept decision
    if policy in ("hms", "no_second_level"):
        cand = ~excluded & pass1
    elif policy in ("no_bypass", "no_bypass_no_ctc", "always_cache"):
        cand = ~excluded
    elif policy == "bear":
        cand = dice < f32("bear_fill_prob")
    elif policy == "redcache":
        cand = page_act >= int(p["redcache_threshold"])
    elif policy == "mccache":
        cand = ~is_write
    else:
        raise _rvalidate.unknown_policy_error(policy)

    # one int64 word per request: bits 0 is_write | 1 dec_ok | 2 cand |
    # 3..7 sector | 8..15 req_aff_lvl | 16 live (pad and replay gate, set
    # after the lane gather) | 17..39 row group | 40..61 tag
    i64 = torch.int64
    meta_tr = (is_write.to(i64)
               | (dec_ok.to(i64) << 1)
               | (cand.to(i64) << 2)
               | (xs["sector"].to(i64) << 3)
               | (req_aff_lvl.to(i64) << 8)
               | (xs["row_group"].to(i64) << 17)
               | (xs["tag"].to(i64) << 40))
    gpos = xs["gpos"]                           # (lanes, L) gathers
    slot = xs["slot"][gpos]
    meta = meta_tr[gpos]
    live = xs["pos"] < key.n                    # real core steps
    derived = dict(dram=dram, scm=scm, pass1=pass1, pen64=pen64)
    if "replay" in xs:
        # the stitch's warm-up round also runs the replay prefixes live
        derived["meta_warm"] = meta | ((live | xs["replay"]).to(i64) << 16)
    meta = meta | (live.to(i64) << 16)
    return slot, meta, derived


def phase_sums(V, phase, n_phases: int):
    """(..., n) float64 -> (..., n_phases): the sum of each phase's terms,
    one masked ``sum`` per phase.  Its order of addition is fixed by the
    shapes alone, so the bits repeat from run to run on the card (where
    ``index_add_`` adds with atomics, in an order that changes)."""
    zero = V.new_zeros(())
    return torch.stack([torch.where(phase == k, V, zero).sum(dim=-1)
                        for k in range(n_phases)], dim=-1)


def _reduce_counters(key: _EngineKey, xs, p, y_tr, derived,
                     dev) -> Dict[str, np.ndarray]:
    """The vectorized counter reduction over trace-order decision words.

    Each ``add`` is one term, summed on its own (segment-summed per phase
    for scenario traces) and then accumulated per counter in the order the
    reference adds them.  Returns float64 scalars, or ``(phases,)`` vectors
    for phased traces."""
    policy = key.policy
    use_ctc = policy in POLICIES_WITH_CTC
    ideal_probe = policy in ("bear", "redcache", "mccache")
    two_level = policy in ("hms", "no_second_level")
    dram, scm = derived["dram"], derived["scm"]
    ncols = xs["run_ncols"]
    is_write = xs["is_write"]
    excluded = xs["excluded"]

    hit = (y_tr & 1) != 0
    c_hit = (y_tr & 2) != 0
    do_fill = (y_tr & 4) != 0
    rejected = (y_tr & 8) != 0
    dec = (y_tr & 16) != 0
    wb = (y_tr & 32) != 0
    nar = (y_tr & 64) != 0
    miss = ~hit

    def f32(name):
        return torch.tensor(float(p[name]), dtype=torch.float32, device=dev)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    terms: List[Tuple[str, torch.Tensor]] = []

    def add(name, v):
        terms.append((name, v.to(torch.float64)))

    probe_cost = f32("probe_cost")
    if use_ctc:
        add("ctc_hit", c_hit)
        add("ctc_miss", ~c_hit)
        add("probe_cols", torch.where(c_hit, zero, probe_cost))
        add("dram_busy",
            torch.where(c_hit, zero, dram.rcd + probe_cost + dram.rp))
        add("dram_acts", torch.where(c_hit, zero, one))
    elif not ideal_probe:
        add("ctc_miss", torch.ones_like(hit))
        add("probe_cols", probe_cost.expand(hit.shape))
        add("dram_busy", (dram.rcd + probe_cost + dram.rp).expand(hit.shape))
        add("dram_acts", torch.ones_like(hit))

    if two_level:
        add("bypass_l1", miss & ~excluded & ~derived["pass1"])
        add("bypass_l2", rejected)
        add("aff_decs", dec)
        if policy == "hms":
            add("probe_cols", nar)
            add("dram_busy", torch.where(nar, dram.rcd + 1.0 + dram.rp, zero))
            add("dram_acts", nar)

    rd = ~is_write
    add("hit_r", hit & rd)
    add("hit_w", hit & is_write)
    add("miss_r", miss & rd)
    add("miss_w", miss & is_write)
    add("demand_dram_rd", hit & rd)
    add("demand_dram_wr", hit & is_write)
    dram_share = (dram.rcd + dram.rp) / ncols + torch.where(
        is_write, dram.wr / ncols, zero)
    scm_share = (scm.rcd + scm.rp) / ncols + torch.where(
        is_write, scm.wr / ncols, zero)
    add("dram_busy", torch.where(hit, 1.0 + dram_share, zero))
    add("dram_acts", torch.where(hit, 1.0 / ncols, zero))
    if policy == "mccache":
        wt = hit & is_write
        add("demand_scm_wr", wt)
        add("scm_busy", torch.where(wt, 1.0 + scm_share, zero))
        add("scm_acts", torch.where(wt, 1.0 / ncols, zero))
        add("scm_wr_acts", torch.where(wt, 1.0 / ncols, zero))

    dem_scm_rd = miss & rd & ~do_fill
    dem_scm_wr = miss & is_write & ~do_fill
    add("demand_scm_rd", dem_scm_rd)
    add("demand_scm_wr", dem_scm_wr)
    add("scm_busy", torch.where(dem_scm_rd | dem_scm_wr, 1.0 + scm_share,
                                zero))
    add("scm_acts", torch.where(dem_scm_rd | dem_scm_wr, 1.0 / ncols, zero))
    add("scm_wr_acts", torch.where(dem_scm_wr, 1.0 / ncols, zero))

    cpl = f32("cpl")
    meta_wr_cost = f32("meta_wr_cost")
    add("fills", do_fill)
    add("fill_scm_rd", torch.where(do_fill, cpl, zero))
    add("fill_dram_wr", torch.where(do_fill, cpl, zero))
    add("meta_wr_cols", torch.where(do_fill, meta_wr_cost, zero))
    add("scm_busy", torch.where(do_fill, scm.rcd + cpl + scm.rp, zero))
    add("dram_busy",
        torch.where(do_fill, dram.rcd + cpl + dram.wr + dram.rp
                    + meta_wr_cost, zero))
    add("scm_acts", do_fill)
    add("dram_acts", do_fill)

    add("dirty_evicts", wb)
    add("wb_dram_rd", torch.where(wb, cpl, zero))
    add("wb_scm_wr", torch.where(wb, cpl, zero))
    add("dram_busy", torch.where(wb, dram.rcd + cpl + dram.rp, zero))
    add("scm_busy", torch.where(wb, scm.rcd + cpl + scm.wr + scm.rp, zero))
    add("dram_acts", wb)
    add("scm_acts", wb)
    add("scm_wr_acts", wb)

    V = torch.stack([v for _, v in terms])       # (terms, n) float64
    if key.phases > 1:
        sums = phase_sums(V, xs["phase"], key.phases)
        C = {k: np.zeros(key.phases, np.float64) for k in _COUNTERS}
    else:
        sums = V.sum(dim=1)
        C = {k: np.float64(0.0) for k in _COUNTERS}
    for (name, _), s in zip(terms, sums.cpu().numpy()):
        C[name] = C[name] + s
    return C


def scan_inputs(trace: Trace, cfg: HMSConfig, dev,
                key: _EngineKey | None = None) -> Dict[str, object]:
    """Everything the HMS engine launches its scan kernel with, for one
    validated (trace, cfg) on device ``dev``: the engine ``key`` (by
    default the planned one at T = 1), the device inputs ``xs``, the
    runtime ``params``, the packed ``slot`` / ``meta`` streams in (lanes,
    L) layout, the ``derived`` precompute the reduction reads again, and
    the kernel's keyword arguments ``scan``.  ``key`` defaults to one
    unsplit scan at the pinned shard count (1 unless
    :func:`set_forced_shards` pins one)."""
    if key is None:
        key = _shape_key(trace, [cfg], costmodel._FORCED_SHARDS or 1)
    use_ctc = key.policy in POLICIES_WITH_CTC
    xs = _engine_inputs(trace, cfg, preprocess(trace, cfg), key, dev)
    n_sets = _local_sets(trace, cfg, key)
    p = _runtime_params(cfg, n_sets)
    slot, meta, derived = _scan_streams(key, xs, p, dev)
    scan = dict(policy=key.policy,
                e_ways=int(p["ctc_ways"]) if use_ctc else 1,
                n_sets=n_sets, lines_alloc=key.lines_alloc,
                sets_alloc=key.ctc_sets_alloc,
                ways_alloc=key.ctc_ways_alloc, sectors=key.ctc_sectors,
                spg=cfg.lines_per_row * cfg.ctc_sectors_per_line)
    return dict(key=key, xs=xs, params=p, slot=slot, meta=meta,
                derived=derived, scan=scan)


def _local_sets(trace: Trace, cfg: HMSConfig, key: _EngineKey) -> int:
    if cfg.policy not in POLICIES_WITH_CTC:
        return 1
    return shard_plan(trace, cfg, key.shards)["n_sets_local"]


def _stitch_masks(key: _EngineKey, s, dev):
    """Touched masks of the fixed-point stitch for one config's lanes:
    which cache slots (bool[S, T, lines_alloc]) and CTC set rows
    (bool[S, T, sets_alloc]) each (shard, segment)'s *real core* steps
    access.  Every scan step reads and writes exactly its own slot and
    CTC row (dead steps write the old value back), so a segment's output
    restricted to its touched mask is a pure function of its input
    restricted to that mask — which makes masked composition in
    :func:`_run_split` equal to sequential chaining at the fixed point.
    Replay-prefix steps scatter to the sentinel, so they are excluded:
    their perturbations never leak into composed boundaries."""
    S, T = key.shards, key.t_segments
    lanes = S * T
    real = s["xs"]["pos"] < key.n
    lane = torch.arange(lanes, device=dev)[:, None]
    slot_m = torch.zeros(lanes * key.lines_alloc, dtype=torch.bool,
                         device=dev)
    slot_m[(lane * key.lines_alloc + s["slot"])[real]] = True
    set_m = torch.zeros(lanes * key.ctc_sets_alloc, dtype=torch.bool,
                        device=dev)
    if key.policy in POLICIES_WITH_CTC:
        rows = ((s["meta"] >> 17) & 0x7FFFFF) % s["scan"]["n_sets"]
        set_m[(lane * key.ctc_sets_alloc + rows)[real]] = True
    return (slot_m.view(S, T, key.lines_alloc),
            set_m.view(S, T, key.ctc_sets_alloc))


def _run_split(key: _EngineKey, width: int, launch, meta, meta_warm,
               masks, dev):
    """Drive a T > 1 scan to its exact fixed point (see
    ``repro_torch.core.tsplit``): one ``hms_scan`` launch a round over
    every lane of the batch (``launch(cache, ctc, meta)``), the
    composition and the equality test on device tensors, one host sync a
    round.  ``masks`` are the batch's touched masks with a leading batch
    axis.  Returns ``(y, rounds)`` — the decision words of the converged
    round only, so they are bit for bit the sequential scan's."""
    slot_m, set_m = masks
    S, T = key.shards, key.t_segments
    lanes = width * S * T
    ctc_row = ctc_mod.packed_init(key.ctc_sets_alloc, key.ctc_ways_alloc,
                                  key.ctc_sectors, dev)
    cache0 = torch.zeros((lanes, key.lines_alloc), dtype=torch.int32,
                         device=dev)
    ctc0 = ctc_row.expand(lanes, -1, -1).contiguous()
    seg_c = (width, S, T, key.lines_alloc)
    seg_t = (width, S, T) + tuple(ctc_row.shape)

    def run(g, m):
        y, cache_f, ctc_f = launch(g[0], g[1], m)
        return (cache_f, ctc_f), y

    def advance(g, out):
        # a slot's value at boundary t is the last earlier segment's output
        # where touched, else the cold value — sequential semantics once
        # outputs are exact on their touched masks
        cache_o = out[0].view(seg_c)
        ctc_o = out[1].view(seg_t)
        new_c = torch.empty_like(cache_o)
        new_t = torch.empty_like(ctc_o)
        new_c[:, :, 0] = 0
        new_t[:, :, 0] = ctc_row
        for t in range(1, T):
            new_c[:, :, t] = torch.where(slot_m[:, :, t - 1],
                                         cache_o[:, :, t - 1],
                                         new_c[:, :, t - 1])
            new_t[:, :, t] = torch.where(set_m[:, :, t - 1, :, None],
                                         ctc_o[:, :, t - 1],
                                         new_t[:, :, t - 1])
        return new_c.view(cache0.shape), new_t.view(ctc0.shape)

    def equal(a, b):
        return not bool(torch.stack([(a[0] != b[0]).any(),
                                     (a[1] != b[1]).any()]).any())

    g = (cache0, ctc0)
    extra = 0
    if key.replay > 0:
        # warm-up round: replay prefixes live, for closer guesses; its
        # decisions are never used (replay perturbs segment state)
        out, _ = run(g, meta_warm)
        g = advance(g, out)
        extra = 1
    y, rounds = tsplit.stitch(lambda gg, _r: run(gg, meta), g, advance,
                              equal, max_rounds=key.t_segments + 1)
    return y, rounds + extra


def _scan_attempt(trace: Trace, cfgs: Sequence[HMSConfig], key: _EngineKey,
                  dev):
    """One rung: the batch's configs x shards x segments as the lanes of
    one ``hms_scan`` launch a stitch round; then each config's decision
    words back to trace order and its counters reduced once.  Returns
    ``(counters, rounds, key)``, one counter dict per config."""
    from ..kernels.hms_scan import ops as scan_ops   # kernels import core

    per = [scan_inputs(trace, c, dev, key) for c in cfgs]
    slot = torch.cat([s["slot"] for s in per])
    meta = torch.cat([s["meta"] for s in per])
    rep = key.shards * key.t_segments              # lanes a config
    kw = dict(per[0]["scan"])
    for name in ("e_ways", "n_sets", "spg"):
        kw[name] = [s["scan"][name] for s in per for _ in range(rep)]
    if key.t_segments == 1:
        y, _, _ = scan_ops.hms_scan(slot, meta, **kw)
        rounds = 1
    else:
        with obs.span("stitch", sync=dev, engine="hms",
                      segments=key.t_segments, replay=key.replay):
            prep = scan_ops.prepare(slot, meta, **kw)
            warm = (torch.cat([s["derived"]["meta_warm"] for s in per])
                    if key.replay > 0 else None)
            pairs = [_stitch_masks(key, s, dev) for s in per]
            masks = (torch.stack([a for a, _ in pairs]),
                     torch.stack([b for _, b in pairs]))
            y, rounds = _run_split(
                key, len(cfgs),
                lambda cache, ctc, m: scan_ops.hms_scan(
                    slot, m, **kw, cache=cache, ctc=ctc, prepared=prep),
                meta, warm, masks, dev)
    out = []
    for j, s in enumerate(per):
        # scatter the decision words back to trace order; padding and
        # replay sentinels land in the dropped overflow slot n
        y_tr = torch.zeros(key.n + 1, dtype=torch.int32, device=dev)
        y_tr[s["xs"]["pos"].reshape(-1)] = y[j * rep:(j + 1) * rep].reshape(-1)
        out.append(_reduce_counters(key, s["xs"], s["params"], y_tr[: key.n],
                                    s["derived"], dev))
    return out, rounds, key


def _hms_ladder_keys(trace: Trace, cfgs: Sequence[HMSConfig],
                     key: _EngineKey) -> List[_EngineKey]:
    """Engine keys for the degradation rungs (S, T) -> (S, 1) -> (1, 1);
    every one reproduces the sequential scan bit for bit.  There is no
    rung below (1, 1): the reference's last rung, its frozen seed engine,
    would run on the host here, not on the card."""
    out = []
    for s, t in costmodel.degradation_ladder(key.shards, key.t_segments):
        if (s, t) == (key.shards, key.t_segments):
            out.append(key)
        elif s == key.shards:
            out.append(dataclasses.replace(key, t_segments=1, replay=0))
        else:
            # a degraded rung is a smaller planned shape, not a special
            # engine
            out.append(_shape_key(trace, cfgs, s))
    return out


def _fingerprint(key: _EngineKey, width: int) -> str:
    """Sentinel/ledger fingerprint of one engine unit, in the reference's
    format: the static engine key plus the batch width.  The drift check,
    the sentinel and the ledger all use it."""
    return (f"hms:{key.policy}:n{key.n}:s{key.shards}x{key.depth}"
            f":T{key.t_segments}r{key.replay}"
            f":L{key.lines_alloc}:C{key.ctc_sets_alloc}x{key.ctc_ways_alloc}"
            f"x{key.ctc_sectors}:p{key.phases}:w{width}")


# What each guarded scan call did (newest last, at most _RUNS_KEPT): the
# shape that produced the counters, the stitch rounds, the ladder's rung
# and its events.  Always on; with ``repro_torch.obs`` enabled the same
# values also make the call's ledger record.
_RUNS: List[Dict[str, object]] = []
_RUNS_KEPT = 4096


def _obs_hms_record(entry: str, trace: Trace, key: _EngineKey, width: int,
                    compiled: bool, wall_s: float, rounds: int, outcome,
                    cfgs: Sequence[HMSConfig],
                    lanes: Sequence[Dict[str, np.ndarray]], plan,
                    dev: torch.device) -> None:
    """Build + emit one HMS ledger record (caller gates on obs.enabled()),
    as the reference's: ``key`` is the engine key that produced the
    counters (the ladder may have descended from the planned one),
    ``outcome`` the guard's ``LadderOutcome``, ``cfgs``/``lanes`` the
    per-lane configs and raw counter dicts (recorded in full), ``plan``
    the ``SplitPlan`` behind the *planned* shape."""
    obs.record(obs.RunRecord(
        entry=entry, engine="hms", trace=trace.name, n=trace.n,
        phases=key.phases, engine_key=_fingerprint(key, width),
        compiled=compiled, wall_s=wall_s, batch=width,
        counter_digest=obs.counter_digest(lanes), shards=key.shards,
        depth=key.depth,
        load_imbalance=key.shards * key.depth / max(1, key.n),
        t_segments=key.t_segments, stitch_rounds=rounds,
        replay_prefix=key.replay, ladder_rung=outcome.rung,
        retries=outcome.retries, degradations=outcome.events or None,
        trace_fp=_sweepckpt.trace_fingerprint(trace),
        config_digests=[_sweepckpt.config_digest(c) for c in cfgs] or None,
        counters=[_sweepckpt.encode_counters(C) for C in lanes] or None,
        plan_predicted_us=plan.predicted_us if plan is not None else None,
        plan_alternatives=list(plan.alternatives) or None
        if plan is not None else None,
        calib_fingerprint=costmodel.active_profile().fingerprint,
        host={**obs.host_metadata(), "device": dev.type},
        **obs.git_info()))


def _run_hms_ladder(trace: Trace, cfgs: Sequence[HMSConfig],
                    key: _EngineKey, dev, entry: str,
                    site: str) -> List[Dict[str, object]]:
    """Run one compatible config group under the degradation ladder: the
    planned (S, T), then (S, 1), then (1, 1); an OOM on a batch of several
    configs bisects it into guarded halves (the allocations in ``key`` are
    group maxima, so the halves reuse it).  Accounts the call with the
    sentinel, the drift check, ``_RUNS`` and (when enabled) the ledger.
    Returns one counter dict per config."""
    def attempt(k: _EngineKey):
        def thunk():
            # the whole rung is the scan span, as the reference's compiled
            # engine holds the precompute, the scan and the reduction; its
            # exit waits for the stream, so its wall covers the kernels
            with obs.span("scan", sync=dev, engine="hms", policy=k.policy,
                          shards=k.shards, batch=len(cfgs)):
                return _scan_attempt(trace, cfgs, k, dev)
        return thunk

    def bisect():
        h = len(cfgs) // 2
        return (_run_hms_batch(trace, cfgs[:h], key, dev, entry)
                + _run_hms_batch(trace, cfgs[h:], key, dev, entry)), 0, key

    rungs = [(f"S{k.shards}T{k.t_segments}", attempt(k))
             for k in _hms_ladder_keys(trace, cfgs, key)]
    epoch = _build.library_epoch()
    t0 = time.perf_counter()
    (Cs, rounds, used), outcome = _guard.run_ladder(
        site, rungs, bisect=bisect if len(cfgs) > 1 else None)
    wall = time.perf_counter() - t0
    # the library built or loaded during this call is its "compile" (a
    # bisected batch's halves account their own)
    compiled = (outcome.rung != "bisect"
                and _build.library_epoch() != epoch)
    fp = _fingerprint(used, len(cfgs))
    plan = _PLAN_BY_KEY.get(key)
    # (a bisected batch's halves are runs of their own; its own entry
    # carries the OOM event and no rounds)
    _RUNS.append({"site": site, "trace": trace.name,
                  "batch": len(cfgs), "engine_key": fp,
                  "shards": used.shards, "t_segments": used.t_segments,
                  "replay": used.replay, "rounds": rounds,
                  "rung": outcome.rung, "events": outcome.events,
                  "compiled": compiled, "wall_s": wall})
    del _RUNS[:-_RUNS_KEPT]
    if outcome.rung != "bisect":
        obs.engine_run(fp, compiled)
        if plan is not None and used == key:
            costmodel.check_plan_drift(fp, plan.predicted_us, wall,
                                       compiled)
    if obs.enabled():
        _obs_hms_record(entry, trace, used, len(cfgs), compiled, wall,
                        rounds, outcome, cfgs, Cs, plan, dev)
    return Cs


def _run_hms_batch(trace: Trace, cfgs: Sequence[HMSConfig], key: _EngineKey,
                   dev, entry: str = "simulate_many"
                   ) -> List[Dict[str, object]]:
    """One config group of ``simulate_many`` as one batch of lanes under
    the ladder (see :func:`_run_hms_ladder`), its host preprocessing in a
    ``preprocess`` span first.  Returns one counter dict per config."""
    with obs.span("preprocess", trace=trace.name, batch=len(cfgs)):
        for c in cfgs:
            preprocess(trace, c)
    return _run_hms_ladder(trace, cfgs, key, dev, entry, "hms_batch")


def _run_hms_scan(trace: Trace, cfg: HMSConfig, dev,
                  key: _EngineKey | None = None,
                  entry: str = "simulate") -> Dict[str, np.ndarray]:
    if key is None:
        key = _engine_key(trace, cfg)
    return _run_hms_ladder(trace, [cfg], key, dev, entry, "hms")[0]


# ---------------------------------------------------------------------------
# Vectorized single-tier models (InfHBM / SCM-only).
# ---------------------------------------------------------------------------

def _single_tier_counters(trace: Trace, cfg: HMSConfig, device_timing,
                          dev: torch.device):
    pre = preprocess(trace, cfg)
    ncols = torch.from_numpy(pre["run_ncols"]).to(dev)
    is_write = torch.from_numpy(pre["is_write"]).to(dev)
    t = device_timing
    share = (t.rcd + t.rp) / ncols + torch.where(
        is_write, t.wr / ncols, torch.zeros_like(ncols))
    n_ph = trace.n_phases
    if n_ph > 1:
        # per-phase attribution; totals become sums of these vectors
        phase = torch.from_numpy(trace.phase_id.astype(np.int64)).to(dev)

        def red(w):
            return phase_sums(w.to(torch.float64), phase, n_ph).cpu().numpy()
        C = {k: np.zeros(n_ph, np.float64) for k in _COUNTERS}
    else:
        def red(w):
            return float(w.to(torch.float64).sum())
        C = {k: 0.0 for k in _COUNTERS}
    is_dram = t.kind == "dram"
    C["demand_dram_rd" if is_dram else "demand_scm_rd"] = red(~is_write)
    C["demand_dram_wr" if is_dram else "demand_scm_wr"] = red(is_write)
    busy = red(1.0 + share)
    acts = red(1.0 / ncols)
    if is_dram:
        C["dram_busy"] = busy
        C["dram_acts"] = acts
    else:
        C["scm_busy"] = busy
        C["scm_acts"] = acts
        C["scm_wr_acts"] = red(is_write / ncols)
    return C


# ---------------------------------------------------------------------------
# Oversubscribed-HBM Unified-Memory baseline, through ``repro_torch.um``.
# ---------------------------------------------------------------------------

def _um_overflow_config(trace: Trace, cfg: HMSConfig) -> HMSConfig | None:
    """The UM config of an HMS footprint overflow (Fig. 17's rel-footprint
    4.0 case), or ``None`` when the HMS capacity holds the trace.

    The UM model sizes frames as footprint * r_hbm, so footprint must be
    the trace's (cfg.footprint may be pinned at a nominal size) for the
    ratio to cancel and the resident bytes to equal the HMS capacity."""
    if trace.footprint <= cfg.scm_capacity + cfg.dram_cache_capacity:
        return None
    return dataclasses.replace(
        cfg, footprint=trace.footprint,
        r_hbm=(cfg.scm_capacity + cfg.dram_cache_capacity)
        / trace.footprint)


def _um_specs(trace: Trace, configs: Sequence[HMSConfig],
              nvlink: bool) -> List[_um.UMSpec]:
    """The UM paging spec of every validated config of a batch that pages,
    in input order: an ``hbm`` config, or an HMS whose footprint
    overflows (repeats kept)."""
    specs = []
    for cfg in configs:
        if cfg.organization == "hbm":
            specs.append(_um.um_spec(cfg, nvlink))
        elif cfg.organization in ("hms", "separate"):
            big = _um_overflow_config(trace, cfg)
            if big is not None:
                specs.append(_um.um_spec(big, nvlink))
    return specs


def _um_fault_cycles(um, cfg: HMSConfig, nvlink: bool) -> float:
    """Serialized fault-handling term: hardware-coherent links fault-stall
    nothing; the PCIe path pays the (overlapped) fault latency."""
    if nvlink:
        return 0.0
    return um.faults * cfg.fault_latency_ns / cfg.fault_overlap


# ---------------------------------------------------------------------------
# Runtime model + energy (host, NumPy float64).
# ---------------------------------------------------------------------------

def _bus_cols(C: Dict[str, float]):
    dram_cols = (C["demand_dram_rd"] + C["demand_dram_wr"] + C["probe_cols"]
                 + C["meta_wr_cols"] + C["fill_dram_wr"] + C["wb_dram_rd"])
    scm_cols = (C["demand_scm_rd"] + C["demand_scm_wr"] + C["fill_scm_rd"]
                + C["wb_scm_wr"])
    return dram_cols, scm_cols


def _energy(C: Dict[str, float], cfg: HMSConfig, link_bytes: float):
    e = cfg.energy
    row_bits = 2048 * 8
    col_bits = COLUMN_BYTES * 8
    dram_rd_cols = (C["demand_dram_rd"] + C["probe_cols"] + C["wb_dram_rd"])
    dram_wr_cols = (C["demand_dram_wr"] + C["meta_wr_cols"]
                    + C["fill_dram_wr"])
    scm_rd_cols = C["demand_scm_rd"] + C["fill_scm_rd"]
    scm_wr_cols = C["demand_scm_wr"] + C["wb_scm_wr"]
    return {
        "dram_act": C["dram_acts"] * row_bits * (e.dram_act + e.dram_pre),
        "dram_rw": col_bits * (dram_rd_cols * e.dram_rd
                               + dram_wr_cols * e.dram_wr),
        "scm_act": C["scm_acts"] * row_bits * e.scm_act
        + C["scm_wr_acts"] * row_bits * e.scm_pre_wr,
        "scm_rw": col_bits * (scm_rd_cols * e.scm_rd + scm_wr_cols * e.scm_wr),
        "link": link_bytes * 8 * e.link_pj_per_bit,
    }


def _finish(name, cfg, C, link_bytes=0.0, fault_cycles=0.0,
            n_requests=1, phase_names=(), um=None) -> SimResult:
    # Split phased counters: per-phase vectors are kept verbatim and the
    # whole-trace totals are their sums (np.sum over the same float64 vector
    # is deterministic, so per-phase attribution is exact by construction).
    # UM paging counters, when the paging model ran, join the same split.
    if um is not None:
        C = {**C, **um.counter_arrays()}
    phase_counters = None
    totals: Dict[str, float] = {}
    for k, v in C.items():
        a = np.asarray(v, np.float64)
        if a.ndim:
            if phase_counters is None:
                phase_counters = {}
            phase_counters[k] = a
            totals[k] = float(np.sum(a))
        else:
            totals[k] = float(a)
    C = totals
    dram_cols, scm_cols = _bus_cols(C)
    banks = cfg.channels * cfg.banks_per_channel
    if cfg.organization == "separate":
        bus = max(dram_cols, scm_cols) / max(1, cfg.channels // 2)
        dram_bank = C["dram_busy"] / (banks // 2)
        scm_bank = C["scm_busy"] / (banks // 2)
    else:
        bus = (dram_cols + scm_cols) / cfg.channels
        dram_bank = C["dram_busy"] / banks
        scm_bank = C["scm_busy"] / banks
    link_cycles = link_bytes / cfg.link_bw_gbps  # 1 GHz: GB/s == B/cycle
    compute = n_requests * cfg.compute_cycles_per_request
    terms = {
        "bus": bus,
        "dram_bank": dram_bank,
        "scm_bank": scm_bank,
        "link": link_cycles,
        "fault": fault_cycles,
        "compute": compute,
    }
    runtime = max(bus, dram_bank, scm_bank, link_cycles, compute) + fault_cycles
    traffic = {
        "dram_demand": (C["demand_dram_rd"] + C["demand_dram_wr"])
        * COLUMN_BYTES,
        "dram_probe": (C["probe_cols"] + C["meta_wr_cols"]) * COLUMN_BYTES,
        "dram_fill": C["fill_dram_wr"] * COLUMN_BYTES,
        "dram_wb_rd": C["wb_dram_rd"] * COLUMN_BYTES,
        "scm_demand": (C["demand_scm_rd"] + C["demand_scm_wr"])
        * COLUMN_BYTES,
        "scm_fill_rd": C["fill_scm_rd"] * COLUMN_BYTES,
        "scm_wb_wr": C["wb_scm_wr"] * COLUMN_BYTES,
        "link": link_bytes,
    }
    energy = _energy(C, cfg, link_bytes)
    tot_r = C["hit_r"] + C["miss_r"]
    tot_w = C["hit_w"] + C["miss_w"]
    tot_ctc = C["ctc_hit"] + C["ctc_miss"]
    tot_byp = C["bypass_l1"] + C["bypass_l2"]
    power = sum(energy.values()) / max(runtime, 1.0) * 1e-3  # pJ/ns -> W
    return SimResult(
        name=name,
        config=cfg,
        runtime_cycles=float(runtime),
        terms={k: float(v) for k, v in terms.items()},
        counters={k: float(v) for k, v in C.items()},
        traffic_bytes={k: float(v) for k, v in traffic.items()},
        hit_rate_read=float(C["hit_r"] / tot_r) if tot_r else 0.0,
        hit_rate_write=float(C["hit_w"] / tot_w) if tot_w else 0.0,
        ctc_hit_rate=float(C["ctc_hit"] / tot_ctc) if tot_ctc else 1.0,
        bypass_l1_frac=float(C["bypass_l1"] / tot_byp) if tot_byp else 0.0,
        energy_pj={k: float(v) for k, v in energy.items()},
        power_w=float(power),
        phase_names=tuple(phase_names) if phase_counters else (),
        phase_counters=phase_counters,
    )


# ---------------------------------------------------------------------------
# Public entry points.
# ---------------------------------------------------------------------------

def _finish_hms(trace: Trace, cfg: HMSConfig, C, nvlink: bool,
                dev: torch.device) -> SimResult:
    """Tail of the hms/separate path: the UM overflow model on top of the
    cache model when the HMS cannot hold the trace, then ``_finish``.  The
    paging run is memoized per (trace, spec) in ``repro_torch.um``, so a
    batch that ``simulate_many`` prefetched never runs the scan here."""
    fault_cycles = 0.0
    link_bytes = 0.0
    um = None
    big = _um_overflow_config(trace, cfg)
    if big is not None:
        um = _um.simulate_um(trace, big, nvlink=nvlink, device=dev)
        link_bytes = um.link_bytes
        fault_cycles = _um_fault_cycles(um, cfg, nvlink)
    return _finish(trace.name, cfg, C, link_bytes=link_bytes,
                   fault_cycles=fault_cycles, n_requests=trace.n,
                   phase_names=trace.phase_names, um=um)


def simulate(trace: Trace, cfg: HMSConfig, nvlink: bool = False, *,
             device=None) -> SimResult:
    """Simulate ``trace`` on the memory system described by ``cfg``.

    ``device=None`` runs on the CUDA card and raises if there is none;
    ``device="cpu"`` runs the kernels' plain versions on the host.
    ``nvlink`` selects the host link of the UM paging model (the ``hbm``
    organization, and an HMS that cannot hold the trace): access-counter
    migration over a coherent link instead of fault-driven chunks.  The
    scan's (S, T) shape comes from the cost model; counters are identical
    at every shape."""
    dev = resolve_device(device, "simulate")
    cfg = cfg.validate()
    _rvalidate.validate_trace(trace)
    with costmodel.planning_on(dev):
        return _simulate(trace, cfg, nvlink, dev, "simulate")


def _single_tier_record(entry: str, trace: Trace, cfg: HMSConfig, C,
                        wall_s: float, dev: torch.device) -> None:
    obs.record(obs.RunRecord(
        entry=entry, engine="single_tier", trace=trace.name, n=trace.n,
        phases=trace.n_phases,
        engine_key=f"single_tier:{cfg.organization}:n{trace.n}",
        compiled=False, wall_s=wall_s, batch=1,
        counter_digest=obs.counter_digest(C),
        trace_fp=_sweepckpt.trace_fingerprint(trace),
        config_digests=[_sweepckpt.config_digest(cfg)],
        counters=[_sweepckpt.encode_counters(C)],
        calib_fingerprint=costmodel.active_profile().fingerprint,
        host={**obs.host_metadata(), "device": dev.type},
        **obs.git_info()))


def _simulate(trace: Trace, cfg: HMSConfig, nvlink: bool,
              dev: torch.device, entry: str) -> SimResult:
    org = cfg.organization
    if org in ("inf_hbm", "scm", "hbm"):
        t0 = time.perf_counter()
        timing = cfg.scm_timing if org == "scm" else cfg.dram_timing
        with obs.span("single_tier", sync=dev, organization=org,
                      trace=trace.name):
            C = _single_tier_counters(trace, cfg, timing, dev)
        if org == "hbm":
            # oversubscribed HBM + UM paging over the host link (the paging
            # engine emits its own "um" ledger record)
            um = _um.simulate_um(trace, cfg, nvlink=nvlink, device=dev)
            if obs.enabled():
                _single_tier_record(entry, trace, cfg, C,
                                    time.perf_counter() - t0, dev)
            return _finish(trace.name, cfg, C, link_bytes=um.link_bytes,
                           fault_cycles=_um_fault_cycles(um, cfg, nvlink),
                           n_requests=trace.n,
                           phase_names=trace.phase_names, um=um)
        if obs.enabled():
            _single_tier_record(entry, trace, cfg, C,
                                time.perf_counter() - t0, dev)
        return _finish(trace.name, cfg, C, n_requests=trace.n,
                       phase_names=trace.phase_names)
    # hms / separate
    with obs.span("preprocess", trace=trace.name):
        preprocess(trace, cfg)
    C = _run_hms_scan(trace, cfg, dev, entry=entry)
    with obs.span("postprocess", trace=trace.name):
        return _finish_hms(trace, cfg, C, nvlink, dev)


def simulate_many(trace: Trace, configs: Sequence[HMSConfig],
                  nvlink: bool = False, *, device=None) -> List[SimResult]:
    """Simulate one trace under many configs, batching compatible configs;
    results in input order, equal to :func:`simulate` config by config.

    Every UM paging point of the batch (``hbm`` configs and HMS footprint
    overflows) runs first, in ONE ``simulate_um_many`` call, deduped by
    spec.  The HMS configs are grouped by (policy, CTC sectors): each
    group's configs x shards x temporal segments are the lanes of one
    ``hms_scan`` launch a stitch round, under the degradation ladder (an
    OOM bisects the group).  With a sweep checkpoint active
    (``repro_torch.resilience.sweepckpt``), journaled configs replay from
    disk and each finished config is journaled."""
    dev = resolve_device(device, "simulate_many")
    configs = [c.validate() for c in configs]
    _rvalidate.validate_trace(trace)
    with costmodel.planning_on(dev):
        return _simulate_many(trace, configs, nvlink, dev)


def _simulate_many(trace: Trace, configs: List[HMSConfig], nvlink: bool,
                   dev: torch.device) -> List[SimResult]:
    results: List[SimResult | None] = [None] * len(configs)
    ck = _sweepckpt.active()
    tfp = _sweepckpt.trace_fingerprint(trace) if ck is not None else None
    um_specs = _um_specs(trace, configs, nvlink)
    if um_specs:
        _um.simulate_um_many(trace, um_specs, device=dev)

    groups: Dict[tuple, List[int]] = {}
    for i, cfg in enumerate(configs):
        if cfg.organization in ("hms", "separate"):
            groups.setdefault(
                (cfg.policy, cfg.ctc_sectors_per_line), []).append(i)
        else:
            results[i] = _simulate(trace, cfg, nvlink, dev, "simulate_many")

    for idxs in groups.values():
        if ck is not None:
            pend = []
            for i in idxs:
                hit = ck.get_hms(tfp, configs[i], nvlink)
                if hit is not None:
                    results[i] = _finish_hms(trace, configs[i], hit, nvlink,
                                             dev)
                else:
                    pend.append(i)
            idxs = pend
            if not idxs:
                continue
        cfgs = [configs[i] for i in idxs]
        key = group_engine_key(trace, cfgs)
        if len(idxs) == 1:
            i = idxs[0]
            C = _run_hms_scan(trace, configs[i], dev, key,
                              entry="simulate_many")
            if ck is not None:
                ck.put_hms(tfp, configs[i], nvlink, C)
            results[i] = _finish_hms(trace, configs[i], C, nvlink, dev)
            continue
        Cs = _run_hms_batch(trace, cfgs, key, dev)
        with obs.span("postprocess", trace=trace.name, batch=len(idxs)):
            for i, C in zip(idxs, Cs):
                if ck is not None:
                    # journal before finishing, so a kill mid-batch keeps
                    # every lane the engine already produced
                    ck.put_hms(tfp, configs[i], nvlink, C)
                results[i] = _finish_hms(trace, configs[i], C, nvlink, dev)
    return results


def run_workload(name: str, cfg: HMSConfig, n: int | None = None,
                 nvlink: bool = False, *, device=None) -> SimResult:
    from .traces import make_trace

    trace = make_trace(name, n=n)
    cfg = dataclasses.replace(cfg, footprint=trace.footprint)
    return simulate(trace, cfg, nvlink=nvlink, device=device)
