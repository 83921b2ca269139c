"""Trace-driven HMS / DRAM-cache simulator on PyTorch, with its sequential
scan as a CUDA kernel.

The model is the reference package's (§III of the paper): a direct-mapped
DRAM cache over SCM with AMIL or TAD tags, the Configurable Tag Cache, the
two-level SCM-aware bypass policy, prior-work policies, and the shared-bus,
separate-bus, SCM-only and infinite-HBM organizations.  Runtime is the
bottleneck model of ``_finish``; counters are float64.

Engine layout (one ``simulate`` call):

  * ``traces.preprocess`` and ``traces.shard_plan`` (NumPy, host) decompose
    addresses, segment the MSHR activation runs and partition the trace into
    S state-disjoint shards (S = 1 unless :func:`set_forced_shards` pins it).
  * The per-request-pure precompute runs in torch on the device: SCM penalty
    scores, running maxima, discretized levels, the xorshift dice and fill
    candidacy.  The float64 penalty EMA is a sequential recurrence; it runs
    as the ``ema_scan`` kernel (one CTA, the chain read from shared memory).
  * The stateful core — packed DRAM-cache words and CTC rows — is the
    ``hms_scan`` kernel: one warp per (shard lane, CTC set) walks that set's
    requests in order (without a CTC, per row-group residue) and emits one
    int32 decision word per request.
  * The decision words are scattered back to trace order and every counter
    is reduced vectorially on the device (segment sums per phase for
    scenario traces); ``_finish`` turns the counters into runtime, traffic
    and energy on the host in NumPy float64, so the totals of a phased trace
    are ``np.sum`` of its per-phase vector.

On the CPU (``device="cpu"``) the kernels' plain PyTorch versions run
instead.  The UM paging engine — the ``hbm`` organization and HMS footprint
overflow — is not ported yet; those inputs raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..resilience import validate as _rvalidate
from . import bypass as bp
from .timing import COLUMN_BYTES, POLICIES_WITH_CTC, HMSConfig
from .traces import Trace, preprocess, shard_plan

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
_UM_TODO = ("the UM paging engine is not ported yet (ROADMAP item A5); "
            "run this point with the JAX package")


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
        return out


# ---------------------------------------------------------------------------
# Device, shard count and engine shapes.
# ---------------------------------------------------------------------------

_FORCED_SHARDS: Optional[int] = None


def set_forced_shards(n: int | None) -> int | None:
    """Pin the shard count S (lanes of the scan kernel); ``None`` restores
    the default S = 1.  Counters are identical at every S.  Returns the
    previous value."""
    global _FORCED_SHARDS
    if n is not None and int(n) < 1:
        raise ValueError(f"shard count must be >= 1, got {n}")
    old, _FORCED_SHARDS = _FORCED_SHARDS, None if n is None else int(n)
    return old


def _bucket(n: int) -> int:
    """Next power of two — state arrays are allocated at bucketed sizes
    (indices never reach the slack, so counters are unaffected)."""
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class _EngineKey:
    policy: str
    n: int                  # trace length
    shards: int             # lanes S (1 = sequential scan)
    depth: int              # per-lane scan length
    lines_alloc: int        # per-lane DRAM-cache slot allocation (bucketed)
    ctc_sets_alloc: int     # per-lane CTC set allocation (bucketed)
    ctc_ways_alloc: int
    ctc_sectors: int
    phases: int = 1         # counter segments (scenario phase count)


def _engine_key(trace: Trace, cfg: HMSConfig) -> _EngineKey:
    shards = _FORCED_SHARDS or 1
    plan = shard_plan(trace, cfg, shards)
    use_ctc = cfg.policy in POLICIES_WITH_CTC
    return _EngineKey(
        policy=cfg.policy, n=trace.n, shards=shards, depth=plan["depth"],
        lines_alloc=_bucket(plan["lines_bound"]),
        # non-CTC policies carry no CTC state; allocate the minimum
        ctc_sets_alloc=_bucket(plan["n_sets_local"]) if use_ctc else 1,
        ctc_ways_alloc=_bucket(cfg.ctc_ways) if use_ctc else 1,
        ctc_sectors=cfg.ctc_sectors_per_line,
        phases=trace.n_phases)


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
        "pos": to(plan["pos"].astype(np.int64)),
    }
    if trace.n_phases > 1:
        xs["phase"] = to(trace.phase_id.astype(np.int64))
    return xs


def _scan_streams(key: _EngineKey, xs, p, dev):
    """The precompute: per-request-pure work, then the two packed input
    streams of the scan kernel in (lanes, depth) layout.  Returns
    ``(slot, meta, derived)``, ``derived`` holding what the counter
    reduction reads again."""
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
    # 3..7 sector | 8..15 req_aff_lvl | 16 live (pad gate, set after the
    # shard gather) | 17..39 row group | 40..61 tag
    i64 = torch.int64
    meta_tr = (is_write.to(i64)
               | (dec_ok.to(i64) << 1)
               | (cand.to(i64) << 2)
               | (xs["sector"].to(i64) << 3)
               | (req_aff_lvl.to(i64) << 8)
               | (xs["row_group"].to(i64) << 17)
               | (xs["tag"].to(i64) << 40))
    pos = xs["pos"]                              # (lanes, depth), pad == n
    posc = pos.clamp_max(key.n - 1)
    slot = xs["slot"][posc]
    meta = meta_tr[posc] | ((pos < key.n).to(i64) << 16)
    derived = dict(dram=dram, scm=scm, pass1=pass1, pen64=pen64)
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


def scan_inputs(trace: Trace, cfg: HMSConfig, dev) -> Dict[str, object]:
    """Everything the HMS engine launches its scan kernel with, for one
    validated (trace, cfg) on device ``dev``: the engine ``key``, the
    device inputs ``xs``, the runtime ``params``, the packed ``slot`` /
    ``meta`` streams in (lanes, depth) layout, the ``derived`` precompute
    the reduction reads again, and the kernel's keyword arguments
    ``scan``."""
    key = _engine_key(trace, cfg)
    use_ctc = key.policy in POLICIES_WITH_CTC
    xs = _engine_inputs(trace, cfg, preprocess(trace, cfg), key, dev)
    n_sets = shard_plan(trace, cfg, key.shards)["n_sets_local"] \
        if use_ctc else 1
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


def _run_hms_scan(trace: Trace, cfg: HMSConfig,
                  dev: torch.device) -> Dict[str, np.ndarray]:
    from ..kernels.hms_scan import ops as scan_ops   # kernels import core

    s = scan_inputs(trace, cfg, dev)
    key, pos = s["key"], s["xs"]["pos"]
    y_sh, _, _ = scan_ops.hms_scan(s["slot"], s["meta"], **s["scan"])
    # scatter the decision words back to trace order; padding sentinels
    # land in the dropped overflow slot n
    y_tr = torch.zeros(key.n + 1, dtype=torch.int32, device=dev)
    y_tr[pos.reshape(-1)] = y_sh.reshape(-1)
    return _reduce_counters(key, s["xs"], s["params"], y_tr[: key.n],
                            s["derived"], dev)


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
            n_requests=1, phase_names=()) -> SimResult:
    # Split phased counters: per-phase vectors are kept verbatim and the
    # whole-trace totals are their sums (np.sum over the same float64 vector
    # is deterministic, so per-phase attribution is exact by construction).
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

def simulate(trace: Trace, cfg: HMSConfig, nvlink: bool = False, *,
             device=None) -> SimResult:
    """Simulate ``trace`` on the memory system described by ``cfg``.

    ``device=None`` runs on the CUDA card and raises if there is none;
    ``device="cpu"`` runs the kernels' plain versions on the host.
    ``nvlink`` selects the host link of the UM paging model, which this
    port does not have yet (see the ``NotImplementedError`` cases)."""
    dev = resolve_device(device, "simulate")
    cfg = cfg.validate()
    _rvalidate.validate_trace(trace)
    org = cfg.organization
    if org == "hbm":
        raise NotImplementedError(f"organization 'hbm': {_UM_TODO}")
    if org in ("inf_hbm", "scm"):
        timing = cfg.dram_timing if org == "inf_hbm" else cfg.scm_timing
        C = _single_tier_counters(trace, cfg, timing, dev)
        return _finish(trace.name, cfg, C, n_requests=trace.n,
                       phase_names=trace.phase_names)
    # hms / separate: refuse an overflow before any device work
    if trace.footprint > cfg.scm_capacity + cfg.dram_cache_capacity:
        raise NotImplementedError(
            f"Trace({trace.name}) overflows the HMS capacity: {_UM_TODO}")
    C = _run_hms_scan(trace, cfg, dev)
    return _finish(trace.name, cfg, C, n_requests=trace.n,
                   phase_names=trace.phase_names)


def run_workload(name: str, cfg: HMSConfig, n: int | None = None,
                 nvlink: bool = False, *, device=None) -> SimResult:
    from .traces import make_trace

    trace = make_trace(name, n=n)
    cfg = dataclasses.replace(cfg, footprint=trace.footprint)
    return simulate(trace, cfg, nvlink=nvlink, device=device)
