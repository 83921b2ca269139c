"""Two-tier block table: the paper's DRAM-cache state over a pool of HBM
slots (a copy of the JAX package's ``memtier/block_table.py`` on torch
tensors).

HBM ("DRAM cache") is a direct-mapped pool of ``num_slots`` block slots over
a larger capacity tier ("SCM" = host memory).  Metadata is AMIL-packed: one
int32 lane per slot (tag[0:2] | valid[2] | dirty[3] | affinity[4:6]), so
:func:`probe_blocks` is the ``amil_probe`` kernel's work: one launch of it on
the card, its plain version on CPU tensors.

The state is a dict of tensors on one device, every transition a function
of the state and the round's requests.  Two rules of the reference are kept
as they are (ROADMAP §C): tags keep two bits, so blocks ``b`` and
``b + 4 * num_slots`` alias; and when a round sends several requests to one
slot, the metadata write of the *last* of them wins, fill or not (JAX's
``.at[].set`` on the host), made explicit here so that the card and the CPU
agree.  The round's mean penalty is summed in the reference's order
(:func:`_xla_sum`), so the decisions that depend on it are bit-equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .._device import resolve_device
from ..core import bypass as bp
from ..core.timing import DeviceTiming
from ..kernels.amil_probe import ops as probe_ops

_U32 = 0xFFFFFFFF
_WINDOW = 32          # XLA's tree reduction: windows of 32, then their sums


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Two-tier geometry + the timing constants driving the scores.

    fast == HBM, slow == host/capacity tier.  The penalty score uses the
    paper's Eq. 1 with 'activation' = per-transfer setup latency and
    'write recovery' = writeback cost, expressed in microseconds.
    """
    block_bytes: int = 256 * 1024
    blocks_per_super: int = 8
    num_slots: int = 256                      # fast-tier capacity in blocks
    num_blocks: int = 2048                    # slow-tier capacity in blocks
    n_levels: int = 4
    ema_weight: float = 0.01
    use_activation_counter: bool = True
    # Eq.1 constants (us): slow-tier fetch setup vs fast, write penalty.
    fast_setup_us: float = 1.0
    slow_setup_us: float = 20.0
    fast_write_us: float = 1.0
    slow_write_us: float = 60.0

    @property
    def timing_fast(self) -> DeviceTiming:
        return DeviceTiming(rcd=int(self.fast_setup_us),
                            wr=int(self.fast_write_us), kind="dram")

    @property
    def timing_slow(self) -> DeviceTiming:
        return DeviceTiming(rcd=int(self.slow_setup_us),
                            wr=int(self.slow_write_us), kind="scm")

    @property
    def num_supers(self) -> int:
        return self.num_blocks // self.blocks_per_super


def init_state(cfg: TierConfig, device=None) -> Dict[str, torch.Tensor]:
    """The empty table on ``device`` (default: the card).  int32 lanes,
    activation counters and event counters; float32 scores; ``rng`` a
    uint32 held in int64."""
    dev = resolve_device(device, "memtier.init_state")

    def i32(n=()):
        return torch.zeros(n, dtype=torch.int32, device=dev)

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    return {
        # AMIL lanes: tag | valid | dirty | affinity per slot
        "meta": i32((cfg.num_slots,)),
        # per-superblock activation (hotness) counters
        "act": i32((cfg.num_supers,)),
        "pen_ema": f32(0.0),
        "pen_max": f32(1e-6),
        "aff_max": f32(1e-6),
        "rng": torch.tensor(0x2545F491, dtype=torch.int64, device=dev),
        # counters
        "fast_hits": i32(),
        "slow_reads": i32(),
        "fills": i32(),
        "bypasses": i32(),
        "writebacks": i32(),
    }


def _pack(tag, valid, dirty, aff):
    return (tag & 3) | (valid << 2) | (dirty << 3) | ((aff & 3) << 4)


def _unpack(meta):
    return meta & 3, (meta >> 2) & 1, (meta >> 3) & 1, (meta >> 4) & 3


def probe_blocks(state, blocks, cfg: TierConfig):
    """Residency of ``blocks`` (int32[N] global block ids) through
    ``amil_probe``.

    Returns (hit int32[N], slot int32[N], dirty int32[N], aff int32[N]),
    for a table of any size (on the card one probe launch: the table in
    shared memory up to ``amil_probe.ops.MAX_LANES`` lanes, else read from
    device memory)."""
    slots = blocks % cfg.num_slots
    tags = blocks // cfg.num_slots
    hit, dirty, aff = probe_ops.probe(state["meta"], slots, tags)
    return hit, slots, dirty, aff


def _xla_sum(x):
    """The float32 sum of 1-D ``x`` in the order the JAX package's host
    backend takes it: while more than 32 values are left, they are padded
    with zeros (half the padding in front) to whole windows of 32, and
    each window is summed from 0.0 in order; the last 32 or fewer are
    summed from 0.0 in order.  Any other order can differ in the last bit
    where the sum rounds."""
    while x.shape[0] > _WINDOW:
        pad = -x.shape[0] % _WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.view(-1, _WINDOW)
        acc = torch.zeros_like(x[:, 0])
        for k in range(_WINDOW):
            acc = acc + x[:, k]
        x = acc
    acc = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc


def _last_per_slot(slots, num_slots: int):
    """bool[N]: request i is the last of its round to name its slot."""
    pos = torch.arange(slots.shape[0], device=slots.device)
    last = torch.full((num_slots,), -1, dtype=pos.dtype, device=slots.device)
    last.scatter_reduce_(0, slots.long(), pos, reduce="amax")
    return last[slots.long()] == pos


def access(state, blocks, is_write, run_blocks, cfg: TierConfig):
    """One batched access round: probe + bypass policy + fills.

    blocks:     int32[N] requested block ids
    is_write:   bool[N]
    run_blocks: float32[N] contiguous blocks touched in the same superblock
                (spatial locality — the Eq. 1 denominator)

    Returns (state, decision dict) where decision["fill"] marks blocks the
    caller must copy into their slot (the data movement is the caller's).
    """
    fast, slow = cfg.timing_fast, cfg.timing_slow
    hit, slots, v_dirty, v_aff = probe_blocks(state, blocks, cfg)
    tags = blocks // cfg.num_slots
    supers = (blocks // cfg.blocks_per_super).long()
    old = state["meta"][slots.long()]
    old_tag, old_valid, old_dirty, _ = _unpack(old)

    # hotness: repeated superblocks of a round each add one
    act = state["act"].index_add(
        0, supers, torch.ones_like(supers, dtype=torch.int32))
    page_act = act[supers]
    max_act = page_act.max().to(torch.float32).clamp_min(1.0)

    # Eq. 1 scores
    pen = bp.scm_penalty_score(run_blocks, is_write, fast, slow)
    pen_max = torch.maximum(state["pen_max"], pen.max())
    # batched EMA: fold the round's mean in with the configured weight (the
    # mean as XLA takes it: its float32 sum times float32(1 / N))
    mean = _xla_sum(pen) * (1.0 / pen.shape[0])
    pen_ema = bp.ema_update(state["pen_ema"], mean, cfg.ema_weight)
    req_lvl = bp.discretize(pen, pen_max, cfg.n_levels)
    avg_lvl = bp.discretize(pen_ema, pen_max, cfg.n_levels)

    aff = bp.affinity_score(pen, page_act, cfg.use_activation_counter)
    aff_max = torch.maximum(state["aff_max"], aff.max())
    req_aff = bp.discretize(aff, aff_max, cfg.n_levels)

    miss = hit == 0
    pass1 = req_lvl > avg_lvl
    valid_victim = old_valid == 1
    accept = ~valid_victim | (req_aff > v_aff)
    fill = miss & pass1 & accept
    bypass = miss & ~fill

    # victim affinity decay with p_dec
    rng = bp.xorshift32(state["rng"])
    dice = bp.uniform01((rng + blocks.long()) & _U32)
    dec = (miss & pass1 & ~accept & valid_victim
           & (dice < bp.p_dec(page_act, max_act)))

    wb = fill & (v_dirty == 1)

    # metadata update: fills take the slot; decayed victims lose a level
    w = is_write.to(torch.int32)
    new_aff = torch.where(fill, req_aff,
                          (v_aff - dec.to(torch.int32)).clamp_min(0))
    new_meta = torch.where(
        fill, _pack(tags, torch.ones_like(tags), w, req_aff),
        _pack(old_tag, old_valid, old_dirty | (hit & w), new_aff))
    # one write a slot: the other requests land in a spare lane past the
    # table (no host sync, nothing left to the order of a scatter)
    idx = torch.where(_last_per_slot(slots, cfg.num_slots), slots.long(),
                      cfg.num_slots)
    meta = torch.cat([state["meta"], state["meta"].new_zeros(1)])
    meta[idx] = new_meta
    meta = meta[:cfg.num_slots]

    def total(name, flags):
        return state[name] + flags.sum().to(torch.int32)

    new_state = {
        **state,
        "meta": meta,
        "act": act,
        "pen_ema": pen_ema,
        "pen_max": pen_max,
        "aff_max": aff_max,
        "rng": rng,
        "fast_hits": total("fast_hits", hit),
        "slow_reads": total("slow_reads", miss),
        "fills": total("fills", fill),
        "bypasses": total("bypasses", bypass),
        "writebacks": total("writebacks", wb),
    }
    decision = {"hit": hit.bool(), "slot": slots, "fill": fill,
                "bypass": bypass, "writeback": wb,
                "victim_block": old_tag * cfg.num_slots + slots}
    return new_state, decision
