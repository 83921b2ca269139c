"""Timing, geometry and energy parameters for the HMS memory system.

All timing parameters are in memory-controller cycles (1 GHz bus clock in the
paper's Table I, so 1 cycle == 1 ns) and follow Table I of the paper verbatim:

    DRAM: CL 14, RCD 14,  RAS 33,  WR 16,   RP 14
    SCM : CL 14, RCD 120, RAS 120, WR 1000, RP 14   (MLC default)
    SLC : RCD 60,  RAS 60,  WR 150
    TLC : RCD 250, RAS 250, WR 2350

Geometry follows §III-A: 2 KiB rows, 32 B columns (64 columns / row), 256 B
DRAM cachelines (8 columns), 8 cachelines per row.  Energy (pJ/bit) follows
Table I.  The classes are plain frozen dataclasses so they can be closed over
by the engine as static configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# ---------------------------------------------------------------------------
# Geometry constants (bytes).
# ---------------------------------------------------------------------------
COLUMN_BYTES = 32          # one column access moves 32 B (BL2 x 128-bit bus)
ROW_BYTES = 2048           # 2 KiB row buffer
DEFAULT_LINE_BYTES = 256   # DRAM cacheline (the paper's proposed size)
COLUMNS_PER_ROW = ROW_BYTES // COLUMN_BYTES            # 64
PAGE_BYTES = 2 * 1024 * 1024                           # activation-counter grain

# UM / host-link constants (§IV-A).
PAGE_FAULT_LATENCY_NS = 20_000.0     # 20 us optimistic fault handling
UM_PAGE_BYTES = 4096                 # x86 page granularity
PCIE_BW_GBPS = 12.8                  # 1/5 of PCIe4 x16 (down-scaled A100)
NVLINK_BW_GBPS = 76.8
PCIE_ENERGY_PJ_PER_BIT = 8.0


@dataclasses.dataclass(frozen=True)
class DeviceTiming:
    """Timing parameters of one memory device (DRAM or SCM), in bus cycles.

    ``kind`` names the device role ("dram" or "scm") so counter attribution
    never has to guess from timing magnitudes (a fast SLC-mode SCM is still
    SCM for traffic/energy accounting).
    """

    cl: int = 14
    rcd: int = 14
    ras: int = 33
    wr: int = 16
    rp: int = 14
    kind: str = "dram"

    def row_miss_read_cycles(self, ncols: int) -> float:
        """Closed-page activation + ncols column reads + precharge."""
        return self.rcd + self.cl + ncols + self.rp

    def row_miss_write_cycles(self, ncols: int) -> float:
        return self.rcd + self.cl + ncols + self.wr + self.rp


DRAM = DeviceTiming(cl=14, rcd=14, ras=33, wr=16, rp=14, kind="dram")
SCM_MLC = DeviceTiming(cl=14, rcd=120, ras=120, wr=1000, rp=14, kind="scm")
SCM_SLC = DeviceTiming(cl=14, rcd=60, ras=60, wr=150, rp=14, kind="scm")
SCM_TLC = DeviceTiming(cl=14, rcd=250, ras=250, wr=2350, rp=14, kind="scm")

SCM_MODES = {"slc": SCM_SLC, "mlc": SCM_MLC, "tlc": SCM_TLC}

# Capacity of the same SCM dies in each cell mode, relative to the MLC
# baseline the geometry model (``HMSConfig.scm_capacity``) is sized for:
# SLC stores 1 bit/cell (half of MLC's 2), TLC 3 (1.5x).
SCM_MODE_CAPACITY_VS_MLC = {"slc": 0.5, "mlc": 1.0, "tlc": 1.5}


# Policies whose engine carries CTC state through the scan.  Shared single
# source of truth for the simulator's engine branching and the trace shard
# partitioner (which must partition by CTC set exactly when the engine
# probes one).
POLICIES_WITH_CTC = ("hms", "no_bypass", "no_second_level")

# The full vocabularies the validator and the engine dispatch share (one
# source of truth for error messages listing the valid choices; see the
# HMSConfig docstring for what each one models).
POLICIES = (
    "hms", "no_bypass", "no_bypass_no_ctc", "no_second_level",
    "bear", "redcache", "mccache", "always_cache",
)
ORGANIZATIONS = ("hms", "separate", "hbm", "scm", "inf_hbm")
TAG_LAYOUTS = ("amil", "tad")
LINE_BYTES_CHOICES = (64, 128, 256, 512, 1024)


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    """pJ/bit access energies (Table I)."""

    dram_act: float = 1.17
    dram_pre: float = 0.39
    dram_rd: float = 0.93
    dram_wr: float = 1.02
    scm_act: float = 2.47
    scm_pre_wr: float = 16.82    # SCM precharge w/ write recovery (RESET/SET)
    scm_rd: float = 0.93
    scm_wr: float = 1.02
    link_pj_per_bit: float = PCIE_ENERGY_PJ_PER_BIT


@dataclasses.dataclass(frozen=True)
class HMSConfig:
    """Full configuration of a simulated memory system.

    ``policy`` selects the cache-management policy:
      hms          - full proposal (bypass + CTC + AMIL)
      no_bypass    - HMS-BP   (every miss fills)
      no_bypass_no_ctc - HMS-BP-CTC (every miss fills, every probe hits DRAM)
      no_second_level  - bypass level-1 comparison only (ablation, §IV-B)
      bear         - BEAR_i:    ideal presence bits + 90% probabilistic bypass
      redcache     - RedCache_i: access-count threshold bypass (ideal gamma)
      mccache      - McCache_i:  mostly-clean, write-through to SCM
      always_cache - fill on every miss, no CTC, no bypass (worst case)
    ``organization`` selects the memory system under test:
      hms          - DRAM cache + SCM sharing each channel (Fig. 6a)
      separate     - DRAM cache and SCM on separate buses (Fig. 6b)
      hbm          - oversubscribed HBM + UM paging over host link
      scm          - SCM-only stack
      inf_hbm      - infinite-capacity HBM (never oversubscribed)
    ``tag_layout``: amil | tad  (§III-B / Fig. 7)
    ``scm_mode``: slc | mlc | tlc, or "auto" to footprint-adapt (§III-E):
      the fastest cell mode whose capacity still holds the footprint.
    """

    # Capacities, bytes.  ``footprint`` is the workload footprint; the memory
    # devices are scaled from it exactly like §IV-A: at r_hbm=0.75 the HBM
    # holds 75% of the footprint, the HMS DRAM cache holds footprint*0.375 and
    # the SCM footprint*1.5 (4x density SCM dies replacing half the DRAM dies).
    footprint: int = 64 * 1024 * 1024
    r_hbm: float = 0.75
    dram_ratio: float = 0.5      # fraction of stack dies that stay DRAM
    line_bytes: int = DEFAULT_LINE_BYTES

    organization: str = "hms"
    policy: str = "hms"
    tag_layout: str = "amil"
    scm_mode: str = "mlc"

    # Channel / bank geometry (Table I): 8 channels x 16 banks.
    channels: int = 8
    banks_per_channel: int = 16

    # Bypass-policy knobs (§III-C).
    n_levels: int = 4
    ema_weight: float = 0.01     # moving-average weight of a new value
    # §IV-A: "We disabled the activation counter for simplicity" (the
    # counters still drive p_dec); enable to study the ideal-counter gain.
    use_activation_counter: bool = False
    bear_fill_prob: float = 0.1          # BEAR's probabilistic fill
    redcache_threshold: int = 2          # RedCache_i access-count threshold

    # CTC (§III-D): total tag-sector capacity, in DRAM-row tag sectors.  The
    # paper sizes the CTC to hold a quarter of all DRAM-cache tags.
    ctc_fraction: float = 0.25
    ctc_ways: int = 16
    ctc_sectors_per_line: int = 8    # one 32B CTC line covers 8 DRAM rows

    # Host link for the UM baseline.
    link_bw_gbps: float = PCIE_BW_GBPS
    fault_latency_ns: float = PAGE_FAULT_LATENCY_NS
    fault_overlap: float = 16.0          # concurrent fault handling factor
    um_prefetch_pages: int = 4           # TBN-style migration chunk (16 KiB)
    um_hot_threshold: int = 4            # access count triggering nvlink
    #                                      access-counter migration

    # Activation-counter grain.  The paper uses 2 MiB for GiB-scale GPU
    # memories (80 KiB of counters for 160 GiB); we default to the same
    # counters-per-capacity ratio for MiB-scale simulated footprints.
    act_page_bytes: int = 64 * 1024

    # SCM power throttling (§III-E): multiplies SCM rcd / wr when enabled.
    throttle_act: bool = False
    throttle_wr: bool = False

    energy: EnergyParams = dataclasses.field(default_factory=EnergyParams)

    # Compute floor: cycles of "pure compute" per trace request; makes fully
    # cached workloads converge to a finite runtime (roofline-style max()).
    # 0.05 keeps the paper's memory-bound workload mix memory-limited while
    # bounding fully-cached runtimes.
    compute_cycles_per_request: float = 0.05

    # ----- derived geometry -------------------------------------------------
    @property
    def dram_timing(self) -> DeviceTiming:
        return DRAM

    @property
    def _scm_capacity_mlc(self) -> int:
        """SCM capacity of the dies at the MLC (2 bit/cell) baseline the
        geometry model is sized for; the mode-aware :attr:`scm_capacity`
        scales it by the effective cell mode's density."""
        return int(self.hbm_capacity * (1.0 - self.dram_ratio) * 4.0)

    @property
    def effective_scm_mode(self) -> str:
        """Resolve ``scm_mode="auto"`` by footprint adaptation (§III-E): run
        the SCM in the fastest cell mode whose capacity still holds the
        workload footprint — SLC if it fits at half the MLC capacity, MLC if
        it fits at the nominal capacity, else TLC for the extra density."""
        if self.scm_mode != "auto":
            return self.scm_mode
        for mode in ("slc", "mlc"):
            cap = int(self._scm_capacity_mlc * SCM_MODE_CAPACITY_VS_MLC[mode])
            if self.footprint <= cap:
                return mode
        return "tlc"

    @property
    def scm_timing(self) -> DeviceTiming:
        base = SCM_MODES[self.effective_scm_mode]
        rcd = base.rcd * (2 if self.throttle_act else 1)
        wr = base.wr * (2 if self.throttle_wr else 1)
        return dataclasses.replace(base, rcd=rcd, wr=wr)

    @property
    def hbm_capacity(self) -> int:
        return int(self.footprint * self.r_hbm)

    @property
    def dram_cache_capacity(self) -> int:
        # DRAM dies halved relative to HBM; SCM dies have 4x density.
        return int(self.hbm_capacity * self.dram_ratio)

    @property
    def scm_capacity(self) -> int:
        """Capacity in the *effective* cell mode: the same dies hold half
        the MLC bytes in SLC mode and 1.5x in TLC (§III-E's tradeoff — the
        mode that sets the timings also sets the capacity, so the
        UM-overflow check and footprint adaptation stay consistent)."""
        return int(self._scm_capacity_mlc
                   * SCM_MODE_CAPACITY_VS_MLC[self.effective_scm_mode])

    @property
    def num_lines(self) -> int:
        return max(1, self.dram_cache_capacity // self.line_bytes)

    @property
    def lines_per_row(self) -> int:
        return ROW_BYTES // self.line_bytes

    @property
    def columns_per_line(self) -> int:
        return self.line_bytes // COLUMN_BYTES

    @property
    def num_rows(self) -> int:
        return max(1, self.dram_cache_capacity // ROW_BYTES)

    @property
    def ctc_total_sectors(self) -> int:
        """Number of DRAM-row tag sectors the CTC can hold."""
        return max(self.ctc_ways, int(self.num_rows * self.ctc_fraction))

    @property
    def ctc_sets(self) -> int:
        """Set count, rounded down to a power of two.

        Hardware indexes sets by bit-masking the row-group address, so a
        non-power-of-two count is unrealizable.  Rounding down keeps the
        modeled capacity within the ``ctc_fraction`` sector budget (round
        up would inflate it by up to 2x and skew capacity sweeps).
        """
        per_line = self.ctc_ways * self.ctc_sectors_per_line
        raw = max(1, self.ctc_total_sectors // per_line)
        return 1 << (raw.bit_length() - 1)

    @property
    def tag_bits(self) -> int:
        """DRAM cache tag width: log2(SCM/DRAM-cache capacity ratio)."""
        ratio = max(2, self.scm_capacity // max(1, self.dram_cache_capacity))
        return max(1, (ratio - 1).bit_length())

    def validate(self) -> "HMSConfig":
        """Structured validation of every field (memoized per config):
        raises :class:`repro_torch.resilience.ValidationError` with the field
        path and a fix hint — and, unlike the asserts this used to be,
        survives ``python -O``."""
        from repro_torch.resilience.validate import validate_config
        return validate_config(self)


def metadata_bits_per_line(cfg: HMSConfig) -> int:
    """Per-cacheline metadata: tag + valid + dirty + 2-bit DRAM affinity."""
    return cfg.tag_bits + 1 + 1 + 2


def metadata_bits_per_row(cfg: HMSConfig) -> int:
    return metadata_bits_per_line(cfg) * cfg.lines_per_row


def amil_fits_in_column(cfg: HMSConfig) -> bool:
    """§III-B: with 256B lines and 2KiB rows the 8 lines need 48 bits,
    comfortably inside one 32 B (256-bit) column."""
    return metadata_bits_per_row(cfg) <= COLUMN_BYTES * 8
