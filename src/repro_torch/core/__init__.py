"""HMS / DRAM-cache model and simulator (PyTorch port of ``repro.core``)."""

from .timing import (
    COLUMN_BYTES,
    COLUMNS_PER_ROW,
    ROW_BYTES,
    DeviceTiming,
    EnergyParams,
    HMSConfig,
    DRAM,
    SCM_MLC,
    SCM_SLC,
    SCM_TLC,
    amil_fits_in_column,
    metadata_bits_per_line,
    metadata_bits_per_row,
)
from .traces import WORKLOADS, Trace, make_trace, preprocess
from .simulator import (SimResult, run_workload, set_forced_shards, simulate,
                        simulate_many)

# Populate the WORKLOADS registry with the phase-structured scenarios
# (repro_torch.workloads appends to it on import; safe against the partial
# circular import because .traces is fully initialized above).
from repro_torch import workloads as _workloads  # noqa: E402,F401

__all__ = [
    "COLUMN_BYTES", "COLUMNS_PER_ROW", "ROW_BYTES",
    "DeviceTiming", "EnergyParams", "HMSConfig",
    "DRAM", "SCM_MLC", "SCM_SLC", "SCM_TLC",
    "amil_fits_in_column", "metadata_bits_per_line", "metadata_bits_per_row",
    "WORKLOADS", "Trace", "make_trace", "preprocess",
    "SimResult", "run_workload", "set_forced_shards", "simulate",
    "simulate_many",
]
