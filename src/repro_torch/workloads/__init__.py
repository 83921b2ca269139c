"""Phase-structured scenario subsystem.

Importing this package registers every library scenario in the port's
``WORKLOADS`` registry, so ``make_trace("llm_serve", ...)`` treats
scenarios exactly like the single-pattern generators — except their
traces carry per-request ``phase_id`` and the simulator reports per-phase
counters.  ``repro_torch.core`` imports this package, so any
``from repro_torch.core import ...`` is enough to have the registry
populated.
"""

from repro_torch.core import traces as _traces

from .ir import PATTERNS, Phase, Scenario
from .library import SCENARIOS

for _name, _scn in SCENARIOS.items():
    _traces.WORKLOADS.setdefault(_name, _scn.as_workload())

__all__ = ["PATTERNS", "Phase", "Scenario", "SCENARIOS"]
