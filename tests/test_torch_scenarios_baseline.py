"""The port against ``benchmarks/baselines/BENCH_scenarios.json``, on the
CPU and without JAX: five of its 20 points, each scenario once, covering
all four oversubscription levels and the UM overflow model (oversub 2 and
4).  Each point runs as the scenarios suite runs it: ``simulate_many`` of
the HMS and InfHBM at the nominal footprint over the trace compiled at the
point's oversubscription.  The trace fingerprint and config digest equal
the baseline's strings; integer-valued counters match exactly, fractional
ones (and runtimes, ratios, hit rates) within rtol 1e-9; at oversub 1 the
per-phase summary too.  (``chip_smoke.py`` checks all 20 on the card.)"""

import json
import math
from pathlib import Path

import pytest

import repro_torch.core as T
from repro_torch.resilience import sweepckpt
from repro_torch.workloads import SCENARIOS

BASE = json.loads((Path(__file__).resolve().parent.parent / "benchmarks"
                   / "baselines" / "BENCH_scenarios.json").read_text())
FRACTIONAL = {"dram_busy", "scm_busy", "dram_acts", "scm_acts",
              "scm_wr_acts"}
POINTS = [("graph_pipeline", 0.5), ("llm_serve", 1.0), ("moe_expert", 2.0),
          ("multi_tenant", 4.0), ("train_step", 2.0)]


def _close(got, want):
    return math.isclose(got, want, rel_tol=1e-9, abs_tol=1e-9)


@pytest.mark.parametrize("name,oversub", POINTS)
def test_scenario_point_matches_baseline(name, oversub):
    entry = BASE["scenarios"][name]
    p = next(q for q in entry["sweep"] if q["oversub"] == oversub)
    n = BASE["n"]
    scn = SCENARIOS[name]
    t = scn.compile(n=n) if oversub == 1.0 else scn.compile(n=n,
                                                           oversub=oversub)
    assert sweepckpt.trace_fingerprint(t) == p["trace_fp"]
    fp = entry["footprint_bytes"]
    cfg = T.HMSConfig(footprint=fp)
    assert sweepckpt.config_digest(cfg) == p["config_digest"]
    hms, inf = T.simulate_many(
        t, [cfg, T.HMSConfig(footprint=fp, organization="inf_hbm")],
        device="cpu")
    assert set(hms.counters) == set(p["counters"])
    assert ("um_faults" in hms.counters) == (oversub > 1.0)
    for k, want in p["counters"].items():
        got = hms.counters[k]
        if k in FRACTIONAL:
            assert _close(got, want), (k, got, want)
        else:
            assert got == want, (k, got, want)
    assert _close(hms.runtime_cycles, p["runtime_cycles"])
    assert _close(hms.runtime_cycles / inf.runtime_cycles,
                  p["runtime_rel_inf"])
    assert _close(hms.hit_rate_read, p["hit_rate_read"])
    assert _close(hms.hit_rate_write, p["hit_rate_write"])
    assert _close(hms.total_traffic / max(1.0, inf.total_traffic),
                  p["total_traffic_rel_inf"])
    if oversub == 1.0:
        got = hms.phase_summary()
        assert list(got) == entry["phase_names"]
        for ph, row in entry["phases"].items():
            for k, want in row.items():
                assert _close(got[ph][k], want), (ph, k)
