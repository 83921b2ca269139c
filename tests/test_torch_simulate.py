"""The port's ``simulate`` against the JAX package's, on the CPU.

The same trace and config go through ``repro.core.simulate`` and
``repro_torch.core.simulate(device="cpu")`` (the kernels' plain versions).
Integer-valued counters must match exactly.  Fractional counters (bank busy
cycles and activation counts, sums of float32 shares in float64), runtime,
bottleneck terms and energy match to the reference's own golden tolerance,
rtol 1e-9 / atol 1e-6: the two reductions add in different orders.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R

import repro_torch
import repro_torch.core as T
from repro_torch.convert import config_from_dict, trace_from_arrays
from repro_torch.core import simulator as tsim

sys.path.insert(0, str(Path(__file__).parent))
from test_engine_parity import GOLDEN_CONFIGS, _golden_trace  # noqa: E402

FRACTIONAL = {"dram_busy", "scm_busy", "dram_acts", "scm_acts",
              "scm_wr_acts"}
TOL = dict(rtol=1e-9, atol=1e-6)


def _port(trace, cfg, **kw):
    return T.simulate(
        trace_from_arrays(trace.name, trace.col, trace.is_write,
                          trace.footprint, trace.phase_id,
                          trace.phase_names),
        config_from_dict(dataclasses.asdict(cfg)), device="cpu", **kw)


def _assert_counters(got, ref, what=""):
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        if k in FRACTIONAL:
            np.testing.assert_allclose(g, r, **TOL, err_msg=f"{what} {k}")
        else:
            assert np.all(np.mod(r, 1.0) == 0), (what, k)
            assert np.array_equal(g, r), (what, k, g, r)


def _assert_result(got, ref):
    _assert_counters(got.counters, ref.counters)
    np.testing.assert_allclose(got.runtime_cycles, ref.runtime_cycles, **TOL)
    for field in ("terms", "energy_pj", "traffic_bytes"):
        g, r = getattr(got, field), getattr(ref, field)
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_allclose(g[k], r[k], **TOL, err_msg=k)
    for field in ("hit_rate_read", "hit_rate_write", "ctc_hit_rate",
                  "bypass_l1_frac"):
        assert getattr(got, field) == getattr(ref, field), field


@pytest.mark.parametrize(
    "kw", GOLDEN_CONFIGS,
    ids=["hms", "tad", "no_bypass", "no_2nd", "bear", "mccache",
         "redcache", "no_ctc"])
def test_golden_configs_match_reference(kw):
    t = _golden_trace()
    cfg = R.HMSConfig(footprint=t.footprint, **kw)
    _assert_result(_port(t, cfg), R.simulate(t, cfg))


@pytest.mark.parametrize("org", ["separate", "scm", "inf_hbm"])
def test_organizations_match_reference(org):
    t = _golden_trace()
    cfg = R.HMSConfig(footprint=t.footprint, organization=org)
    _assert_result(_port(t, cfg), R.simulate(t, cfg))


@pytest.mark.parametrize("org", ["hms", "inf_hbm"])
def test_scenario_per_phase_matches_reference(org):
    t = R.make_trace("llm_serve", n=6000)
    cfg = R.HMSConfig(footprint=t.footprint, organization=org)
    ref, got = R.simulate(t, cfg), _port(t, cfg)
    _assert_result(got, ref)
    assert got.phase_names == ref.phase_names
    _assert_counters(got.phase_counters, ref.phase_counters, "per-phase")
    for k, v in got.phase_counters.items():        # totals are the sums
        assert got.counters[k] == float(np.sum(v))


@pytest.mark.parametrize("policy", ["hms", "bear"])
def test_shard_count_does_not_change_counters(policy):
    t = T.make_trace("graph_pipeline", n=4000)
    cfg = T.HMSConfig(footprint=t.footprint, policy=policy)
    one = T.simulate(t, cfg, device="cpu")
    old = tsim.set_forced_shards(4)
    try:
        assert tsim._engine_key(t, cfg).shards == 4
        four = T.simulate(t, cfg, device="cpu")
    finally:
        tsim.set_forced_shards(old)
    assert four.counters == one.counters
    for k, v in one.phase_counters.items():
        assert np.array_equal(four.phase_counters[k], v), k


def test_um_paths_raise_not_implemented():
    t = T.make_trace("zipf", n=500)
    with pytest.raises(NotImplementedError, match="A5"):
        T.simulate(t, T.HMSConfig(footprint=t.footprint,
                                  organization="hbm"), device="cpu")
    # an HMS that cannot hold the footprint needs UM paging on top
    small = T.HMSConfig(footprint=t.footprint, r_hbm=0.1)
    assert t.footprint > small.scm_capacity + small.dram_cache_capacity
    with pytest.raises(NotImplementedError, match="A5"):
        T.simulate(t, small, device="cpu")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = T.make_trace("zipf", n=500)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.simulate(t, T.HMSConfig(footprint=t.footprint))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_workload("zipf", T.HMSConfig(), n=500)


def test_imports_and_simulates_without_jax():
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "import repro_torch.core as T",
        "r = T.run_workload('bfs_tu', T.HMSConfig(), n=800, device='cpu')",
        "assert r.counters['hit_r'] + r.counters['miss_r'] > 0",
        "bad = [m for m in sys.modules if m == 'repro' or",
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]",
        "assert not bad, bad",
        "print('ok', r.runtime_cycles)",
    ])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")
