"""Parity of the PyTorch port's foundation with the JAX package.

Traces, preprocessing, shard plans, the dice stream, the bypass functions
and the config model of ``repro_torch`` must equal ``repro``'s bit for bit
on the same inputs.  Inputs are made from seeds with numpy and handed to
both packages.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import bypass as rbp
from repro.core import simulator as rsim
from repro.core import timing as rtiming
from repro.core import traces as rtraces

import repro_torch.core as T
from repro_torch import convert
from repro_torch.core import bypass as tbp
from repro_torch.core import simulator as tsim
from repro_torch.core import timing as ttiming
from repro_torch.core import traces as ttraces
from repro_torch.resilience import ValidationError

N = 3000                                  # small traces: shapes, not scale
NAMES = sorted(R.WORKLOADS)               # 12 generators + 5 scenarios
GEOMETRIES = [{}, {"line_bytes": 128, "ctc_sectors_per_line": 4}]


@functools.lru_cache(maxsize=None)
def _pair(name):
    return rtraces.make_trace(name, n=N), ttraces.make_trace(name, n=N)


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_registry_matches():
    assert sorted(T.WORKLOADS) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_trace_bitwise(name):
    ref, got = _pair(name)
    assert (got.name, got.footprint, got.phase_names) == \
        (ref.name, ref.footprint, ref.phase_names)
    assert _same_array(got.col, ref.col)
    assert _same_array(got.is_write, ref.is_write)
    if ref.phase_id is None:
        assert got.phase_id is None
    else:
        assert _same_array(got.phase_id, ref.phase_id)


@pytest.mark.parametrize("name", NAMES)
def test_preprocess_bitwise(name):
    ref_t, got_t = _pair(name)
    for kw in GEOMETRIES:
        ref = rtraces.preprocess(ref_t, R.HMSConfig(
            footprint=ref_t.footprint, **kw))
        got = ttraces.preprocess(got_t, T.HMSConfig(
            footprint=got_t.footprint, **kw))
        assert set(got) == set(ref)
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                assert _same_array(got[k], ref[k]), (kw, k)
            else:
                assert got[k] == ref[k], (kw, k)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_shard_plan_bitwise(name, shards):
    ref_t, got_t = _pair(name)
    for policy in ("hms", "bear"):          # CTC sets / raw row groups
        ref = rtraces.shard_plan(ref_t, R.HMSConfig(
            footprint=ref_t.footprint, policy=policy), shards)
        got = ttraces.shard_plan(got_t, T.HMSConfig(
            footprint=got_t.footprint, policy=policy), shards)
        assert set(got) == set(ref)
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                assert _same_array(got[k], ref[k]), (policy, k)
            else:
                assert got[k] == ref[k], (policy, k)


@pytest.mark.parametrize("n", [1, 7, 4096, 6000, 70_000])
def test_dice_chain_bitwise(n):
    ref = rsim._dice(n)
    got = tsim._dice(n, "cpu").numpy()
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


# ---------------------------------------------------------------------------
# Bypass functions: exact float32 (and float64 where the reference is).
# ---------------------------------------------------------------------------

def _bits_equal(got: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    got = got.numpy()
    return got.dtype == ref.dtype and np.array_equal(got, ref)


_RNG = np.random.default_rng(11)
_NCOLS = _RNG.integers(1, 65, 4000).astype(np.float32)
_WRITE = _RNG.random(4000) < 0.3
_SCORE = (_RNG.random(4000) * 500).astype(np.float32)
_ACT = _RNG.integers(0, 40, 4000).astype(np.int32)
_MAXACT = np.maximum.accumulate(_ACT)
_TIMINGS = [(rtiming.DRAM, mode) for mode in ("slc", "mlc", "tlc")]


def _check_penalty():
    for dram, mode in _TIMINGS:
        scm = rtiming.SCM_MODES[mode]
        ref = rbp.scm_penalty_score(jnp.asarray(_NCOLS), jnp.asarray(_WRITE),
                                    dram, scm)
        got = tbp.scm_penalty_score(torch.from_numpy(_NCOLS),
                                    torch.from_numpy(_WRITE), dram, scm)
        assert _bits_equal(got, ref), mode


def _check_discretize():
    mx = np.maximum.accumulate(_SCORE.astype(np.float64))
    ema = np.cumsum(_SCORE.astype(np.float64)) / np.arange(1, 4001)
    for n_levels in (1, 4, 8, 256):
        for score in (_SCORE, ema):
            ref = rbp.discretize(jnp.asarray(score), jnp.asarray(mx),
                                 n_levels)
            got = tbp.discretize(torch.from_numpy(score),
                                 torch.from_numpy(mx), n_levels)
            assert _bits_equal(got, ref), n_levels


def _check_ema_update():
    avg = _SCORE.astype(np.float64) * 0.7
    for w in (0.01, 0.05, 1.0):
        ref = rbp.ema_update(jnp.asarray(avg), jnp.asarray(_SCORE, jnp.float64),
                             jnp.float64(w))
        got = tbp.ema_update(torch.from_numpy(avg),
                             torch.from_numpy(_SCORE).double(), w)
        assert _bits_equal(got, ref), w


def _check_affinity():
    for use in (False, True):
        ref = rbp.affinity_score(jnp.asarray(_SCORE), jnp.asarray(_ACT), use)
        got = tbp.affinity_score(torch.from_numpy(_SCORE),
                                 torch.from_numpy(_ACT), use)
        assert _bits_equal(got, ref), use


def _check_p_dec():
    ref = rbp.p_dec(jnp.asarray(_ACT), jnp.asarray(_MAXACT))
    got = tbp.p_dec(torch.from_numpy(_ACT), torch.from_numpy(_MAXACT))
    assert _bits_equal(got, ref)


def _check_xorshift():
    states = _RNG.integers(0, 2**32, 5000, dtype=np.uint64)
    ref = np.asarray(rbp.xorshift32(jnp.asarray(states.astype(np.uint32))))
    got = tbp.xorshift32(torch.from_numpy(states.astype(np.int64))).numpy()
    assert np.array_equal(got, ref.astype(np.int64))


def _check_uniform01():
    states = _RNG.integers(0, 2**32, 5000, dtype=np.uint64)
    ref = rbp.uniform01(jnp.asarray(states.astype(np.uint32)))
    got = tbp.uniform01(torch.from_numpy(states.astype(np.int64)))
    assert _bits_equal(got, ref)


@pytest.mark.parametrize("check", [
    _check_penalty, _check_discretize, _check_ema_update, _check_affinity,
    _check_p_dec, _check_xorshift, _check_uniform01,
], ids=lambda f: f.__name__[len("_check_"):])
def test_bypass_function_exact(check):
    check()


# ---------------------------------------------------------------------------
# Config model and conversion.
# ---------------------------------------------------------------------------

CONFIGS = [
    {},
    {"footprint": 20 * 2**20, "scm_mode": "auto"},
    {"footprint": 40 * 2**20, "line_bytes": 128, "ctc_sectors_per_line": 4},
    {"ctc_fraction": 0.0625, "ctc_ways": 8, "tag_layout": "tad"},
    {"scm_mode": "tlc", "throttle_act": True, "throttle_wr": True},
    {"r_hbm": 1.5, "dram_ratio": 0.25, "energy": {"scm_act": 3.0}},
]
PROPERTIES = ("dram_timing", "effective_scm_mode", "scm_timing",
              "hbm_capacity", "dram_cache_capacity", "scm_capacity",
              "num_lines", "lines_per_row", "columns_per_line", "num_rows",
              "ctc_total_sectors", "ctc_sets", "tag_bits")


def _configs(kw):
    kw = dict(kw)
    energy = kw.pop("energy", None)
    ref = R.HMSConfig(**kw, **({"energy": rtiming.EnergyParams(**energy)}
                               if energy else {}))
    got = T.HMSConfig(**kw, **({"energy": ttiming.EnergyParams(**energy)}
                               if energy else {}))
    return ref, got


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_properties_match(kw):
    ref, got = _configs(kw)
    for prop in PROPERTIES:
        r, g = getattr(ref, prop), getattr(got, prop)
        if dataclasses.is_dataclass(r):
            r, g = dataclasses.asdict(r), dataclasses.asdict(g)
        assert g == r, prop
    for fn in ("metadata_bits_per_line", "metadata_bits_per_row",
               "amil_fits_in_column"):
        assert getattr(ttiming, fn)(got) == getattr(rtiming, fn)(ref), fn
    assert ttiming.POLICIES == rtiming.POLICIES
    assert ttiming.ORGANIZATIONS == rtiming.ORGANIZATIONS


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_from_dict_roundtrip(kw):
    ref, got = _configs(kw)
    d = dataclasses.asdict(ref)
    conv = convert.config_from_dict(d)
    assert conv == got
    assert dataclasses.asdict(conv) == d
    assert convert.config_from_dict(dataclasses.asdict(conv)) == conv


def test_trace_from_arrays_matches_reference():
    ref, _ = _pair("llm_serve")
    got = convert.trace_from_arrays(ref.name, ref.col, ref.is_write,
                                    ref.footprint, ref.phase_id,
                                    ref.phase_names)
    assert got.n == ref.n and got.n_phases == ref.n_phases
    assert _same_array(got.col, ref.col)
    assert _same_array(got.phase_id, ref.phase_id)


def test_validation_errors_match():
    for kw in ({"policy": "lru"}, {"n_levels": 0}, {"line_bytes": 96}):
        with pytest.raises(ValueError) as ref:
            R.HMSConfig(**kw).validate()
        with pytest.raises(ValidationError) as got:
            T.HMSConfig(**kw).validate()
        assert str(got.value) == str(ref.value)
