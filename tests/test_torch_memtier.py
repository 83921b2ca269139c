"""The port's two-tier memory runtime (``repro_torch.memtier``: the block
table and the weight streamer) and its tiered trainer against the JAX
package, on the CPU.

* ``init_state`` equals the reference's; ``probe_blocks`` (through
  ``amil_probe``'s plain version) equals it on seeded tables, two-bit tag
  aliasing included.
* ``access``: every state entry and every decision bit-equal to the
  reference's after each of 60 rounds of the write-filtering mix (random
  writes, run 1, then sequential reads, run 8) under three configs, at the
  card phase's size, at 131,072 slots (past the table the card's probe
  holds in shared memory), on runs whose penalties round (the round's mean summed
  in the reference backend's order), and where a round names one slot
  several times (the last request's metadata wins, fill or not).
* Port copies of the reference's block-table oracles
  (``test_fill_then_probe_hits``, ``test_tag_aliasing_never_false_hits``
  on 10 seeds each, ``test_block_table_write_filtering``).
* ``plan_placement`` equals the reference's ``Placement`` (both lists in
  order, both byte counts) for qwen2.5-3b, phi3.5-moe-42b and zamba2-2.7b
  smoke at budgets 0, total // 3, the optimizer state's bytes and total;
  the streamer's round trip and byte counters equal the reference's.
* ``launch.train_tiered`` at a small size in float32 (3 steps) gives the
  reference example's losses (rtol 1e-4), lines and streamed bytes.
* ``repro_torch.memtier`` and the launcher run with JAX blocked.

Each reference result is computed once (the placements once per module).
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.memtier import WeightStreamer as JaxStreamer
from repro.memtier import block_table as jbt
from repro.memtier import plan_placement as jax_plan
from repro.models import init_params as jax_init
from repro.optim import adamw as jax_adamw

import repro_torch
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels.amil_probe import ops as probe_ops
from repro_torch.launch import train_tiered
from repro_torch.memtier import (TierConfig, WeightStreamer, access,
                                 block_table, init_state, plan_placement,
                                 probe_blocks)
from repro_torch.models import Transformer
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 30            # rounds of the write-filtering mix, two batches each


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, dtype))


def _same(port, ref, what):
    """Bit-equal values (the reference's counters widen to int64 under
    x64; its rng is uint32, the port's int64)."""
    got, want = port.numpy(), np.asarray(ref)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
            (what, got, want)
    else:
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), \
            (what, got, want)


def _jcfg(cfg: TierConfig):
    return jbt.TierConfig(**dataclasses.asdict(cfg))


def _replay(cfg: TierConfig, rounds):
    """Both packages through ``rounds`` of (blocks, is_write, run_blocks),
    holding every state entry and decision after each round.  Returns the
    port's final state."""
    jst, st = jbt.init_state(_jcfg(cfg)), init_state(cfg, device="cpu")
    for r, (blocks, wr, run) in enumerate(rounds):
        jst, jd = jbt.access(jst, jnp.asarray(blocks, jnp.int32),
                             jnp.asarray(wr, bool),
                             jnp.asarray(run, jnp.float32), _jcfg(cfg))
        st, d = access(st, _t(blocks, np.int32), _t(wr, bool),
                       _t(run, np.float32), cfg)
        assert sorted(st) == sorted(jst) and sorted(d) == sorted(jd)
        for k in jst:
            _same(st[k], jst[k], f"round {r} state {k}")
        for k in jd:
            _same(d[k], jd[k], f"round {r} decision {k}")
    return st


def _mix(seed, cfg: TierConfig, n, rounds=ROUNDS):
    """The write-filtering oracle's traffic (tests/test_train_system.py):
    random writes (run 1) in the first quarter of the blocks, then
    sequential reads (run 8) from a random start, ``n`` requests each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        out.append((rng.integers(0, cfg.num_blocks // 4, (n,)),
                    np.ones(n, bool), np.ones(n)))
        out.append(((np.arange(n) + rng.integers(0, cfg.num_blocks * 3 // 4))
                    % cfg.num_blocks, np.zeros(n, bool), np.full(n, 8.0)))
    return out


# ---------------------------------------------------------------------------
# the block table
# ---------------------------------------------------------------------------

def test_init_state_matches():
    cfg = TierConfig()
    st, jst = init_state(cfg, device="cpu"), jbt.init_state(_jcfg(cfg))
    assert sorted(st) == sorted(jst)
    for k in jst:
        _same(st[k], jst[k], k)
    for k in ("meta", "act", "fast_hits", "fills"):
        assert st[k].dtype == torch.int32
    assert st["rng"].dtype == torch.int64


@pytest.mark.parametrize("seed", range(6))
def test_probe_blocks_matches(seed):
    """Seeded tables under the default config (2048 blocks over 256
    slots: 8 a slot, so tags 0-7 fold into two bits)."""
    cfg = TierConfig()
    rng = np.random.default_rng(seed)
    meta = rng.integers(0, 64, (cfg.num_slots,), dtype=np.int32)
    blocks = rng.integers(0, cfg.num_blocks, (1024,), dtype=np.int32)
    st = init_state(cfg, device="cpu")
    st["meta"] = torch.from_numpy(meta)
    jst = {**jbt.init_state(_jcfg(cfg)), "meta": jnp.asarray(meta)}
    got = probe_blocks(st, torch.from_numpy(blocks), cfg)
    want = jbt.probe_blocks(jst, jnp.asarray(blocks), _jcfg(cfg))
    for name, g, w in zip(("hit", "slot", "dirty", "aff"), got, want):
        assert g.dtype == torch.int32
        _same(g, w, name)


def test_two_bit_tags_alias_as_the_reference():
    """Blocks b and b + 4 * num_slots share slot and two-bit tag: both hit
    after b fills, in both packages (a reference quirk kept on purpose)."""
    cfg = TierConfig()
    b = 37
    st = _replay(cfg, [(np.full(64, b), np.ones(64, bool), np.ones(64))])
    jst = {**jbt.init_state(_jcfg(cfg)), "meta": jnp.asarray(st["meta"])}
    probe = np.zeros(1024, np.int32)
    probe[:3] = [b, b + 4 * cfg.num_slots, b + cfg.num_slots]
    got = probe_blocks(st, torch.from_numpy(probe), cfg)[0]
    want = jbt.probe_blocks(jst, jnp.asarray(probe), _jcfg(cfg))[0]
    _same(got, want, "hit")
    assert got[:3].tolist() == [1, 1, 0]


ACCESS_CASES = {           # one table shape: the reference compiles each
    "default": (TierConfig(), 64),
    "levels_8_ema_5pct": (TierConfig(n_levels=8, ema_weight=0.05), 64),
    "no_activation_counter": (
        TierConfig(use_activation_counter=False, n_levels=8), 64),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(ACCESS_CASES))
def test_access_matches_over_rounds(case, seed):
    cfg, n = ACCESS_CASES[case]
    st = _replay(cfg, _mix(seed, cfg, n))
    assert int(st["fills"]) > 0 and int(st["bypasses"]) > 0


def test_access_matches_on_rounding_penalties():
    """Runs of 1-8 blocks (penalties such as 19 / 3 round, so their sum
    depends on its order), mixed writes, rounds of 64 and 5000 requests
    (one level of XLA's 32-wide tree sum, and three with padding), 30
    rounds."""
    cfg = TierConfig()
    rng = np.random.default_rng(21)
    rounds = []
    for r in range(30):
        n = (64, 5000)[r % 2]
        rounds.append((rng.integers(0, cfg.num_blocks, (n,)),
                       rng.random(n) < 0.3,
                       rng.integers(1, 9, (n,)).astype(np.float64)))
    _replay(cfg, rounds)


@pytest.mark.parametrize("seed", range(4))
def test_sum_order_is_the_reference_backends(seed):
    """``_xla_sum`` equals ``jnp.sum`` bit for bit on sums that round."""
    rng = np.random.default_rng(seed)
    for n in rng.integers(1, 40000, 5):
        x = (rng.integers(19, 80, n) / rng.integers(1, 9, n)).astype(
            np.float32)
        _same(block_table._xla_sum(torch.from_numpy(x)),
              jnp.sum(jnp.asarray(x)), f"sum of {n}")


def test_access_matches_at_the_card_phase_size():
    """chip_smoke's table (16 GiB of 2 MiB slots over 64 GiB) and batch
    size (32,768 requests), 3 rounds."""
    cfg = TierConfig(block_bytes=2 << 20, num_slots=8192, num_blocks=32768)
    _replay(cfg, _mix(5, cfg, 32768, rounds=3))


def test_repeated_slot_last_request_wins():
    """Four requests to slot 1, writes at positions 0 and 2: the reference
    reports two fills and leaves the slot empty (the last request, a
    bypassed read, writes back the old word)."""
    cfg = TierConfig(num_slots=4, num_blocks=16)
    st = _replay(cfg, [([1, 5, 9, 13], [1, 0, 1, 0], [1.0] * 4)])
    assert st["meta"].tolist() == [0, 0, 0, 0]
    assert int(st["fills"]) == 2 and int(st["bypasses"]) == 2


def test_repeated_slots_over_rounds():
    """Repeated slots in most rounds (4 requests over 4 slots), mixed
    writes and runs, over 30 rounds."""
    cfg = TierConfig(num_slots=4, num_blocks=16)
    rng = np.random.default_rng(11)
    rounds = [(rng.integers(0, 16, (4,)), rng.random(4) < 0.5,
               rng.choice([1.0, 2.0, 4.0, 8.0], 4)) for _ in range(30)]
    st = _replay(cfg, rounds)
    assert int(st["fast_hits"]) > 0 and int(st["fills"]) > 0


def test_probe_table_limit_is_named():
    """The card stages a table of up to 58,108 lanes in shared memory and
    reads a larger one from device memory (``chip_smoke.py`` holds both
    designs to the CPU path); on the CPU the plain version takes any
    table."""
    assert probe_ops.MAX_LANES == 58108
    cfg = TierConfig(num_slots=probe_ops.MAX_LANES + 1,
                     num_blocks=4 * (probe_ops.MAX_LANES + 1))
    st = init_state(cfg, device="cpu")
    hit = probe_blocks(st, torch.arange(100, dtype=torch.int32), cfg)[0]
    assert int(hit.sum()) == 0


def test_access_matches_past_the_shared_memory_table():
    """131,072 slots, past the 58,108 lanes the card's probe holds in
    shared memory (512 GiB of 2 MiB blocks over 256 GiB of slots): seeded
    ``probe_blocks`` on a filled table, then 2 rounds of the mix, every
    state entry and decision bit-equal."""
    n_slots = 131072
    cfg = TierConfig(block_bytes=2 << 20, num_slots=n_slots,
                     num_blocks=4 * n_slots)
    rng = np.random.default_rng(13)
    meta = rng.integers(0, 64, (n_slots,), dtype=np.int32)
    blocks = rng.integers(0, cfg.num_blocks, (32768,), dtype=np.int32)
    st = {**init_state(cfg, device="cpu"), "meta": torch.from_numpy(meta)}
    jst = {**jbt.init_state(_jcfg(cfg)), "meta": jnp.asarray(meta)}
    got = probe_blocks(st, torch.from_numpy(blocks), cfg)
    want = jbt.probe_blocks(jst, jnp.asarray(blocks), _jcfg(cfg))
    for name, g, w in zip(("hit", "slot", "dirty", "aff"), got, want):
        _same(g, w, name)
    assert 0 < int(got[0].sum()) < blocks.size
    _replay(cfg, _mix(6, cfg, 32768, rounds=1))


# the reference's oracles (tests/test_properties.py: hypothesis there,
# seeds here)

@pytest.mark.parametrize("seed", range(10))
def test_fill_then_probe_hits(seed):
    cfg = TierConfig(num_slots=32, num_blocks=256)
    st = init_state(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    blocks = torch.from_numpy(rng.integers(0, 256, (16,)).astype(np.int32))
    st, d = access(st, blocks, torch.ones(16, dtype=torch.bool),
                   torch.ones(16), cfg)
    hit = probe_blocks(st, blocks, cfg)[0]
    slots = (blocks % cfg.num_slots).tolist()
    for i in range(16):
        later_same_slot = any(slots[j] == slots[i] for j in range(i + 1, 16))
        if bool(d["fill"][i]) and not later_same_slot:
            assert int(hit[i]) == 1


@pytest.mark.parametrize("seed", range(10))
def test_tag_aliasing_never_false_hits(seed):
    cfg = TierConfig(num_slots=16, num_blocks=64)
    st = init_state(cfg, device="cpu")
    b = int(np.random.default_rng(seed).integers(0, 16))
    st, _ = access(st, torch.tensor([b], dtype=torch.int32),
                   torch.ones(1, dtype=torch.bool), torch.ones(1), cfg)
    alias = torch.tensor([b + 16], dtype=torch.int32)   # same slot, tag+1
    assert int(probe_blocks(st, alias, cfg)[0][0]) == 0


def test_block_table_write_filtering():
    """Write-heavy random blocks must fill; streaming reads must bypass."""
    cfg = TierConfig(num_slots=64, num_blocks=512)
    st = init_state(cfg, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(30):
        wr_blocks = _t(rng.integers(0, 128, (32,)), np.int32)
        st, d_wr = access(st, wr_blocks, torch.ones(32, dtype=torch.bool),
                          torch.ones(32), cfg)
        rd_blocks = _t((np.arange(32) + rng.integers(0, 384)) % 512,
                       np.int32)
        st, d_rd = access(st, rd_blocks, torch.zeros(32, dtype=torch.bool),
                          torch.full((32,), 8.0), cfg)
    assert int(st["fills"]) > 0
    assert int(st["bypasses"]) > 0
    assert float(d_rd["bypass"].float().mean()) > \
        float(d_wr["bypass"].float().mean())


# ---------------------------------------------------------------------------
# placement and the streamer
# ---------------------------------------------------------------------------

PLAN_ARCHS = ("qwen2.5-3b", "phi3.5-moe-42b", "zamba2-2.7b")
BUDGETS = ("zero", "third", "opt", "total")


def _nbytes(tree):
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))


@pytest.fixture(scope="module")
def plans():
    """The reference's Placement at each budget, and the port model and
    AdamW state of the same smoke config, per arch."""
    out = {}
    for arch in PLAN_ARCHS:
        jcfg = jax_config(arch, smoke=True)
        jp = jax.eval_shape(lambda k, c=jcfg: jax_init(k, c),
                            jax.random.PRNGKey(0))
        jo = jax.eval_shape(jax_adamw.init, jp)
        total = _nbytes({"p": jp, "o": jo})
        budgets = {"zero": 0, "third": total // 3, "opt": _nbytes(jo),
                   "total": total}
        model = Transformer(get_config(arch, smoke=True), device="cpu")
        opt = adamw.init(dict(model.named_parameters()))
        out[arch] = (model, opt, budgets,
                     {k: jax_plan(jp, jo, b) for k, b in budgets.items()})
    return out


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_plan_placement_matches(plans, arch, budget):
    model, opt, budgets, want = plans[arch]
    got = plan_placement(model, opt, budgets[budget])
    assert got.pinned == want[budget].pinned
    assert got.streamed == want[budget].streamed
    assert (got.fast_bytes, got.slow_bytes) == \
        (want[budget].fast_bytes, want[budget].slow_bytes)
    assert got.fast_bytes <= budgets[budget]


def test_placement_pins_optimizer_state_first(plans):
    model, opt, budgets, _ = plans["qwen2.5-3b"]
    pl = plan_placement(model, opt, budgets["opt"])
    pinned_opt = sum(1 for n in pl.pinned if n.startswith("opt"))
    pinned_par = sum(1 for n in pl.pinned if n.startswith("params"))
    assert pinned_opt > pinned_par


def test_streamer_round_trip_and_bytes_match():
    jcfg = jax_config("qwen2.5-3b", smoke=True)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    jo = jax_adamw.init(jp)
    budget = _nbytes({"p": jp, "o": jo}) // 3
    jws = JaxStreamer(jp, jo, fast_budget_bytes=budget)
    p2, o2 = jws.stage_in(jp, jo)
    jws.flush_out(p2, o2)

    model = Transformer(get_config("qwen2.5-3b", smoke=True), device="cpu")
    opt = adamw.init(dict(model.named_parameters()))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    ws = WeightStreamer(model, opt, fast_budget_bytes=budget)
    assert ws.placement.streamed and ws.placement.pinned
    assert ws.placement.streamed == jws.placement.streamed
    model, opt = ws.stage_in(model, opt)
    for k, v in model.named_parameters():
        assert torch.equal(v, before[k]), k
    ws.flush_out(model, opt)
    assert (ws.bytes_streamed_in, ws.bytes_streamed_out) == \
        (jws.bytes_streamed_in, jws.bytes_streamed_out) != (0, 0)


def test_streamer_binds_and_writes_back():
    """stage_in binds fresh copies of the streamed leaves (parameters and
    optimizer state) that a step's in-place updates reach; flush_out writes
    them back into the host copies and rebinds those."""
    model = Transformer(get_config("qwen2.5-3b", smoke=True), device="cpu")
    opt = adamw.init(dict(model.named_parameters()))
    ws = WeightStreamer(model, opt, fast_budget_bytes=0)
    assert not ws.placement.pinned and "params['embed']['tok']" in \
        ws.placement.streamed
    (host,) = ws.host_views("params['embed']['tok']")
    (host_m,) = ws.host_views("opt['m']['embed']['tok']")
    p = dict(model.named_parameters())["embed.tok"]
    assert p.data.data_ptr() == host.data_ptr()
    model, opt = ws.stage_in(model, opt)
    assert p.data.data_ptr() != host.data_ptr()
    with torch.no_grad():
        p.add_(1.0)
        opt["m"]["embed.tok"].add_(2.0)
    ws.flush_out(model, opt)
    assert p.data.data_ptr() == host.data_ptr()
    assert opt["m"]["embed.tok"].data_ptr() == host_m.data_ptr()
    assert float(host_m.min()) == float(host_m.max()) == 2.0
    n = ws.placement.slow_bytes
    assert (ws.bytes_streamed_in, ws.bytes_streamed_out) == (n, n)


# ---------------------------------------------------------------------------
# the tiered trainer against the reference example
# ---------------------------------------------------------------------------

SMALL = ["--d-model", "64", "--layers", "2", "--vocab", "256", "--steps",
         "3", "--seq", "32", "--batch", "2"]


class _JaxRecorder:
    """``jax`` for the example's namespace: every jitted step's metrics
    are recorded as floats."""

    def __init__(self):
        self.metrics = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        step = jax.jit(fn, **kw)

        def run(*args):
            out = step(*args)
            self.metrics.append({k: float(v) for k, v in out[2].items()})
            return out
        return run


def test_train_tiered_matches_reference_example(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "train_tiered_example", ROOT / "examples" / "train_tiered.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    rec = _JaxRecorder()
    streamers = []

    class Streamer(JaxStreamer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            streamers.append(self)

    def f32_config(arch, smoke=False):
        return dataclasses.replace(jax_config(arch, smoke=smoke),
                                   dtype="float32")

    monkeypatch.setattr(ex, "jax", rec)
    monkeypatch.setattr(ex, "WeightStreamer", Streamer)
    monkeypatch.setattr(ex, "get_config", f32_config)
    monkeypatch.setattr(sys, "argv", ["train_tiered.py"] + SMALL)
    ex.main()
    want_lines = capsys.readouterr().out.splitlines()
    (jws,) = streamers

    cfg = dataclasses.replace(train_tiered.tiered_config(64, 2, 256),
                              dtype="float32")
    jcfg = dataclasses.replace(
        f32_config("granite-8b", smoke=True), name="tiered", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256,
        head_dim=None)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(model_params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), cfg))
    lines = []
    out = train_tiered.run(cfg, model, steps=3, seq=32, batch=2,
                           fast_frac=0.4, log=lines.append)
    ws = out["streamer"]
    np.testing.assert_allclose(out["losses"],
                               [m["loss"] for m in rec.metrics], rtol=1e-4)
    np.testing.assert_allclose(out["grad_norms"],
                               [m["grad_norm"] for m in rec.metrics],
                               rtol=1e-4)
    assert ws.placement.streamed == jws.placement.streamed
    assert (ws.bytes_streamed_in, ws.bytes_streamed_out) == \
        (jws.bytes_streamed_in, jws.bytes_streamed_out)
    assert ws.bytes_streamed_in == 3 * ws.placement.slow_bytes > 0
    # the lines the loss and timing do not enter
    keep = [0, 1, len(want_lines) - 1]
    assert [lines[i] for i in keep] == [want_lines[i] for i in keep]
    assert len(lines) == len(want_lines) == 5


def test_memtier_and_launcher_run_without_jax():
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "import torch",
        "from repro_torch import memtier",
        "from repro_torch.launch import train_tiered",
        "cfg = memtier.TierConfig(num_slots=16, num_blocks=128)",
        "st = memtier.init_state(cfg, device='cpu')",
        "b = torch.arange(40, dtype=torch.int32) * 3 % 128",
        "st, d = memtier.access(st, b, b % 2 == 0, torch.ones(40), cfg)",
        "assert int(st['fills']) > 0",
        "train_tiered.main(['--device', 'cpu', '--d-model', '64',",
        "                   '--layers', '1', '--vocab', '256', '--steps',",
        "                   '2', '--seq', '16', '--batch', '2'])",
        "bad = [m for m in sys.modules if m == 'repro' or",
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]",
        "assert not bad and sys.modules['jax'] is None, bad",
        "print('ok')",
    ])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "ok" and lines[1].startswith("placement: ")
    assert lines[-2].startswith("streamed ")
