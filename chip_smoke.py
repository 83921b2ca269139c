#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (HMS simulator, dense and SSM serving) on
one card.

    python3 chip_smoke.py [--out DIR]

Phases, each printed as one JSON line; any failure exits non-zero:

  1. device  - the card (nvidia-smi name and power limit), torch and CUDA.
  2. build   - nvcc builds every kernel of ``src/repro_torch`` for sm_90a.
  3. kernels - each kernel against its plain PyTorch version on the card,
               on the same inputs, exactly (integer outputs and the
               rounded float64 EMA): amil_probe at 256 and 8192 table
               lanes x 2^20 requests; hms_scan + ema_scan on the golden
               trace under all 8 policies (and 48 CTC ways of 64 and 96 of
               128: two and four a thread in the kernel) and on one
               workload at its full
               default size (there the plain step loop runs once, timed
               and compared).  Each hms_scan row names its domains per
               lane, its longest chain and both bounds (longest chain,
               and one chain per lane).  Times each kernel's wrapper call
               and its plain version, and hms_scan's kernel alone.
  4. sweep   - the 12-point grid of benchmarks/baselines/BENCH_sweep.json
               on its 3 workloads at n = 20000, against the committed
               counters and runtimes (integer-valued counters exactly,
               fractional ones and runtime to rtol 1e-9); S = 4 lanes
               against S = 1; the card against the port's CPU path.  The
               traces are rebuilt with ``make_trace`` and held to the
               baseline's trace fingerprints; where this host's numpy
               draws other random streams, the committed copies in
               ``chip_smoke_traces.npz`` (same fingerprints) are used.
  5. main    - ``simulate`` with the default HMSConfig on every registered
               workload (12 generators + 5 scenarios) at its default size,
               plus zipf at 10^6 requests, through the scan kernels; launch
               counts are reset just before and read just after.  Each of
               the 5 phased scenarios' counters and per-phase counters
               must be bit-identical over its 4 runs and at S = 4 lanes.
  6. serving kernels against their plain versions: flash_attention at the
               serving slice's shape (B 4, S = T = 1024, 16 heads over 2 KV
               heads, hd 128; bf16 and float32, ragged, non-causal, softcap
               30, S = T = 1000, S 512 under T 1024, and the launcher's
               S = T = 11), at zamba2-2.7b's (32 heads, hd 80) and in bf16
               at hd 16, 32 and 64: each row names the design that ran
               (bf16: the wgmma kernel, float32: the FMA kernel) and must be
               the one for its type; paged_attention (page 16, 128 pages per
               sequence, random tables and lengths at both head shapes,
               every length 1 token, every length at a page edge, one
               sequence, and an identity table over a dense cache; bf16 and
               float32), float32 to atol =
               rtol = 1e-4 (another summation order) and bf16 to 2e-2, each
               timed beside its bound and one PyTorch call
               (scaled_dot_product_attention) as a yardstick; ssd_scan
               (y and final state) at mamba2-1.3b's prefill shape (B 4,
               L 1024, H 64, P 64, G 1, N 128, chunk 128) and zamba2's
               (H 80, N 64) in bf16 and float32, ragged L 11 and 130, a
               nonzero initial state, G = 2 and the smoke configs' shape
               (P 16, N 16) (see ``ssd_checks``): bf16 must run the
               tensor-core kernel, float32 the FMA kernel.  Then
               ``repro_torch.launch.serve --arch mamba2-1.3b --smoke`` on
               the card (``smoke_serve``).
  7. serve   - qwen2.5-3b at full width (36 layers, bf16, random weights
               from seed 0) through ``repro_torch.serving.Engine``: (a) the
               launcher's traffic (8 requests of 4-12 tokens, 16 new
               tokens each, ServeConfig defaults) and (b) 4 requests of 1024
               tokens, 32 new each, ServeConfig(max_batch=4, max_len=2048);
               prefill and decode times, tokens/s, peak memory, KV stats,
               and the launches of each kernel against ``path_launches``
               (counts reset just before, read just after: bf16 prefill
               only through the wgmma design and ssd_scan only through the
               tensor-core one, one paged_attention launch per attention
               layer and decode step); a
               torch.profiler window over one prefill and 3 decode steps of
               each gives the device's busy share and its top kernels.
               Then paged_attention on the identity table of (b)'s real
               cache against its plain version and a masked SDPA.  The same
               two mixes then serve mamba2-1.3b (48 layers: 48 ssd_scan
               launches per prefill) and zamba2-2.7b (54 Mamba2 layers and
               9 applications of the shared attention block: 54 ssd_scan
               and 9 flash_attention launches per prefill, 9
               paged_attention per decode step), each freed before the
               next.
  8. serve_card_vs_cpu - cuts at full width, TF32 off for matmuls and
               cuDNN: qwen2.5-3b and mamba2-1.3b at 2 layers, zamba2-2.7b
               at one super-block (6 Mamba2 layers + the shared block).  In
               float32 (all three) the same requests served on the card and
               through the port's CPU path give the same tokens and KV
               stats; in bf16 (qwen2.5-3b, zamba2-2.7b: the card's prefill
               attention is the wgmma kernel) the largest logit difference
               over a prefill and 3 decode steps stays within 2e-2 of the
               logit scale, the CPU tests' bf16 logit tolerance.
  9. the ``kernels`` summary line, then the ``ok`` line.

``--out DIR`` also writes every JSON line to DIR/chip_smoke.jsonl;
``--write-traces`` (no card needed) rewrites
``chip_smoke_traces.npz`` from ``make_trace``, refusing unless every trace
matches its baseline fingerprint.
Needs one CUDA card, nvcc, and this checkout's ``src/`` and
``benchmarks/baselines/``; imports nothing of JAX.  Bounds use the H100
SXM data sheet: 3.35 TB/s, 989 TFLOP/s bf16 (tensor cores), 67 TFLOP/s
float32.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BASELINE = ROOT / "benchmarks" / "baselines" / "BENCH_sweep.json"
TRACES = ROOT / "chip_smoke_traces.npz"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, data sheet
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# bf16 card-vs-CPU logits, as a share of the largest logit: the CPU tests'
# bf16 logit tolerance against JAX (atol = rtol = 2e-2)
BF16_LOGIT_TOL = 2e-2
# how much further from the float32 logits of the same weights the card's
# bf16 logits may lie than the CPU path's bf16 logits: two bf16 paths that
# round in other places land at different distances from float32
BF16_VS_CPU = 1.25
N_LAYERS_FULL = 36               # qwen2.5-3b
STEP_CYCLES = 30                 # one dependent L1/shared-memory round trip
EMA_STEP_CYCLES = 16             # two dependent float64 operations
FRACTIONAL = {"dram_busy", "scm_busy", "dram_acts", "scm_acts",
              "scm_wr_acts"}
GOLDEN_CONFIGS = [
    {},
    {"tag_layout": "tad"},
    {"policy": "no_bypass"},
    {"policy": "no_second_level", "n_levels": 8},
    {"policy": "bear", "scm_mode": "slc"},
    {"policy": "mccache"},
    {"policy": "redcache"},
    {"policy": "no_bypass_no_ctc", "throttle_wr": True},
]
# 48 enabled CTC ways of 64 allocated, and 96 of 128: the scan kernel's rows
# of two and four ways per thread, with disabled ways
WIDE_CTC = [{"ctc_ways": 48, "ctc_fraction": 1.0},
            {"ctc_ways": 96, "ctc_fraction": 1.0}]

_OUT = None
T0 = time.perf_counter()


def emit(obj) -> None:
    line = json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 3)})
    print(line, flush=True)
    if _OUT is not None:
        _OUT.write(line + "\n")
        _OUT.flush()


class SmokeFailure(Exception):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def golden_trace(T, n=6000, footprint=4 * 2**20, seed=7):
    """The reference's golden parity trace (tests/test_engine_parity.py):
    a seeded mix of random and streaming requests with writes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    total = footprint // 32
    col = np.concatenate([
        rng.integers(0, total, size=n // 2),
        (rng.integers(0, total, size=1)[0] + np.arange(n - n // 2)) % total,
    ]).astype(np.int64)
    wr = rng.random(n) < 0.3
    return T.Trace("golden", col, wr, footprint)


def trace_fp(trace) -> str:
    """Content hash of a trace, as the reference's sweep checkpoints and
    BENCH_*.json files compute it (name, length, footprint, phases, the
    request stream)."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    h.update(repr((trace.name, int(trace.n), int(trace.footprint),
                   tuple(trace.phase_names))).encode())
    h.update(np.ascontiguousarray(np.asarray(trace.col, np.int64)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(trace.is_write, np.uint8)).tobytes())
    if trace.phase_id is not None:
        h.update(np.ascontiguousarray(
            np.asarray(trace.phase_id, np.int32)).tobytes())
    return h.hexdigest()[:16]


def baseline_traces(T, base):
    """{workload: (trace, rebuilt)} at the baseline's n: the trace from
    ``make_trace`` when its fingerprint is the baseline's, else the
    committed copy (which must be)."""
    import numpy as np
    out = {}
    saved = None
    for name, entry in base["workloads"].items():
        t = T.make_trace(name, n=base["n"])
        rebuilt = trace_fp(t) == entry["trace_fp"]
        if not rebuilt:
            if saved is None:
                saved = np.load(TRACES)
            n = base["n"]
            t = T.Trace(name, saved[f"{name}_col"].astype(np.int64),
                        np.unpackbits(saved[f"{name}_wr"])[:n].astype(bool),
                        t.footprint)
            need(trace_fp(t) == entry["trace_fp"],
                 f"{name}: committed trace does not match the baseline")
        out[name] = (t, rebuilt)
    return out


def write_traces() -> int:
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as T
    base = json.loads(BASELINE.read_text())
    arrays = {}
    for name, entry in base["workloads"].items():
        t = T.make_trace(name, n=base["n"])
        need(trace_fp(t) == entry["trace_fp"],
             f"{name}: this numpy does not regenerate the baseline trace")
        arrays[f"{name}_col"] = t.col.astype(np.int32)
        arrays[f"{name}_wr"] = np.packbits(t.is_write)
    np.savez_compressed(TRACES, **arrays)
    print(f"wrote {TRACES.name}: {sorted(base['workloads'])}")
    return 0


def event_ms(torch, fn, reps: int = 1, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs, from CUDA events.

    The device is first held in a ~20 ms sleep kernel while the host
    enqueues every run, so each event pair brackets the device work of one
    run and not the host's time to launch it.  ``flush`` (a tensor larger
    than L2) is rewritten before each run, outside the event pair."""
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def same(torch, a, b) -> float:
    """Max |a - b| over tensors that must be equal; raises unless 0."""
    need(a.shape == b.shape and a.dtype == b.dtype,
         f"shape/type differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.dtype.is_floating_point:
        err = float((a - b).abs().max()) if a.numel() else 0.0
    else:
        err = float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    need(torch.equal(a, b), f"kernel and plain version differ (max {err})")
    return err


def counter_diffs(got, ref):
    """Counters that disagree: integer-valued ones exactly, fractional ones
    beyond rtol 1e-9 / atol 1e-6."""
    out = []
    for k in sorted(set(got) | set(ref)):
        g, r = got.get(k), ref.get(k)
        if g is None or r is None:
            ok = False
        elif k in FRACTIONAL:
            ok = math.isclose(g, r, rel_tol=1e-9, abs_tol=1e-6)
        else:
            ok = g == r
        if not ok:
            out.append((k, g, r))
    return out


def compare_counters(got, ref, what: str) -> None:
    bad = counter_diffs(got, ref)
    need(not bad, f"{what}: counters differ {bad[:4]}")


def counter_bits(r) -> dict:
    """The raw float64 bytes of every counter and per-phase counter of a
    SimResult: two runs that must agree bit for bit compare these."""
    import numpy as np
    bits = {k: np.float64(v).tobytes() for k, v in r.counters.items()}
    for k, v in (r.phase_counters or {}).items():
        bits["phase:" + k] = np.asarray(v, np.float64).tobytes()
    return bits


# ---- the scan kernels ---------------------------------------------------------

def plain_scan(scan_ref, s):
    """The plain version of hms_scan on scan inputs ``s`` (the sequential
    walk takes every keyword but the row-group size)."""
    kw = {k: v for k, v in s["scan"].items() if k != "spg"}
    return scan_ref.hms_scan_reference(s["slot"], s["meta"], **kw)


def device_ms(torch, fn, needle: str, reps: int = 3) -> float:
    """Median device time of one launch of the kernel whose name holds
    ``needle``, from torch.profiler over ``reps`` calls of ``fn`` after a
    warm-up: the kernel alone, without the wrapper's checks and copies
    around it (the profiler may miss a launch; each seen one counts)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and needle in e.name]
    need(bool(times), f"the profiler saw no {needle} kernel")
    return statistics.median(times)


def scan_bounds(scan_ops, s, cycle_ms):
    """The scan's plan and bounds on inputs ``s``: the longest (lane,
    domain) chain at STEP_CYCLES a step (the bound), the old one-chain-per-
    lane bound, and the bytes bound (16 B a step: slot, meta, y)."""
    plan = scan_ops.scan_plan(s["slot"], s["meta"], **s["scan"])
    lanes, depth = s["slot"].shape
    chain_ms = plan.longest_chain * STEP_CYCLES * cycle_ms
    bytes_ms = lanes * depth * 16 / HBM_BYTES_PER_S * 1e3
    return {"domains": plan.domains, "longest_chain": plan.longest_chain,
            "bound_ms": max(chain_ms, bytes_ms),
            "bound_by": "operations" if chain_ms >= bytes_ms else "bytes",
            "lane_bound_ms": depth * STEP_CYCLES * cycle_ms,
            "bytes_bound_ms": bytes_ms}


# ---- attention kernels and the serving path --------------------------------

def dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def close(torch, got, want, what: str) -> float:
    """Max |got - want|; raises unless finite and within ATTN_TOL."""
    need(got.shape == want.shape and got.dtype == want.dtype,
         f"{what}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    tol = ATTN_TOL[dtype_name(got.dtype)]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    need(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    need(torch.allclose(g, w, atol=tol, rtol=tol),
         f"{what}: max |kernel - plain| {err} beyond atol = rtol = {tol}")
    return err


def bound(flops: float, nbytes: float, dt):
    """(bound_ms, bound_by): the larger of operations at the type's peak
    and bytes at the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name(dt)] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flash_checks(torch, dev, flush):
    """flash_attention against its plain version; returns the slice row.
    Each row names the design that ran (bf16: the wgmma kernel, float32:
    the FMA kernel), read from the launch counts of its own call."""
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(12)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    qwen = (16, 2, 128)                 # qwen2.5-3b: H, KV, hd
    zamba = (32, 32, 80)                # zamba2-2.7b's shared block
    for case, B, S, T, dt, causal, cap, (H, KV, hd) in (
            ("slice", 4, 1024, 1024, bf16, True, 0.0, qwen),
            ("slice_float32", 4, 1024, 1024, f32, True, 0.0, qwen),
            ("ragged", 2, 130, 200, bf16, True, 0.0, qwen),
            ("non_causal", 4, 1024, 1024, bf16, False, 0.0, qwen),
            ("softcap_30", 4, 1024, 1024, bf16, True, 30.0, qwen),
            ("zamba2_hd80", 4, 1024, 1024, bf16, True, 0.0, zamba),
            ("zamba2_hd80_float32", 4, 1024, 1024, f32, True, 0.0, zamba),
            ("zamba2_hd80_ragged", 4, 11, 11, bf16, True, 0.0, zamba),
            ("hd16", 2, 256, 256, bf16, True, 0.0, (4, 2, 16)),
            ("hd32", 2, 256, 256, bf16, True, 0.0, (4, 2, 32)),
            ("hd64", 2, 256, 256, bf16, True, 0.0, (4, 2, 64)),
            ("edges_1000", 4, 1000, 1000, bf16, True, 0.0, qwen),
            ("right_aligned_512_1024", 4, 512, 1024, bf16, True, 0.0, qwen),
            ("launcher_11", 4, 11, 11, bf16, True, 0.0, qwen)):
        q, k, v = (torch.randn(B, n, h, hd, generator=g, device=dev).to(dt)
                   for n, h in ((S, H), (T, KV), (T, KV)))
        run_k = lambda: ops.flash_attention(q, k, v, causal=causal,
                                            softcap=cap)
        run_p = lambda: ref.flash_attention_reference(q, k, v, causal=causal,
                                                      softcap=cap)
        _build.reset_counts()
        got = run_k()
        designs = [d for d in ("wgmma", "fma")
                   if _build.launches.get(f"flash_attention.{d}")]
        want = run_p()
        torch.cuda.synchronize()
        err = close(torch, got, want, f"flash_attention {case}")
        need(designs == [ops.DESIGNS[dt]], f"flash_attention {case}: ran "
             f"{designs}, expected the {ops.DESIGNS[dt]} kernel for {dt}")
        # (query, key) pairs this run's masks keep
        pairs = sum(min(T, s + T - S + 1) for s in range(S)) if causal \
            else S * T
        bound_ms, bound_by = bound(
            4 * B * H * hd * pairs,
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size(), dt)
        event_ms(torch, run_k, reps=3, flush=flush)         # warm-up
        library_ms = None
        if cap == 0.0:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if S == T or not causal:
                run_l = lambda: sdpa(qt, kt, vt, is_causal=causal,
                                     enable_gqa=True)
            else:                        # SDPA aligns is_causal top-left
                mask = torch.arange(T, device=dev)[None, :] \
                    <= torch.arange(S, device=dev)[:, None] + (T - S)
                run_l = lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                     enable_gqa=True)
            # float32: SDPA with TF32 off for matmuls and cuDNN, as the
            # kernel computes in full float32
            tf32 = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            try:
                event_ms(torch, run_l, reps=3, flush=flush)
                library_ms = event_ms(torch, run_l, reps=20, flush=flush)
            finally:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = tf32
        row = {"name": "flash_attention", "case": case,
               "design": designs[0],
               "shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd},
               "dtype": dtype_name(dt), "causal": causal, "softcap": cap,
               "max_abs_err": err,
               "ms": event_ms(torch, run_k, reps=20, flush=flush),
               "plain_ms": event_ms(torch, run_p, reps=3, flush=flush),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        emit({"phase": "kernel_vs_plain", **row})
        rows[case] = row
    return rows["slice"]


def paged_row(torch, case, q, kp, vp, table, lengths, dense, flush):
    """paged_attention against its plain version on one input set, timed
    beside its bound and a masked SDPA over ``dense`` (k, v) caches."""
    from repro_torch.kernels.paged_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, _, H, hd = q.shape
    page, KV = kp.shape[1], kp.shape[2]
    run_k = lambda: ops.paged_decode_attention(q, kp, vp, table, lengths)
    run_p = lambda: ref.paged_attention_reference(
        q.reshape(B, KV, H // KV, hd), kp, vp, table, lengths).reshape(
            q.shape)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    err = close(torch, got, want, f"paged_attention {case}")
    tokens = int(lengths.sum())
    live_pages = int(((lengths + page - 1) // page).sum())
    bound_ms, bound_by = bound(
        4 * H * hd * tokens,
        2 * tokens * KV * hd * kp.element_size()
        + 2 * q.numel() * q.element_size() + 4 * live_pages + 4 * B, q.dtype)
    kd, vd = (x.transpose(1, 2) for x in dense)
    T = kd.shape[2]
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    run_l = lambda: sdpa(qt, kd, vd, attn_mask=mask, enable_gqa=True)
    lib = run_l()
    torch.cuda.synchronize()
    need(bool(torch.isfinite(lib).all()), f"{case}: SDPA not finite")
    event_ms(torch, run_k, reps=3, flush=flush)             # warm-up
    event_ms(torch, run_l, reps=3, flush=flush)
    row = {"name": "paged_attention", "case": case,
           "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "page": page,
                     "n_pages": table.shape[1], "pool": kp.shape[0]},
           "dtype": dtype_name(q.dtype), "live_tokens": tokens,
           "max_abs_err": err,
           "ms": event_ms(torch, run_k, reps=20, flush=flush),
           "plain_ms": event_ms(torch, run_p, reps=3, flush=flush),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": event_ms(torch, run_l, reps=20, flush=flush)}
    emit({"phase": "kernel_vs_plain", **row})
    return row


def paged_checks(torch, dev, flush) -> None:
    """paged_attention in bf16 and float32 on random block tables and
    lengths at qwen2.5-3b's heads and zamba2-2.7b's (32 over 32, hd 80);
    then at qwen's heads: every length 1 token, every length at a page
    edge, one sequence (B = 1, the splits alone fill the card), and the
    identity table of a dense decode cache (the serving path's view; the
    bf16 one on the served cache follows in ``serving_phases``)."""
    from repro_torch.models import layers
    g = torch.Generator(device=dev).manual_seed(13)
    page, n_pages = 16, 128
    for dt in (torch.bfloat16, torch.float32):
        name = dtype_name(dt)
        for (B, H, KV, hd), kind in (
                ((4, 16, 2, 128), "random_table"),
                ((4, 32, 32, 80), "random_table_hd80"),
                ((4, 16, 2, 128), "length_1"),
                ((4, 16, 2, 128), "page_edge"),
                ((1, 16, 2, 128), "one_sequence")):
            pool = B * n_pages + 16
            q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dt)
            kp, vp = (torch.randn(pool, page, KV, hd, generator=g,
                                  device=dev).to(dt) for _ in range(2))
            table = torch.randint(0, pool, (B, n_pages), generator=g,
                                  device=dev, dtype=torch.int32)
            if kind == "length_1":
                lengths = torch.ones(B, dtype=torch.int32, device=dev)
            elif kind == "page_edge":
                lengths = page * torch.randint(
                    1, n_pages + 1, (B,), generator=g, device=dev,
                    dtype=torch.int32)
            elif kind == "one_sequence":
                lengths = torch.full((B,), 1055, dtype=torch.int32,
                                     device=dev)
            else:
                lengths = torch.randint(1, n_pages * page + 1, (B,),
                                        generator=g, device=dev,
                                        dtype=torch.int32)
            dense = tuple(x[table.long()].reshape(B, n_pages * page, KV, hd)
                          for x in (kp, vp))
            paged_row(torch, f"{kind}_{name}", q, kp, vp, table, lengths,
                      dense, flush)
        # identity table over a dense (B, max_len, KV, hd) cache
        B, H, KV, hd, max_len = 4, 16, 2, 128, 2048
        kc, vc = (torch.randn(B, max_len, KV, hd, generator=g,
                              device=dev).to(dt) for _ in range(2))
        table, lengths = layers.decode_pages(B, max_len, 1054, dev)
        pool = (B * max_len // layers.DECODE_PAGE, layers.DECODE_PAGE, KV, hd)
        q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dt)
        paged_row(torch, f"identity_table_{name}", q, kc.view(pool),
                  vc.view(pool), table, lengths, (kc, vc), flush)


def ssd_bound(x, B, l, chunk, has_init):
    """(flops, bytes) one SSD scan needs: the causal half of each chunk's
    (C B^T) X product and its scores over the positions < l, the
    inter-chunk term and the state update per position; x read and y
    written once, dt read, B and C read once per group (not per head), the
    final state written and the initial state read."""
    b, _, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pairs = 0
    for c0 in range(0, l, chunk):
        v = min(chunk, l - c0)
        pairs += v * (v + 1) // 2
    flops = 2 * b * h * (pairs * (n + p) + 2 * l * n * p)
    nbytes = (2 * b * l * h * p * x.element_size() + 4 * b * l * h
              + 2 * b * l * g * n * B.element_size()
              + 4 * b * h * p * n * (2 if has_init else 1))
    return flops, nbytes


def ssd_checks(torch, dev, flush):
    """ssd_scan against its plain version (y and the final state) at the
    serving shapes: float32 y and states to atol = rtol = 3e-4 (the
    reference's own Pallas-vs-oracle tolerance: 128- to 256-term float32
    sums in another order), bf16 y to 2e-2 (both round one float32 value
    to bf16; they differ where that value straddles a rounding step).  B
    and C are column slices of one (b, l, 2gn) projection, as the model
    hands them over.  Each row names the design that ran (bf16: the
    tensor-core kernel, float32: the FMA kernel, from the launch counts)
    and its CTAs per SM.  Returns the mamba2 bf16 row."""
    from repro_torch import _build
    from repro_torch.kernels.ssd_scan import ops, ref
    g = torch.Generator(device=dev).manual_seed(15)
    bf16, f32 = torch.bfloat16, torch.float32
    mamba = (64, 1, 128, 64)            # H, G, n, p of mamba2-1.3b
    zamba = (80, 1, 64, 64)             # of zamba2-2.7b
    smoke = (8, 1, 16, 16)              # of both smoke configs
    rows = {}
    for case, b, l, (h, G, n, p), dt_, init in (
            ("mamba2", 4, 1024, mamba, bf16, False),
            ("mamba2_float32", 4, 1024, mamba, f32, False),
            ("zamba2", 4, 1024, zamba, bf16, False),
            ("zamba2_float32", 4, 1024, zamba, f32, False),
            ("ragged_11", 4, 11, mamba, bf16, False),
            ("ragged_130", 4, 130, zamba, bf16, False),
            ("initial_state", 4, 1024, mamba, bf16, True),
            ("initial_state_float32", 2, 300, zamba, f32, True),
            ("groups_2", 2, 512, (64, 2, 128, 64), bf16, False),
            ("smoke", 4, 1024, smoke, bf16, False),
            ("smoke_float32", 4, 1024, smoke, f32, False),
            ("smoke_ragged_initial_state", 2, 200, smoke, bf16, True)):
        chunk = 128
        x = (torch.randn(b, l, h, p, generator=g, device=dev) * 0.5).to(dt_)
        dt = torch.rand(b, l, h, generator=g, device=dev) * 0.5 + 0.1
        A = -(torch.rand(h, generator=g, device=dev) * 0.5 + 0.5)
        bc = (torch.randn(b, l, 2 * G * n, generator=g, device=dev)
              * 0.3).to(dt_)
        Bm = bc[..., :G * n].reshape(b, l, G, n)
        Cm = bc[..., G * n:].reshape(b, l, G, n)
        s0 = (torch.randn(b, h, p, n, generator=g, device=dev) * 0.5) \
            if init else None
        run_k = lambda: ops.ssd(x, dt, A, Bm, Cm, chunk, initial_state=s0)
        run_p = lambda: ref.ssd_plain(x, dt, A, Bm, Cm, chunk,
                                      initial_state=s0)
        _build.reset_counts()
        (y, st), (yw, sw) = run_k(), run_p()
        torch.cuda.synchronize()
        design = [k.split(".")[1] for k, v in _build.launches.items()
                  if k.startswith("ssd_scan.") and v]
        want = "mma" if dt_ == bf16 else "fma"
        need(design == [want], f"ssd {case}: ran {design}, not {want}")
        tol = 2e-2 if dt_ == bf16 else 3e-4
        need(y.shape == yw.shape and y.dtype == yw.dtype, f"ssd {case}: y")
        need(bool(torch.isfinite(y.float()).all())
             and bool(torch.isfinite(st).all()), f"ssd {case}: not finite")
        err = float((y.float() - yw.float()).abs().max())
        serr = float((st - sw).abs().max())
        need(torch.allclose(y.float(), yw.float(), atol=tol, rtol=tol),
             f"ssd {case}: max |y - plain| {err} beyond {tol}")
        need(torch.allclose(st, sw, atol=3e-4, rtol=3e-4),
             f"ssd {case}: max |state - plain| {serr} beyond 3e-4")
        flops, nbytes = ssd_bound(x, Bm, l, chunk, init)
        t_ops = flops / PEAK_FLOPS[dtype_name(dt_)] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        event_ms(torch, run_k, reps=3, flush=flush)          # warm-up
        row = {"name": "ssd_scan", "case": case,
               "shape": {"b": b, "l": l, "h": h, "p": p, "g": G, "n": n,
                         "chunk": chunk},
               "dtype": dtype_name(dt_), "initial_state": init,
               "design": want,
               "blocks_per_sm": ops.blocks_per_sm(p, n, chunk, dt_),
               "max_abs_err": max(err, serr), "y_max_abs_err": err,
               "state_max_abs_err": serr,
               "y_scale": float(yw.float().abs().max()),
               "ms": event_ms(torch, run_k, reps=20, flush=flush),
               "plain_ms": event_ms(torch, run_p, reps=3, flush=flush),
               "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None}
        emit({"phase": "kernel_vs_plain", **row})
        rows[case] = row
    return rows["mamba2"]


class StepClock:
    """Wraps the engine's prefill/decode_step: device-synchronized wall
    time per call, finiteness of every logit, and the last cache."""

    def __init__(self, torch, engine_module):
        self.torch, self.mod = torch, engine_module
        self.prefill, self.decode = [], []
        self.finite, self.cache = True, None

    def _wrap(self, fn, bucket):
        torch = self.torch

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kw)
            torch.cuda.synchronize()
            bucket.append(time.perf_counter() - t0)
            self.finite &= bool(torch.isfinite(logits).all())
            self.cache = cache
            return logits, cache
        return run

    def __enter__(self):
        self._orig = (self.mod.prefill, self.mod.decode_step)
        self.mod.prefill = self._wrap(self._orig[0], self.prefill)
        self.mod.decode_step = self._wrap(self._orig[1], self.decode)
        return self

    def __exit__(self, *exc):
        self.mod.prefill, self.mod.decode_step = self._orig


def path_launches(cfg):
    """Kernel launches of one prefill and of one decode step: every
    attention layer runs flash_attention in prefill (bf16 through the
    wgmma kernel only, float32 through the FMA kernel only: the
    ``flash_attention.<design>`` counts) and paged_attention, one launch,
    in decode; every Mamba2 layer runs ssd_scan in prefill (bf16 through
    the tensor-core kernel only, float32 through the FMA kernel only: the
    ``ssd_scan.<design>`` counts; its decode step is plain torch ops); the
    hybrid applies its shared attention block after every ``attn_every``
    Mamba2 layers."""
    L = cfg.n_layers
    bf16 = cfg.dtype == "bfloat16"
    design = "flash_attention." + ("wgmma" if bf16 else "fma")
    ssd = {"ssd_scan": L, "ssd_scan." + ("mma" if bf16 else "fma"): L}
    if cfg.family == "dense":
        return {"flash_attention": L, design: L}, {"paged_attention": L}
    if cfg.family == "ssm":
        return ssd, {}
    n_attn = L // cfg.attn_every
    return {**ssd, "flash_attention": n_attn, design: n_attn}, \
        {"paged_attention": n_attn}


def launcher_traffic(Request, vocab):
    """What ``python -m repro_torch.launch.serve --requests 8 --max-new 16``
    submits."""
    from repro_torch.launch.serve import requests
    return requests(Request, vocab, 8, 16)


def long_traffic(Request, vocab):
    import numpy as np
    rng = np.random.default_rng(1)
    return [Request(rid, rng.integers(1, vocab, size=1024).astype(np.int32),
                    max_new=32) for rid in range(4)]


def serve(torch, dev, model, cfg, scfg, traffic, name):
    """One warm-up and one measured ``Engine.run``; emits the serve line and
    returns (row, clock, outputs)."""
    from repro_torch import _build
    from repro_torch.serving import Engine, Request
    from repro_torch.serving import engine as engine_mod
    eng = Engine(cfg, model, scfg, device=dev)              # warm-up
    for r in traffic(Request, cfg.vocab):
        eng.submit(r)
    eng.run()
    reqs = traffic(Request, cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    with StepClock(torch, engine_mod) as clock:
        t0 = time.perf_counter()
        eng = Engine(cfg, model, scfg, device=dev)
        for r in reqs:
            eng.submit(r)
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    need(sorted(outs) == [r.rid for r in reqs], f"{name}: requests lost")
    need(all(len(outs[r.rid]) == r.max_new for r in reqs),
         f"{name}: wrong number of generated tokens")
    need(clock.finite, f"{name}: non-finite logits")
    per_prefill, per_decode = path_launches(cfg)
    for k in sorted(set(per_prefill) | set(per_decode) | set(launches)):
        want = per_prefill.get(k, 0) * len(clock.prefill) \
            + per_decode.get(k, 0) * len(clock.decode)
        need(launches.get(k, 0) == want,
             f"{name}: {k} launched {launches.get(k, 0)} times, expected "
             f"{want} for {len(clock.prefill)} prefills and "
             f"{len(clock.decode)} decode steps")
    generated = sum(len(v) for v in outs.values())
    row = {"phase": "serve", "traffic": name, "model": cfg.name,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "requests": len(reqs),
           "prompt_tokens": [int(r.prompt.shape[0]) for r in reqs],
           "max_new": max(r.max_new for r in reqs),
           "serve_config": {"max_batch": scfg.max_batch,
                            "max_len": scfg.max_len,
                            "page_size": scfg.page_size,
                            "fast_pages": scfg.fast_pages},
           "prefill_ms": [t * 1e3 for t in clock.prefill],
           "decode_steps": len(clock.decode),
           "decode_ms_per_step_median": statistics.median(clock.decode) * 1e3,
           "decode_ms_per_step_mean": statistics.mean(clock.decode) * 1e3,
           "wall_s": wall, "generated_tokens": generated,
           "tokens_per_s": generated / wall,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "kv_stats": eng.kv_stats, "launches": launches,
           "logits_finite": clock.finite}
    emit(row)
    return row, clock, outs


def kernel_ms(torch, prof):
    """{kernel name: device ms} summed over a profiler window."""
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return kernels


def kernel_count(torch, prof, needle: str) -> int:
    """Device kernels in a profiler window whose name holds ``needle``."""
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and needle in e.name)


def decode_profile(torch, dev, model, cfg, scfg, traffic, name, steps=3):
    """torch.profiler over one prefill and then ``steps`` decode steps of
    the traffic's first batch: wall time, device (kernel) time, the
    device's busy share, and the kernels that take the most of it.  Device
    time is None when the profiler records no kernel on this machine."""
    import numpy as np
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import Request
    reqs = traffic(Request, cfg.vocab)[:scfg.max_batch]
    S = max(r.prompt.shape[0] for r in reqs)
    toks = np.zeros((len(reqs), S), np.int32)
    for i, r in enumerate(reqs):
        toks[i, S - r.prompt.shape[0]:] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    prefill(model, batch, cfg, max_len=scfg.max_len)            # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as pprof:
        t0 = time.perf_counter()
        logits, cache = prefill(model, batch, cfg, max_len=scfg.max_len)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    pkern = kernel_ms(torch, pprof)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    logits, cache = decode_step(model, tok, cache, S, cfg)       # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for pos in range(S + 1, S + 1 + steps):
            logits, cache = decode_step(model, tok, cache, pos, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = kernel_ms(torch, prof)
    device_ms = sum(kernels.values()) if kernels else None
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    cpu_ops = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::"))
    pdev = sum(pkern.values()) if pkern else None
    # the device's own count of the attention kernels, where the profiler
    # saw kernels at all: prefill through the design of the model's type
    # only, decode through one paged kernel per attention layer and step
    per_prefill, per_decode = path_launches(cfg)
    counts = {"prefill_flash_wgmma": kernel_count(torch, pprof,
                                                  "flash_wgmma_kernel"),
              "prefill_flash_fma": kernel_count(torch, pprof,
                                                "flash_kernel"),
              "prefill_ssd_mma": kernel_count(torch, pprof, "ssd_mma_kernel"),
              "prefill_ssd_fma": kernel_count(torch, pprof, "ssd_fma_kernel"),
              "decode_paged": kernel_count(torch, prof, "paged_kernel")}
    want = {"prefill_flash_wgmma": per_prefill.get("flash_attention.wgmma",
                                                   0),
            "prefill_flash_fma": per_prefill.get("flash_attention.fma", 0),
            "prefill_ssd_mma": per_prefill.get("ssd_scan.mma", 0),
            "prefill_ssd_fma": per_prefill.get("ssd_scan.fma", 0),
            "decode_paged": per_decode.get("paged_attention", 0) * steps}
    for k in counts:
        seen = pkern if k.startswith("prefill") else kernels
        need(not seen or counts[k] == want[k],
             f"{cfg.name} {name}: {k} {counts[k]} device kernels, expected "
             f"{want[k]}")
    row = {"phase": "decode_profile", "model": cfg.name, "traffic": name,
           "device_kernel_counts": counts,
           "prefill_wall_ms": pwall * 1e3, "prefill_device_ms": pdev,
           "prefill_top_kernels_ms": [
               (k[:60], v) for k, v in sorted(pkern.items(),
                                              key=lambda kv: -kv[1])[:8]],
           "steps": steps,
           "batch": len(reqs), "wall_ms_per_step": wall * 1e3 / steps,
           "device_ms_per_step": None if device_ms is None
           else device_ms / steps,
           "device_busy_share": None if device_ms is None
           else device_ms / (wall * 1e3),
           "aten_ops_per_step": cpu_ops / steps,
           "top_kernels_ms_per_step": [(k[:60], v / steps) for k, v in top]}
    emit(row)
    return row


class plain_kernels:
    """Within it, the models call the plain versions of the attention and
    SSD kernels (on any device) instead of the kernels."""

    def __init__(self, torch):
        from repro_torch.kernels.flash_attention import ref as flash_ref
        from repro_torch.kernels.paged_attention import ref as paged_ref
        from repro_torch.kernels.ssd_scan import ref as ssd_ref
        from repro_torch.models import layers, mamba2

        def paged(q, kp, vp, table, lengths, softcap=0.0):
            B, _, H, hd = q.shape
            return paged_ref.paged_attention_reference(
                q.reshape(B, kp.shape[2], H // kp.shape[2], hd), kp, vp,
                table, lengths, softcap=softcap).reshape(q.shape)
        self.swaps = [(layers, "flash_attention",
                       flash_ref.flash_attention_reference),
                      (layers, "paged_decode_attention", paged),
                      (mamba2, "ssd", ssd_ref.ssd_plain)]

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n, _ in self.swaps]
        for m, n, f in self.swaps:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for (m, n, _), f in zip(self.swaps, self.saved):
            setattr(m, n, f)


def logit_run(torch, model, cfg, where, toks, feed=None):
    """Logits of one prefill of ``toks`` and three decode steps, each fed
    the given tokens (or the run's own argmax); returns (logits on the
    CPU in float32, the tokens fed)."""
    from repro_torch.models import decode_step, prefill
    logits, cache = prefill(model, {"tokens": toks.to(where)}, cfg,
                            max_len=32)
    outs, fed = [logits.float().cpu()], []
    for i, pos in enumerate(range(12, 15)):
        tok = feed[i] if feed is not None else \
            outs[-1].argmax(-1, keepdim=True).to(torch.int32)
        fed.append(tok)
        logits, cache = decode_step(model, tok.to(where), cache, pos, cfg)
        outs.append(logits.float().cpu())
    return outs, fed


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def serve_card_vs_cpu(torch, dev, arch: str, n_layers: int,
                      dtype: str = "float32") -> dict:
    """``arch`` at full width cut to ``n_layers``, TF32 off for matmuls and
    cuDNN: the card against the port's CPU path on the same weights, the
    logits of a prefill and 3 decode steps fed the same tokens.  float32:
    the launcher's requests served on both give the same tokens and KV
    stats.  bf16 (the
    card's prefill attention is the wgmma kernel): the largest logit
    difference within BF16_LOGIT_TOL of the logit scale wherever bf16
    itself allows it, i.e. wherever the CPU path's bf16 logits stay that
    close to its float32 logits of the same weights; and always the card's
    bf16 logits no further than BF16_VS_CPU times the CPU path's from those
    float32 logits.  The card with the plain versions in place of its
    kernels is shown beside it."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.serving import Engine, Request, ServeConfig
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype=dtype)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = Transformer(cfg, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        host = copy.deepcopy(card).to("cpu")
        outs, stats = [], []
        for model, where in ((card, dev), (host, "cpu")):
            if dtype != "float32":
                break                   # bf16 tokens may differ: not served
            eng = Engine(cfg, model, ServeConfig(), device=where)
            for r in launcher_traffic(Request, cfg.vocab):
                eng.submit(r)
            outs.append(eng.run())
            stats.append(eng.kv_stats)
        toks = torch.randint(1, cfg.vocab, (4, 12), generator=torch.Generator(
        ).manual_seed(2), dtype=torch.int32)
        lh, feed = logit_run(torch, host, cfg, "cpu", toks)
        lc, _ = logit_run(torch, card, cfg, dev, toks, feed)
        diff, scale = max_diff(lc, lh), float(lh[-1].abs().max())
        extra = {}
        if dtype != "float32":
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            l32, _ = logit_run(torch, copy.deepcopy(host).float(), cfg32,
                               "cpu", toks, feed)
            with plain_kernels(torch):
                lp, _ = logit_run(torch, card, cfg, dev, toks, feed)
            extra = {"card_vs_float32": max_diff(lc, l32),
                     "cpu_vs_float32": max_diff(lh, l32),
                     "card_plain_vs_cpu": max_diff(lp, lh)}
        del card, host
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    row = {"phase": "serve_card_vs_cpu", "model": cfg.name,
           "family": cfg.family, "n_layers": n_layers,
           "dtype": dtype, "allow_tf32": False,
           "max_logit_diff": diff, "logit_scale": scale, **extra}
    if dtype == "float32":
        same_tokens = sorted(outs[0]) == sorted(outs[1]) and all(
            (outs[0][k] == outs[1][k]).all() for k in outs[0])
        row.update(requests=len(outs[0]), tokens_equal=bool(same_tokens),
                   kv_stats_equal=stats[0] == stats[1], kv_stats=stats[0])
        emit(row)
        need(same_tokens, f"{cfg.name}: card and CPU generate different "
             f"tokens (max logit difference {diff} over logits up to "
             f"{scale})")
        need(stats[0] == stats[1], f"{cfg.name}: KV stats differ: {stats}")
        return row
    tol = BF16_LOGIT_TOL * scale
    row["logit_tol"] = tol
    row["logit_tol_applies"] = extra["cpu_vs_float32"] <= tol
    emit(row)
    need(not row["logit_tol_applies"] or diff <= tol,
         f"{cfg.name} bf16: max logit difference {diff} beyond "
         f"{BF16_LOGIT_TOL} of the logit scale {scale}")
    need(extra["card_vs_float32"] <= BF16_VS_CPU * extra["cpu_vs_float32"],
         f"{cfg.name} bf16: the card's logits are {extra['card_vs_float32']}"
         f" from the float32 run, the CPU path's "
         f"{extra['cpu_vs_float32']}")
    return row


def smoke_serve(torch) -> dict:
    """``python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke`` in
    this process, on the card and then with ``--device cpu``: every request
    gets its tokens, and the card's prefills run the smoke config's head
    dim 16 and state 16 through the tensor-core ssd_scan, one launch per
    Mamba2 layer.  Whether the card's tokens equal the CPU path's is
    recorded, not required (bf16 may round an argmax either way)."""
    import contextlib
    import io
    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    cfg = get_config("mamba2-1.3b", smoke=True)
    n_req, max_new = 4, 8
    lines, launches = {}, {}
    for device in ("cuda", "cpu"):
        out = io.StringIO()
        _build.reset_counts()
        with contextlib.redirect_stdout(out):
            launcher.main(["--arch", "mamba2-1.3b", "--smoke", "--requests",
                           str(n_req), "--max-new", str(max_new), "--device",
                           device])
        if device == "cuda":
            torch.cuda.synchronize()
            launches = dict(_build.launches)
        lines[device] = [ln for ln in out.getvalue().splitlines()
                         if ln.startswith("req ")]
    toks = [json.loads(ln.split(": ", 1)[1]) for ln in lines["cuda"]]
    need(len(toks) == n_req and all(len(t) == max_new for t in toks),
         f"serve --smoke: {lines['cuda']}")
    ssd = launches.get("ssd_scan", 0)
    need(ssd > 0 and ssd % cfg.n_layers == 0
         and launches.get("ssd_scan.mma", 0) == ssd,
         f"serve --smoke: ssd_scan launches {launches}")
    row = {"phase": "serve_smoke", "model": cfg.name, "dtype": cfg.dtype,
           "ssm_head_dim": cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
           "requests": n_req, "max_new": max_new, "launches": launches,
           "tokens_equal_cpu": lines["cuda"] == lines["cpu"]}
    emit(row)
    return row


def serving_phases(torch, dev, flush):
    """Phases 7 and 8; returns the summary rows of the two attention
    kernels with their launches on the serving path."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, layers
    from repro_torch.serving import ServeConfig
    cfg = get_config("qwen2.5-3b")
    need(cfg.n_layers == N_LAYERS_FULL, "qwen2.5-3b is not 36 layers")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    emit({"phase": "serve_model", "model": cfg.name,
          "params": sum(p.numel() for p in model.parameters()),
          "param_bytes": sum(p.numel() * p.element_size()
                             for p in model.parameters()),
          "init_s": time.perf_counter() - t0})
    total = {}
    a, _, _ = serve(torch, dev, model, cfg, ServeConfig(), launcher_traffic,
                    "launcher")
    b, clock, _ = serve(torch, dev, model, cfg,
                        ServeConfig(max_batch=4, max_len=2048), long_traffic,
                        "long_1024")
    decode_profile(torch, dev, model, cfg, ServeConfig(), launcher_traffic,
                   "launcher")
    decode_profile(torch, dev, model, cfg,
                   ServeConfig(max_batch=4, max_len=2048), long_traffic,
                   "long_1024")
    for row in (a, b):
        for k, n in row["launches"].items():
            total[k] = total.get(k, 0) + n
    # paged_attention on the identity table of (b)'s real cache: layer 0,
    # every row at its last decode position
    kc, vc = clock.cache["kv"]["k"][0], clock.cache["kv"]["v"][0]
    B, max_len, KV, hd = kc.shape
    pos = 1024 + 32 - 2                      # last write of 31 decode steps
    table, lengths = layers.decode_pages(B, max_len, pos, dev)
    pool = (B * max_len // layers.DECODE_PAGE, layers.DECODE_PAGE, KV, hd)
    q = torch.randn(B, 1, cfg.n_heads, hd, generator=torch.Generator(
        device=dev).manual_seed(14), device=dev).to(kc.dtype)
    paged = paged_row(torch, "identity_table_serve_cache", q, kc.view(pool),
                      vc.view(pool), table, lengths, (kc, vc), flush)
    del model, clock
    torch.cuda.empty_cache()
    serve_card_vs_cpu(torch, dev, "qwen2.5-3b", 2)
    serve_card_vs_cpu(torch, dev, "qwen2.5-3b", 2, "bfloat16")
    return paged, total


def ssm_serving_phases(torch, dev):
    """mamba2-1.3b (48 Mamba2 layers) and zamba2-2.7b (54 Mamba2 layers and
    one shared attention block after every 6th) at full width, bf16,
    random weights from seed 0, on the two mixes that serve qwen2.5-3b;
    each model is freed before the next is made.  Then the float32 cuts on
    card and CPU: 2 layers of mamba2, one super-block (6 + shared) of
    zamba2.  Returns the launches of the serving runs, summed."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeConfig
    total = {}
    for arch, n_layers in (("mamba2-1.3b", 48), ("zamba2-2.7b", 54)):
        cfg = get_config(arch)
        need(cfg.n_layers == n_layers, f"{arch} is not {n_layers} layers")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = Transformer(cfg, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        emit({"phase": "serve_model", "model": cfg.name,
              "params": sum(p.numel() for p in model.parameters()),
              "param_bytes": sum(p.numel() * p.element_size()
                                 for p in model.parameters()),
              "init_s": time.perf_counter() - t0})
        for scfg, traffic, name in (
                (ServeConfig(), launcher_traffic, "launcher"),
                (ServeConfig(max_batch=4, max_len=2048), long_traffic,
                 "long_1024")):
            row, clock, _ = serve(torch, dev, model, cfg, scfg, traffic,
                                  name)
            for k, n in row["launches"].items():
                total[k] = total.get(k, 0) + n
            del clock
            decode_profile(torch, dev, model, cfg, scfg, traffic, name)
        del model
        torch.cuda.empty_cache()
    serve_card_vs_cpu(torch, dev, "mamba2-1.3b", 2)
    super_block = get_config("zamba2-2.7b").attn_every
    serve_card_vs_cpu(torch, dev, "zamba2-2.7b", super_block)
    serve_card_vs_cpu(torch, dev, "zamba2-2.7b", super_block, "bfloat16")
    return total


def main(argv=None) -> int:
    global _OUT
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--write-traces", action="store_true")
    args = ap.parse_args(argv)
    if args.write_traces:
        return write_traces()

    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this check "
                           "needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as T
    from repro_torch import _build
    from repro_torch.core import simulator as sim
    from repro_torch.kernels.amil_probe import ops as probe_ops
    from repro_torch.kernels.amil_probe.ref import amil_probe_reference
    from repro_torch.kernels.hms_scan import ops as scan_ops
    from repro_torch.kernels.hms_scan import ref as scan_ref

    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        _OUT = open(Path(args.out) / "chip_smoke.jsonl", "w")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------------
    card = smi("name,power.limit")
    print(card, flush=True)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sm_clock_max_mhz": sm_mhz,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "numpy": __import__("numpy").__version__,
          "python": sys.version.split()[0]})
    cycle_ms = 1e3 / (sm_mhz * 1e6)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in str(_build.build_info.get("log", ""))
             .splitlines() if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "nvcc_s": _build.build_info.get("seconds"),
          "sources": _build.build_info.get("sources"), "ptxas": ptxas})

    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
    summary = {}

    # ---- 3. kernels against their plain versions --------------------------
    for n_slots, seed in ((256, 1), (8192, 2)):
        n_req = 1 << 20
        g = torch.Generator(device=dev).manual_seed(seed)
        meta = torch.randint(0, 64, (n_slots,), generator=g, device=dev,
                             dtype=torch.int32)
        slots = torch.randint(0, n_slots, (n_req,), generator=g, device=dev,
                              dtype=torch.int32)
        tags = torch.randint(0, 4, (n_req,), generator=g, device=dev,
                             dtype=torch.int32)
        got = probe_ops.amil_probe(meta, slots, tags)
        want = amil_probe_reference(meta, slots, tags)
        torch.cuda.synchronize()
        err = max(same(torch, a, b) for a, b in zip(got, want))
        run = lambda: probe_ops.amil_probe(meta, slots, tags)
        event_ms(torch, run, reps=5, flush=flush)          # warm-up
        ms = event_ms(torch, run, reps=20, flush=flush)
        plain_ms = event_ms(
            torch, lambda: amil_probe_reference(meta, slots, tags), reps=5,
            flush=flush)
        bytes_moved = 20 * n_req + 4 * n_slots
        row = {"name": "amil_probe", "table_lanes": n_slots,
               "requests": n_req, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms,
               "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": None,
               "hit_rate": float(got[0].float().mean())}
        emit({"phase": "kernel_vs_plain", **row})
        summary["amil_probe"] = row                # the 8192-lane case

    for kw in GOLDEN_CONFIGS + WIDE_CTC:
        t = golden_trace(T)
        cfg = T.HMSConfig(footprint=t.footprint, **kw).validate()
        s = sim.scan_inputs(t, cfg, dev)
        want = plain_scan(scan_ref, s)
        got = scan_ops.hms_scan(s["slot"], s["meta"], **s["scan"])
        err = max(same(torch, a, b) for a, b in zip(got, want))
        pen = s["derived"]["pen64"]
        w = float(s["params"]["ema_weight"])
        ema_err = same(torch, scan_ops.ema_scan(pen, w),
                       scan_ref.ema_scan_reference(pen, w))
        need(int((got[0] & 1).sum()) > 0, "golden trace never hits")
        emit({"phase": "kernel_vs_plain", "name": "hms_scan+ema_scan",
              "trace": "golden", "config": kw, "depth": s["slot"].shape[1],
              **scan_bounds(scan_ops, s, cycle_ms),
              "max_abs_err": err, "ema_max_abs_err": ema_err,
              "hits": int((got[0] & 1).sum())})

    # one workload at the main path's full default size
    t = T.make_trace("pathfnd")
    cfg = T.HMSConfig(footprint=t.footprint).validate()
    s = sim.scan_inputs(t, cfg, dev)
    depth = s["slot"].shape[1]
    run_k = lambda: scan_ops.hms_scan(s["slot"], s["meta"], **s["scan"])
    run_p = lambda: plain_scan(scan_ref, s)
    got = run_k()
    # the plain step loop takes minutes at this size: its one run is both
    # timed and compared
    plain = []
    plain_ms = event_ms(torch, lambda: plain.append(run_p()), reps=1)
    err = max(same(torch, a, b) for a, b in zip(got, plain[0]))
    # ms: the wrapper's call (plan, chain sort, kernel, scatter back), as
    # a caller sees it; kernel_ms: the kernel alone
    ms = event_ms(torch, run_k, reps=3, flush=flush)
    kernel_ms = device_ms(torch, run_k, "hms_chain_kernel")
    bounds = scan_bounds(scan_ops, s, cycle_ms)
    summary["hms_scan"] = {
        "name": "hms_scan", "trace": t.name, "depth": depth, **bounds,
        "max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "ns_per_chain_step": kernel_ms * 1e6 / bounds["longest_chain"],
        "library_ms": None}
    emit({"phase": "kernel_vs_plain", **summary["hms_scan"]})
    pen = s["derived"]["pen64"]
    w = float(s["params"]["ema_weight"])
    plain = []
    plain_ms = event_ms(
        torch, lambda: plain.append(scan_ref.ema_scan_reference(pen, w)))
    err = same(torch, scan_ops.ema_scan(pen, w), plain[0])
    # the wrapper launches nothing but the kernel: its events time it
    ms = event_ms(torch, lambda: scan_ops.ema_scan(pen, w), reps=3,
                  flush=flush)
    summary["ema_scan"] = {
        "name": "ema_scan", "trace": t.name, "depth": pen.shape[0],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": pen.shape[0] * EMA_STEP_CYCLES * cycle_ms,
        "bytes_bound_ms": pen.shape[0] * 16 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "operations", "library_ms": None}
    emit({"phase": "kernel_vs_plain", **summary["ema_scan"]})

    # ---- 4. the committed sweep baseline ----------------------------------
    base = json.loads(BASELINE.read_text())
    mismatches = []
    n_points = 0
    traces = baseline_traces(T, base)
    for w_name, entry in base["workloads"].items():
        t = traces[w_name][0]
        for i, kw in enumerate(base["grid"]):
            r = T.simulate(t, T.HMSConfig(footprint=t.footprint, **kw))
            try:
                compare_counters(r.counters, entry["point_counters"][i],
                                 f"{w_name} {kw}")
                rt = entry["point_runtime_cycles"][i]
                need(math.isclose(r.runtime_cycles, rt, rel_tol=1e-9),
                     f"{w_name} {kw}: runtime {r.runtime_cycles!r} vs {rt!r}")
            except SmokeFailure as e:
                mismatches.append(str(e))
            n_points += 1
    t = traces["bfs_tu"][0]
    cfg = T.HMSConfig(footprint=t.footprint, **base["grid"][0])
    one = T.simulate(t, cfg).counters
    old = sim.set_forced_shards(4)
    try:
        four = T.simulate(t, cfg).counters
        sim.set_forced_shards(8)           # lanes keep the CPU path short
        host = T.simulate(t, cfg, device="cpu").counters
    finally:
        sim.set_forced_shards(old)
    # the card's precompute against the CPU's, stream by stream
    s_dev = sim.scan_inputs(t, cfg.validate(), dev)
    s_cpu = sim.scan_inputs(t, cfg.validate(), torch.device("cpu"))
    w = float(s_cpu["params"]["ema_weight"])
    streams = {
        "slot": (s_dev["slot"], s_cpu["slot"]),
        "meta": (s_dev["meta"], s_cpu["meta"]),
        "pass1": (s_dev["derived"]["pass1"], s_cpu["derived"]["pass1"]),
        "pen64": (s_dev["derived"]["pen64"], s_cpu["derived"]["pen64"]),
        "ema": (scan_ops.ema_scan(s_dev["derived"]["pen64"], w),
                scan_ops.ema_scan(s_cpu["derived"]["pen64"], w)),
    }
    stream_diffs = {k: int((a.cpu() != b).sum()) for k, (a, b) in
                    streams.items()}
    host_diffs = counter_diffs(one, host)
    emit({"phase": "card_vs_cpu", "trace": "bfs_tu", "config": base["grid"][0],
          "stream_diffs": stream_diffs, "counter_diffs": host_diffs[:8]})
    emit({"phase": "sweep_baseline", "points": n_points, "n": base["n"],
          "mismatched": len(mismatches), "first_mismatches": mismatches[:5],
          "traces_rebuilt_here": {k: v[1] for k, v in traces.items()},
          "shards_4_equals_1": four == one, "card_equals_cpu": not host_diffs})
    # judged after the main path, so one run reports every phase
    deferred = []
    if four != one:
        deferred.append("S = 4 counters differ from S = 1")
    if host_diffs or any(stream_diffs.values()):
        deferred.append("the card's run differs from the port's CPU path")
    if mismatches:
        deferred.append(f"{len(mismatches)} of {n_points} baseline points "
                        f"differ, first: {mismatches[:1]}")

    # ---- 5. the main path at full size ------------------------------------
    runs = [(name, None) for name in sorted(T.WORKLOADS)] + [("zipf", 10**6)]
    traces = {(name, n): T.make_trace(name, n=n) for name, n in runs}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    rows = []
    phased = {}                      # raw counter bits of each run
    for (name, n), t in traces.items():
        cfg = T.HMSConfig(footprint=t.footprint)
        walls, bits = [], []
        for rep in range(4):               # first run warms the host caches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = T.simulate(t, cfg)
            torch.cuda.synchronize()
            if rep:
                walls.append(time.perf_counter() - t0)
            bits.append(counter_bits(r))
        if t.n_phases > 1:
            phased[(name, n)] = bits
        c = r.counters
        reqs = c["hit_r"] + c["miss_r"] + c["hit_w"] + c["miss_w"]
        need(reqs == t.n, f"{name}: {reqs} requests counted, trace has {t.n}")
        need(all(math.isfinite(v) for v in c.values())
             and math.isfinite(r.runtime_cycles) and r.runtime_cycles > 0,
             f"{name}: non-finite or empty result")
        wall = statistics.median(walls)
        row = {"phase": "main", "workload": name, "n": t.n,
               "footprint_mib": t.footprint / 2**20,
               "runtime_cycles": r.runtime_cycles,
               "hit_rate_read": r.hit_rate_read, "wall_s": wall,
               "ns_per_step": wall / t.n * 1e9}
        rows.append(row)
        emit(row)
    main_launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    for k in ("hms_scan", "ema_scan"):
        need(main_launches.get(k, 0) == 4 * len(rows), f"{k}: "
             f"{main_launches.get(k, 0)} launches on the main path, not one "
             f"per simulate ({4 * len(rows)})")
    emit({"phase": "main_done", "runs": len(rows), "launches": main_launches,
          "peak_mem_bytes": peak})
    # the phased scenarios' counters, bit for bit: the 4 runs above, and
    # S = 4 lanes against them (the per-phase sums in a fixed order)
    old = sim.set_forced_shards(4)
    try:
        four = {k: counter_bits(T.simulate(
            traces[k], T.HMSConfig(footprint=traces[k].footprint)))
            for k in phased}
    finally:
        sim.set_forced_shards(old)
    runs_equal = {k[0]: all(b == v[0] for b in v) for k, v in phased.items()}
    four_equal = {k[0]: four[k] == v[0] for k, v in phased.items()}
    emit({"phase": "phased_bits", "scenarios": sorted(runs_equal),
          "runs": 4, "runs_bit_equal": runs_equal,
          "shards_4_bit_equal": four_equal})
    need(len(phased) == 5 and all(runs_equal.values())
         and all(four_equal.values()),
         f"phased counters not bit-stable: runs {runs_equal}, S = 4 "
         f"{four_equal}")

    # where one simulate's time goes: the scan kernels alone per workload
    for (name, n), t in traces.items():
        s = sim.scan_inputs(t, T.HMSConfig(footprint=t.footprint).validate(),
                            dev)
        pen = s["derived"]["pen64"]
        w = float(s["params"]["ema_weight"])
        run_s = lambda: scan_ops.hms_scan(s["slot"], s["meta"], **s["scan"])
        call_ms = event_ms(torch, run_s, reps=3)
        scan_ms = device_ms(torch, run_s, "hms_chain_kernel")
        ema_ms = event_ms(torch, lambda: scan_ops.ema_scan(pen, w), reps=3)
        plan = scan_bounds(scan_ops, s, cycle_ms)
        emit({"phase": "breakdown", "workload": name, "n": t.n,
              "hms_scan_ms": scan_ms, "hms_scan_call_ms": call_ms,
              "ema_scan_ms": ema_ms,
              "scan_ns_per_step": scan_ms * 1e6 / t.n,
              "domains": plan["domains"],
              "longest_chain": plan["longest_chain"],
              "scan_ns_per_chain_step":
                  scan_ms * 1e6 / max(plan["longest_chain"], 1),
              "ema_ns_per_step": ema_ms * 1e6 / t.n})

    # the scan kernel's time per policy, on one full-size workload: which
    # parts of the step (CTC rows, affinity rule) cost what
    t = traces[("pathfnd", None)]
    for kw in GOLDEN_CONFIGS:
        s = sim.scan_inputs(
            t, T.HMSConfig(footprint=t.footprint, **kw).validate(), dev)
        scan_ms = device_ms(torch, lambda: scan_ops.hms_scan(
            s["slot"], s["meta"], **s["scan"]), "hms_chain_kernel", reps=2)
        plan = scan_bounds(scan_ops, s, cycle_ms)
        emit({"phase": "policy_breakdown", "workload": t.name, "config": kw,
              "ctc_ways": s["scan"]["ways_alloc"],
              "ctc_sets": s["scan"]["sets_alloc"], "hms_scan_ms": scan_ms,
              "scan_ns_per_step": scan_ms * 1e6 / t.n,
              "domains": plan["domains"],
              "longest_chain": plan["longest_chain"],
              "scan_ns_per_chain_step":
                  scan_ms * 1e6 / max(plan["longest_chain"], 1),
              "bound_ms": plan["bound_ms"]})

    # the AMIL probe's own path: its wrapper at the table sizes it names
    _build.reset_counts()
    g = torch.Generator(device=dev).manual_seed(3)
    for n_slots in (256, 8192):
        meta = torch.randint(0, 64, (n_slots,), generator=g, device=dev,
                             dtype=torch.int32)
        req = torch.randint(0, n_slots, (1 << 20,), generator=g, device=dev,
                            dtype=torch.int32)
        hit, _, _ = probe_ops.probe(meta, req, req & 3)
        need(hit.shape == req.shape, "amil probe output shape")
    torch.cuda.synchronize()
    probe_launches = _build.launches.get("amil_probe", 0)
    need(probe_launches > 0, "amil_probe was never launched on its path")

    # ---- 6-8. attention kernels and the serving path ----------------------
    summary["flash_attention"] = flash_checks(torch, dev, flush)
    paged_checks(torch, dev, flush)
    summary["ssd_scan"] = ssd_checks(torch, dev, flush)
    smoke_serve(torch)
    summary["paged_attention"], serve_launches = serving_phases(
        torch, dev, flush)
    for k, n in ssm_serving_phases(torch, dev).items():
        serve_launches[k] = serve_launches.get(k, 0) + n

    need(not deferred, "; ".join(deferred))

    # ---- 9. summary --------------------------------------------------------
    kernels = []
    for name, src, replaces, launches in (
            ("amil_probe", "src/repro_torch/kernels/amil_probe/csrc/"
             "amil_probe.cu",
             "src/repro/kernels/amil_probe/amil_probe.py:53",
             probe_launches),
            ("hms_scan", "src/repro_torch/kernels/hms_scan/csrc/hms_scan.cu",
             "src/repro/core/simulator.py:502", main_launches["hms_scan"]),
            ("ema_scan", "src/repro_torch/kernels/hms_scan/csrc/hms_scan.cu",
             "src/repro/core/simulator.py:418", main_launches["ema_scan"]),
            ("flash_attention", "src/repro_torch/kernels/flash_attention/"
             "csrc/flash_attention_wgmma.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:94",
             serve_launches["flash_attention"]),
            ("paged_attention", "src/repro_torch/kernels/paged_attention/"
             "csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/paged_attention.py:82",
             serve_launches["paged_attention"]),
            ("ssd_scan", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan/ssd_scan.py:71",
             serve_launches["ssd_scan"])):
        row = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        code = 1
    finally:
        if _OUT is not None:
            _OUT.close()
    sys.exit(code)
