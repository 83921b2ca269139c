#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (HMS simulator with UM paging, serving of
every model family) on one card.

    python3 chip_smoke.py [--out DIR]

Phases, each printed as one JSON line; any failure exits non-zero.  They
run in the order 1, 2, 6 (its flash rows, then 6b, 6c), 7, 7b, 8, then 3-5e and
9: the serving and training phases
come first because late in a long process (from ~610 s on, on the
H100 machines) the torch profiler's window now and then records one
device kernel fewer than ran, which ``decode_profile``'s device kernel
counts would read as a missing launch; its retry line then gives the
window's kernel count and where the kernel kind sits among them.

  1. device  - the card (nvidia-smi name and power limit), torch and CUDA.
  2. build   - nvcc builds every kernel of ``src/repro_torch`` for sm_90a.
  3. kernels - each kernel against its plain PyTorch version on the card,
               on the same inputs, exactly (integer outputs and the
               rounded float64 EMA): amil_probe at 256 and 8192 table
               lanes x 2^20 requests, at N % 4 = 1 and on views at offset
               1 (each row: the call, the kernel alone, every device
               kernel of a call, which must be one launch of the probe
               kernel), at the largest table the wrapper takes, and
               a child process whose out-of-range slot must fail the
               stream; hms_scan + ema_scan on the golden
               trace under all 8 policies (and 48 CTC ways of 64 and 96 of
               128: two and four a thread in the kernel) and on pathfnd
               at a sixteenth of its default size (PLAIN_SCAN_N: there the
               plain step loop runs once, timed and compared); the golden
               trace is cut to GOLDEN_PLAIN_N requests.  Each hms_scan row names its domains per
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
  4b. um     - um_scan against its plain version, counters and final
               state exactly: on short seeded streams that hit every quirk
               of the reference's paging step (UM_QUIRKS: chunks 1-64 at
               every window tier of the kernel, windows that wrap the frame
               ring, a clipped last chunk, both link modes, phases, a
               40000-page footprint, and the kernel's pass edges), and
               on the 16 points of benchmarks/baselines/BENCH_um.json (one
               8-lane call a workload, as the um suite batches them), which
               must also equal the baseline's counters (moe_expert and
               bfs_tu at n = 20000; committed copies where this numpy does
               not regenerate them).  Times the wrapper's call, the kernel
               alone and the plain version (the summary's row: moe_expert).
  4c. scenarios - the 20 points of benchmarks/baselines/
               BENCH_scenarios.json (5 scenarios at oversub 0.5, 1, 2 and
               4; the UM overflow model at 2 and 4) through
               ``simulate_many`` at n = 20000: config digests, counters
               (integer-valued exactly, fractional to rtol 1e-9), runtimes
               and at oversub 1 the per-phase summaries.  Traces held to
               the baseline's fingerprints (committed copies where this
               numpy draws other streams).
  5. main    - ``simulate`` with the default HMSConfig on every registered
               workload (12 generators + 5 scenarios) at its default size,
               plus zipf at 10^6 requests, through the scan kernels; launch
               counts are reset just before and read just after (one
               hms_scan launch a stitch round of the planner's (S, T), one
               ema_scan launch a simulate).  Each of the 5 phased
               scenarios' counters and per-phase counters must be
               bit-identical over its 4 runs and at S = 4 lanes.
  5b. um main - the UM leg of the main path at default size, launch
               counts reset just before and read just after: ``simulate_many``
               on fig11's point set (inf_hbm, hbm, scm, hms) on the 8 figure
               workloads, on fig17's grid on the first four (whose
               (0.25, tlc) point overflows the HMS) and on hbm in both link
               modes for every registered workload that pages; prints
               fig11's hms_over_hbm_speedup_geomean, ns per simulated
               request and the um_scan launches.  Then every paging run's
               counters against the host build of the kernel's step code
               (``ops.um_scan_host``), ``simulate_many`` against
               ``simulate`` config by config (bit for bit), um_scan against
               its plain version on llm_dec cut to UM_PLAIN_N requests
               (fault and nvlink lanes in one call: counters and final
               state exactly), and the kernel alone per paging
               workload beside its bounds (``um_bounds``).  Then
               um_step_costs: cycles a step of the kernel alone, one lane a
               launch, on synthetic hit and pure-migration streams (chunks
               1, 4, 64 and nvlink) and on every paging workload's lanes.
  5c. lanes  - the sweep engine's lanes at the main path's size (launch
               counts read around each batched call must equal its stitch
               rounds, and outside the faulted sweep every run must stay
               on its planned or forced (S, T) rung with no ladder event):
               fig18's grid (amil/tad x CTC fraction 0.25, 0.125,
               0.0625) on the first five figure workloads as ONE
               ``simulate_many`` batch, bit for bit equal to ``simulate``
               config by config, its wall beside the six sequential
               calls'; the 12-point BENCH_sweep.json grid as one batch a
               workload, equal to the baseline; recorded main-path
               launches against their plain versions, exactly, each on
               its workload cut in depth (SWEEP_PLAIN_N, SPLIT_ROUND_N,
               UM_PLAIN_N): the sweep grid's hms_scan launch at the
               planner's shape (per-lane CTC ways and set counts), fig18's
               batch on pathfnd at a forced (4, 16) with replay 64 (the
               warm-up round, cold with replay steps live, and the next,
               seeded with them dead) and llm_dec's UM run at T = 16 with
               replay 64 (the same two
               rounds of um_scan: (T, L) streams, real/live gates, seeded
               carries); forced (S, T) in
               LANE_SHAPES at replay 0 and 64 on pathfnd and zipf at 10^6,
               bit-identical, with rounds, walls and the active profile's
               predicted cost; the UM scan at T in
               UM_SEGMENTS on llm_dec's and gpt_train's default traces in
               both link modes, bit-identical, one um_scan launch a round,
               with wall, rounds and SMs in use; the planner's (S, T) for
               every main-path workload under the active profile (the
               committed H100 one unless ``REPRO_CALIB`` finds this
               host's); the planner's shape against (1, 1) on pathfnd and
               zipf at 10^6 and its UM T against T = 1 on llm_dec
               (PLANNED_REPS interleaved runs each after a warm-up: its
               median within PLANNED_SLACK of (1, 1)'s); and the sweep
               grid under injected faults (LANE_FAULTS, two passes at a
               forced (4, 4)) equal to the baseline, with the ladder's
               events.
  5d. obs    - the run ledger, span tracer, sentinel and design-space
               store (``repro_torch.obs``) on the main path, collection on
               into ``build/obs_smoke/`` (``obs_phase``): pathfnd's
               ``simulate``, fig18's grid as one ``simulate_many`` batch and
               a UM batch on llm_dec emit their records; digests bit-equal at
               (1, 1) and a forced (4, 4) and across batch widths; each
               ``scan`` span covers its ``hms_scan`` launch's device time
               (and ``um_scan``'s its); a warm repeat passes
               ``assert_no_retrace``; ``host`` names the card and its power
               limit; the ledger and the three committed baselines ingest
               into a ``SilverStore`` (re-ingest adds nothing) whose
               markdown renders.  Prints pathfnd's median wall over
               OBS_REPS interleaved runs with collection off and on, and
               the per-span split of a call.
  5e. memtier - the two-tier memory runtime (``memtier_phase``), the AMIL
               probe's path: (a) ``memtier.access`` at 16 GiB of 2 MiB
               slots over 64 GiB of blocks (MEMTIER_TIER), 64 rounds of
               32,768 random writes then 32,768 sequential reads, on the
               card and through the port's CPU path: every state entry
               and decision bit-equal after each call, one amil_probe
               launch a call (counts reset just before, read just after:
               the kernels line's launches), one probe kernel node on the
               stream of a ``probe_blocks`` call (``graph_nodes``), the
               probe at this shape against its plain version, a table of
               58,109 slots raising on the card; ms a call on the card and
               the CPU, hit, fill and bypass rates.  (b) qwen2.5-3b at full
               width and depth (bf16, seed-0 weights, 128 x 8 tokens, lr
               3e-4) through ``launch.train_tiered.run`` at a 0.4 budget,
               after 4 untiered steps of the same step function in this
               process: MemAvailable printed first, losses, grad norms and
               a streamed leaf's final weights bit-equal, bytes streamed
               4 x ``slow_bytes`` each way, device memory after each
               ``flush_out`` at least 0.9 x ``slow_bytes`` below the
               untiered run's after its step, a round trip bit-equal, the
               host buffer page-locked, the peak under the card's memory;
               ``stage_in`` / ``flush_out`` ms and GB/s, step ms of both.
  6. serving kernels against their plain versions: flash_attention at the
               serving slice's shape (B 4, S = T = 1024, 16 heads over 2 KV
               heads, hd 128; ragged, non-causal, softcap 30, S = T = 1000,
               S 512 under T 1024, and the launcher's S = T = 11), at
               zamba2-2.7b's (32 heads, hd 80; and S = T = 11) and at hd 16,
               32 and 64, every case in bf16 and in float32: each row names
               the design that ran (bf16: the wgmma kernel, float32: the
               ``mma3`` kernel, Q, K, V and P split into three bf16 pieces
               on the tensor cores) and must be the one for its type;
               float32 rows give the tensor-core, FMA and bytes bounds and
               the kernel's CTAs per SM (``--only flash`` runs these rows
               alone); paged_attention (page 16, 128 pages per
               sequence, random tables and lengths at both head shapes,
               every length 1 token, every length at a page edge, one
               sequence, and an identity table over a dense cache; bf16 and
               float32), float32 to atol =
               rtol = 3e-5 (another summation order) and bf16 to 2e-2, each
               timed beside its bound and one PyTorch call
               (scaled_dot_product_attention) as a yardstick; ssd_scan
               (y and final state) at mamba2-1.3b's prefill shape (B 4,
               L 1024, H 64, P 64, G 1, N 128, chunk 128) and zamba2's
               (H 80, N 64) in bf16 and float32, ragged L 11 and 130, a
               nonzero initial state, G = 2 and the smoke configs' shape
               (P 16, N 16) (see ``ssd_checks``): bf16 must run the
               tensor-core kernel, float32 the design ``ops.DESIGNS``
               names (the three-piece tensor-core kernel), each row with
               its CTAs per SM and, in float32, the tensor-core and FMA
               bounds.  Then
               ``repro_torch.launch.serve --arch mamba2-1.3b --smoke`` on
               the card (``smoke_serve``).
  6b. train  - (``train_phase``, right after the flash rows) the flash
               attention backward (``csrc/flash_attention_bwd.cu`` on the
               tensor cores: bf16 design ``mma``, float32 ``mma3``, three
               bf16 pieces an operand; no atomics) against its plain
               version (``flash_attention_backward_reference``) on the
               forward kernel's output and log-sum-exp (the log-sum-exp
               itself against the plain forward's), BWD_CASES in bf16
               (2e-2 of each gradient's largest magnitude) and float32
               (1e-4): the training slice (B 8, S = T = 128, 16 over 2
               heads, hd 128, causal), B 4 at S = T = 1024, non-causal,
               softcap 30, S 512 under T 1024, ragged 130 / 200, hd 64, hd
               80 and whisper's cross shape (11 over 1500); two calls
               bit-equal; each row names its design and its two tile
               kernels' CTAs per SM, timed beside its bound (5 products at
               the type's peak against the bytes; float32: six bf16 piece
               products at the bf16 peak, the FMA pipes' bound beside it),
               the backward of scaled_dot_product_attention through
               autograd and, with ``--parent-bwd DIR``, an earlier tree's
               FMA-pipe backward built from DIR, and profiled: one launch
               each of the D pre-pass, the dK/dV kernel, the sum of the
               heads' partials (only where H > KV) and the dQ kernel a
               call, and nothing else.  Then ``Trainer`` on qwen2.5-3b at full
               width (36 layers, bf16, seed-0 weights, ``for_model(cfg,
               128, 8)``, 5 steps at lr 3e-4): finite losses, launches
               against ``train_launches`` (36 forwards with log-sum-exp and
               36 backwards a step), peak memory, step time (median of
               steps 2-5), tokens/s, the forward/backward/optimizer split,
               a profiled step's busy share and top kernels, and one step
               with remat; then phase 6d (mesh): the same trainer on a
               world-size-1 mesh (``mesh_phase``); the 2-layer cut in
               float32 (TF32 off) on card and
               CPU from the same weights (first-step gradients leaf by leaf
               and 3 steps' losses and grad norms to 1e-4) and in bf16
               (2 steps' losses to 2e-2); and a restart on the card: 4
               steps, a checkpoint, a new Trainer resuming to 6, bit-equal
               to an uninterrupted run (losses and whole state).
  6d. mesh   - (``mesh_phase``, inside 6b after its full-width trainer)
               training on a ``torch.distributed`` device mesh at world
               size 1 (NCCL takes one rank a card): qwen2.5-3b's
               ``Trainer(mesh=...)`` bit-equal to 6b's first 3 steps with
               the same launches and a peak within 10%, the MoE's "tp"
               placement at a phi3.5-moe layer's widths bit-equal to the
               meshless layer, ``quantized_allreduce`` and
               ``ErrorFeedback`` on the card bit-equal to the CPU; then
               serving on the same (1, 1) mesh (``mesh_serve``):
               qwen2.5-3b at full width through ``Engine(ctx=...)`` on the
               launcher's traffic, tokens and kernel launches equal to the
               meshless engine's, the steps' caches bit-equal; and the dry
               run of whisper-tiny x decode_32k (``python -m
               repro_torch.launch.dryrun``, a fake process group of 256
               ranks) in a subprocess that sees no card.
  6c. train_ssm - (``train_ssm_phase``, right after 6b) the ssd_scan
               backward (``csrc/ssd_scan_bwd.cu`` on the tensor cores: bf16
               design ``mma``, float32 ``mma3``; the walks where there is
               more than one chunk or an initial state, one CTA a chunk
               and head, a fixed-order summing launch, no atomics) against
               its plain version (``ssd_plain_backward``) in bf16 (2e-2 of
               each gradient's largest magnitude) and float32 (1e-4):
               mamba2-1.3b's and zamba2-2.7b's training shapes (B 8,
               L 128), mamba2's at B 4, L 1024, ragged L 200 with an
               initial state and a dstate, G = 2 and the smoke shape; two
               calls bit-equal, one launch each of its device kernels a
               call (read from a captured CUDA graph), registers and
               spills from ptxas, CTAs per SM, the
               call's device and host time beside its bound, the plain
               version's and, with ``--parent-ssd-bwd DIR``, the
               ``ssd_backward`` of an earlier checkout DIR (its own wrapper
               and library) on the same inputs.  Then
               ``Trainer`` on mamba2-1.3b at full width (48 layers, bf16,
               seed-0 weights, 128 x 8 tokens, 5 steps) as in 6b (48
               ssd_scan and 48 ssd_scan_bwd launches a step, a remat
               step), the float32 cuts of mamba2-1.3b (2 layers) and
               zamba2-2.7b (one super-block; its steps held one at a
               time from the CPU path's state, beside a free card run
               and a one-ulp CPU run: ``cut_steps_from_cpu``) on card and
               CPU, and a mamba2 restart.  ``--only train_ssm`` adds zamba2-2.7b at full
               width and depth (54 ssd_scan_bwd and 9 flash_attention_bwd
               launches a step).
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
  7b. families - the moe, vlm and encdec families (``families_phase``) at
               published widths, bf16, seed-0 weights, each freed before
               the next: phi3.5-moe-42b at 24 of its 32 layers (its 32
               hold 83.7 GB, more than the card), pixtral-12b whole (40
               decoder and 24 vision layers; max_len 4096, since a slot
               holds the 1024 image positions of every batch) and
               whisper-tiny whole (4 + 4 layers, 1500 frames), each on the
               two mixes above (``serve``: launches against
               ``path_launches``; ``decode_profile``, which also counts the
               encdec's decode cross-attention on the wgmma kernel).  Then
               flash_attention at the new shapes, non-causal (whisper's
               encoder, B 4, S = T = 1500, 6 heads, hd 64; pixtral's
               vision tower, S = T = 1024, 16 heads, hd 64; cross-attention
               S 11 and S 1 over T 1500) in bf16 and float32, and
               paged_attention on phi's long-mix cache (32 over 8 heads, hd
               128), each against its plain version; then float32 and bf16
               cuts on card and CPU as in phase 8: phi3.5-moe at 1 layer,
               pixtral at 1 decoder and 1 vision layer, whisper-tiny
               whole, their logit runs on seeded random frames and patches
               (the engine's zeros leave the encoders' output zero).
  8. serve_card_vs_cpu - cuts at full width, TF32 off for matmuls and
               cuDNN: qwen2.5-3b and mamba2-1.3b at 2 layers, zamba2-2.7b
               at one super-block (6 Mamba2 layers + the shared block).  In
               float32 (all three) the same requests served on the card and
               through the port's CPU path give the same tokens and KV
               stats, every flash_attention and ssd_scan launch of the
               card the ``mma3`` design; in bf16 (qwen2.5-3b, zamba2-2.7b:
               the card's prefill attention is the wgmma kernel) the
               largest logit difference over a prefill and 3 decode steps
               stays within 2e-2 of the logit scale, the CPU tests' bf16
               logit tolerance.
  9. the ``kernels`` summary line, then the ``ok`` line.

The training cuts' free CPU runs (6b's two qwen2.5-3b cuts, 6c's
mamba2-1.3b cut and the hybrid's one-ulp run), which take nothing from
the card, run in a worker process (``HostRuns``) started right after the
build, while the card works; with ``--only`` they run in place.

``--out DIR`` also writes every JSON line to DIR/chip_smoke.jsonl;
``--only um`` runs phases 1-2 and the UM phases (4b, 5b and
um_step_costs), ``--only lanes`` phases 1-2, 4c and 5c, ``--only obs``
phases 1-2 and 5d, ``--only families`` phases 1-2 and 7b, ``--only train``
phases 1-2 and 6b, ``--only bwd`` phases 1-2 and 6b's backward rows,
``--only train_ssm`` phases 1-2 and 6c with zamba2-2.7b at full width and
depth, ``--only ssd_bwd`` phases 1-2 and 6c's backward rows,
``--only memtier`` phases 1-2 and 5e, ``--only mesh`` phases 1-2, 6b's
full-width trainer and 6d, ``--only mesh4`` (four cards) phases 1-2 and
qwen2.5-3b on NCCL meshes of four ranks (``mesh4_phase``), ``--only
bf16_spread`` the bf16 cuts' distances over 8 weight seeds,
``--only um_step_costs`` that phase alone, ``--only
amil_probe`` the amil_probe rows and the out-of-range check (the one-launch
rule not judged), ``--only ssd`` the ssd_scan rows and ``--only flash``
the flash_attention rows and ``--only hms_scan`` hms_scan's time on
pathfnd at (1, 1) (the call, the kernel alone, ema_scan as a control),
printing no ``ok`` line (a copy of the script beside another checkout's
``src/`` measures that checkout);
``--write-traces`` (no card needed) rewrites
``chip_smoke_traces.npz`` from ``make_trace`` for the workloads of the
sweep and UM baselines and from the scenario compiler for the 20 points
of BENCH_scenarios.json (with phase ids where a trace has them), refusing
unless every trace matches its baseline fingerprint.
Needs one CUDA card, nvcc, and this checkout's ``src/`` and
``benchmarks/baselines/``; imports nothing of JAX.  Bounds use the H100
SXM data sheet: 3.35 TB/s, 989 TFLOP/s bf16 (tensor cores), 67 TFLOP/s
float32.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BASELINE = ROOT / "benchmarks" / "baselines" / "BENCH_sweep.json"
BASELINE_UM = ROOT / "benchmarks" / "baselines" / "BENCH_um.json"
BASELINE_SCN = ROOT / "benchmarks" / "baselines" / "BENCH_scenarios.json"
TRACES = ROOT / "chip_smoke_traces.npz"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, data sheet
ATTN_TOL = {"bfloat16": 2e-2, "float32": 3e-5}
# bf16 products a term of the float32 ssd_scan design (three bf16 pieces an
# operand; the six piece products that reach float32's rounding)
F32_PIECE_PRODUCTS = 6
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
# the figure workloads of benchmarks/common.py and fig17's (r_hbm, SCM mode)
# grid (benchmarks/figures.py), whose (0.25, tlc) point overflows the HMS
FIG_WORKLOADS = ["stencil", "pathfnd", "bfs_tu", "sssp_ttc", "kcore",
                 "bert_inf", "gpt_train", "llm_dec"]
FIG17_GRID = ((1.5, "slc"), (1.0, "slc"), (0.75, "mlc"), (0.5, "mlc"),
              (0.25, "tlc"))
FRACTIONAL = {"dram_busy", "scm_busy", "dram_acts", "scm_acts",
              "scm_wr_acts"}
# fig18's CTC capacity grid (benchmarks/figures.py), one batch a workload
FIG18_GRID = [{"tag_layout": layout, "ctc_fraction": frac}
              for layout in ("amil", "tad") for frac in (0.25, 0.125, 0.0625)]
# forced (S, T) shapes of the lanes phase, each at replay 0 and LANE_REPLAY
LANE_SHAPES = ((1, 1), (4, 1), (1, 4), (4, 4), (1, 16))
LANE_REPLAY = 64
UM_SEGMENTS = (1, 4, 16)
LANE_FAULTS = "oom@1,stitch@4,nan@7"
# pathfnd's simulate with collection off and on: interleaved runs of each
OBS_REPS = 5
# the planner's shape against (1, 1): timed runs of each (after a warm-up),
# interleaved; the planner's median may exceed (1, 1)'s by this factor
PLANNED_REPS = 7
PLANNED_SLACK = 1.10
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
    request stream): the port's ``sweepckpt.trace_fingerprint``."""
    from repro_torch.resilience.sweepckpt import trace_fingerprint
    return trace_fingerprint(trace)


def baseline_traces(T, base):
    """{workload: (trace, rebuilt)} at the baseline's n: the trace from
    ``make_trace`` when its fingerprint is the baseline's, else the
    committed copy (which must be)."""
    import numpy as np
    out = {}
    saved = None
    for name, entry in base["workloads"].items():
        t = T.make_trace(name, n=int(base["n"]))
        rebuilt = trace_fp(t) == entry["trace_fp"]
        if not rebuilt:
            if saved is None:
                saved = np.load(TRACES)
            n = int(base["n"])
            phase = saved.get(f"{name}_phase")
            t = T.Trace(name, saved[f"{name}_col"].astype(np.int64),
                        np.unpackbits(saved[f"{name}_wr"])[:n].astype(bool),
                        t.footprint, phase_id=phase,
                        phase_names=t.phase_names)
            need(trace_fp(t) == entry["trace_fp"],
                 f"{name}: committed trace does not match the baseline")
        out[name] = (t, rebuilt)
    return out


def scenario_trace(T, name: str, n: int, oversub: float):
    """A scenario of BENCH_scenarios.json at one oversubscription level,
    compiled as the scenarios suite compiles it."""
    from repro_torch.workloads import SCENARIOS
    scn = SCENARIOS[name]
    return scn.compile(n=n) if oversub == 1.0 else scn.compile(
        n=n, oversub=oversub)


def scenario_key(name: str, oversub: float) -> str:
    return f"scn_{name}_{oversub}"


def scenario_traces(T, base):
    """{(scenario, oversub): (trace, rebuilt)} for the 20 points of
    BENCH_scenarios.json, held to their trace fingerprints (the committed
    copies where this numpy draws other streams)."""
    import numpy as np
    out = {}
    saved = None
    n = int(base["n"])
    for name, entry in base["scenarios"].items():
        for p in entry["sweep"]:
            t = scenario_trace(T, name, n, p["oversub"])
            rebuilt = trace_fp(t) == p["trace_fp"]
            if not rebuilt:
                if saved is None:
                    saved = np.load(TRACES)
                k = scenario_key(name, p["oversub"])
                t = T.Trace(t.name, saved[f"{k}_col"].astype(np.int64),
                            np.unpackbits(saved[f"{k}_wr"])[:n].astype(bool),
                            t.footprint, phase_id=saved[f"{k}_phase"],
                            phase_names=t.phase_names)
                need(trace_fp(t) == p["trace_fp"],
                     f"{k}: committed trace does not match the baseline")
            out[(name, p["oversub"])] = (t, rebuilt)
    return out


def write_traces() -> int:
    """Rewrite the committed traces of the three baselines (sweep, UM and
    scenarios) from ``make_trace`` and the scenario compiler, refusing
    unless each matches its fingerprint."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as T
    arrays = {}

    def put(key, t, fp):
        need(trace_fp(t) == fp, f"{key}: this numpy does not regenerate "
             "the baseline trace")
        arrays[f"{key}_col"] = t.col.astype(np.int32)
        arrays[f"{key}_wr"] = np.packbits(t.is_write)
        if t.phase_id is not None:
            arrays[f"{key}_phase"] = t.phase_id.astype(np.int32)

    for path in (BASELINE, BASELINE_UM):
        base = json.loads(path.read_text())
        for name, entry in base["workloads"].items():
            put(name, T.make_trace(name, n=int(base["n"])), entry["trace_fp"])
    base = json.loads(BASELINE_SCN.read_text())
    for name, entry in base["scenarios"].items():
        for p in entry["sweep"]:
            put(scenario_key(name, p["oversub"]),
                scenario_trace(T, name, int(base["n"]), p["oversub"]),
                p["trace_fp"])
    np.savez_compressed(TRACES, **arrays)
    print(f"wrote {TRACES.name}: {sorted(arrays)}")
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


# ---- the AMIL probe ----------------------------------------------------------

# (case, table lanes, requests, offset of the slot and tag views): the two
# table sizes the reference names, an N with N % 4 = 1, views at offset 1
# (slots[1:], tags[1:]: every request scalar) and the largest table the
# wrapper takes (227 KiB of shared memory less the kernel's 16-byte mbarrier)
AMIL_CASES = (("lanes_256", 256, 1 << 20, 0),
              ("lanes_8192", 8192, 1 << 20, 0),
              ("odd_n", 8192, (1 << 20) - 3, 0),
              ("view_offset_1", 8192, 1 << 20, 1),
              ("lanes_max", (227 * 1024 - 16) // 4, 1 << 20, 0),
              # past one CTA's shared memory: the table in device memory
              ("lanes_max_plus_1", (227 * 1024 - 16) // 4 + 1, 1 << 20, 0),
              ("lanes_2^20", 1 << 20, 1 << 20, 0))


def call_split(torch, fn, reps: int = 5, windows: int = 3):
    """{device kernel name: [launches a call, mean ms a launch]} of ``fn``
    from torch.profiler over ``reps`` calls after a warm-up; a window that
    saw no kernel is profiled again, up to ``windows`` times (None then)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(windows):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen.setdefault(e.name, []).append(
                    e.time_range.elapsed_us() / 1e3)
        if seen:
            return {k: [len(v) / reps, statistics.mean(v)]
                    for k, v in seen.items()}
    return None


# CUgraphNodeType, as cuda.h numbers it
GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
                    "wait_event", "event_record", "ext_semas_signal",
                    "ext_semas_wait", "mem_alloc", "mem_free",
                    "batch_mem_op", "conditional")


def _kernel_node_params():
    """An empty ctypes CUDA_KERNEL_NODE_PARAMS_v2, laid out as cuda.h."""
    import ctypes

    class Params(ctypes.Structure):
        _fields_ = [("func", ctypes.c_void_p),
                    *[(f, ctypes.c_uint) for f in (
                        "gx", "gy", "gz", "bx", "by", "bz", "smem")],
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]
    return Params()


def graph_nodes(torch, fn) -> list:
    """Every node that one call of ``fn`` puts on its stream, as
    ``[type, kernel name or None]``, read by the driver API from a CUDA
    graph captured around the call (the call is captured, not run).
    Unlike the profiler's tracer, the graph cannot drop a record."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    raw = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    need(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0,
         "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    need(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0,
         "cuGraphGetNodes failed")
    out = []
    for i in range(n.value):
        node = ctypes.c_void_p(nodes[i])
        t = ctypes.c_int(-1)
        need(cu.cuGraphNodeGetType(node, ctypes.byref(t)) == 0,
             "cuGraphNodeGetType failed")
        kind = (GRAPH_NODE_TYPES[t.value]
                if 0 <= t.value < len(GRAPH_NODE_TYPES) else str(t.value))
        name = None
        if kind == "kernel":
            p = _kernel_node_params()
            need(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p))
                 == 0, "cuGraphKernelNodeGetParams_v2 failed")
            s = ctypes.c_char_p()
            if p.func:
                e = cu.cuFuncGetName(ctypes.byref(s), ctypes.c_void_p(p.func))
            else:
                e = cu.cuKernelGetName(ctypes.byref(s),
                                       ctypes.c_void_p(p.kern))
            need(e == 0 and s.value, f"no name for a kernel node ({e})")
            name = s.value.decode()
        out.append([kind, name])
    g.reset()
    return out


def amil_checks(torch, dev, flush, judge: bool):
    """amil_probe against its plain version, bit for bit, on AMIL_CASES:
    the wrapper's call (CUDA events, L2 flushed), the kernel alone
    (profiler), every device kernel of a call with its time (``split``),
    every node a call puts on its stream (``graph_nodes``), the plain
    version and the bytes bound (20 B a request and the table).
    ``judge``: a call must be one launch of the probe kernel and nothing
    else, read from the graph (and from ``split`` where the profiler saw
    every call: a window with fewer probe records than calls and nothing
    else is profiled again, then left to the graph).  A copy of this script beside another checkout's ``src/``
    measures that checkout (``--only amil_probe``).  Returns the lanes_8192
    row."""
    from repro_torch.kernels.amil_probe import ops as probe_ops
    from repro_torch.kernels.amil_probe.ref import amil_probe_reference
    rows = {}
    for seed, (case, n_slots, n_req, shift) in enumerate(AMIL_CASES, 1):
        g = torch.Generator(device=dev).manual_seed(seed)
        meta = torch.randint(0, 64, (n_slots,), generator=g, device=dev,
                             dtype=torch.int32)
        slots = torch.randint(0, n_slots, (n_req + shift,), generator=g,
                              device=dev, dtype=torch.int32)[shift:]
        tags = torch.randint(0, 4, (n_req + shift,), generator=g, device=dev,
                             dtype=torch.int32)[shift:]
        run = lambda: probe_ops.amil_probe(meta, slots, tags)
        got = run()
        want = amil_probe_reference(meta, slots, tags)
        torch.cuda.synchronize()
        err = max(same(torch, a, b) for a, b in zip(got, want))
        # the CPU path (the wrapper on CPU tensors), bit for bit
        host = probe_ops.amil_probe(meta.cpu(), slots.cpu(), tags.cpu())
        cpu_equal = all(torch.equal(a.cpu(), b) for a, b in zip(got, host))
        need(cpu_equal, f"amil_probe {case}: the card differs from the CPU "
             "path")
        event_ms(torch, run, reps=5, flush=flush)          # warm-up
        ms = event_ms(torch, run, reps=20, flush=flush)
        kernel_ms = device_ms(torch, run, "amil_probe_kernel",
                              "amil_probe_launch", reps=5)
        # a window whose records are all the probe's but fewer than its
        # calls dropped a record (the tracer does, now and then): profiled
        # again, twice at most, and then judged by the graph alone
        for _ in range(3):
            split = call_split(torch, run)
            per_call = None if split is None else sum(
                v[0] for v in split.values())
            short = split is not None and per_call < 1 and all(
                "amil_probe_kernel" in k for k in split)
            if not short:
                break
        if split is None or short:
            emit({"phase": "profiler_miss", "kernel": "amil_probe_kernel",
                  "case": case, "windows": 3, "kernels_per_call": per_call})
        nodes = graph_nodes(torch, run)
        if judge:
            need(len(nodes) == 1 and nodes[0][0] == "kernel"
                 and "amil_probe_kernel" in nodes[0][1],
                 f"amil_probe {case}: a call put {nodes} on its stream, "
                 "not one launch of the probe kernel")
            need(split is None or short or (per_call == 1 and all(
                "amil_probe_kernel" in k for k in split)),
                f"amil_probe {case}: a call launched {split}, not one "
                "launch of the probe kernel")
        plain_ms = event_ms(
            torch, lambda: amil_probe_reference(meta, slots, tags), reps=5,
            flush=flush)
        bytes_moved = 20 * n_req + 4 * n_slots
        row = {"name": "amil_probe", "case": case, "table_lanes": n_slots,
               "requests": n_req, "view_offset": shift, "max_abs_err": err,
               "cpu_equal": cpu_equal,
               "design": "shared" if n_slots <= probe_ops.MAX_LANES
               else "device_memory",
               "ms": ms, "kernel_ms": kernel_ms, "split": split,
               "kernels_per_call": per_call, "graph_nodes": nodes,
               "plain_ms": plain_ms,
               "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": None,
               "hit_rate": float(got[0].float().mean())}
        emit({"phase": "kernel_vs_plain", **row})
        rows[case] = row
    return rows["lanes_8192"]


_AMIL_OUT_OF_RANGE = """
import sys
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels.amil_probe import ops
dev = torch.device("cuda")
meta = torch.zeros(256, dtype=torch.int32, device=dev)
slots = torch.arange(1 << 16, dtype=torch.int32, device=dev) % 256
ops.amil_probe(meta, slots, slots)
torch.cuda.synchronize()
print("in_range_ok", flush=True)
slots[40001] = 256
ops.amil_probe(meta, slots, slots)
torch.cuda.synchronize()
print("out_of_range_passed", flush=True)
"""


def amil_out_of_range(torch, dev) -> None:
    """A slot outside the table fails the stream: a child process probes
    once in range (which must pass) and then with one slot at n_slots,
    and must exit non-zero before it passes the second synchronize; this
    process's context is unharmed (a probe after it equals the plain
    version)."""
    from repro_torch.kernels.amil_probe import ops as probe_ops
    from repro_torch.kernels.amil_probe.ref import amil_probe_reference
    child = subprocess.run(
        [sys.executable, "-c",
         _AMIL_OUT_OF_RANGE.format(src=str(ROOT / "src"))],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = child.stdout.split()
    err_tail = child.stderr.strip().splitlines()[-3:]
    meta = torch.randint(0, 64, (256,), device=dev, dtype=torch.int32)
    slots = torch.randint(0, 256, (4097,), device=dev, dtype=torch.int32)
    after = max(same(torch, a, b) for a, b in zip(
        probe_ops.amil_probe(meta, slots, slots & 3),
        amil_probe_reference(meta, slots, slots & 3)))
    torch.cuda.synchronize()
    emit({"phase": "amil_out_of_range", "child_exit": child.returncode,
          "child_stdout": lines, "child_stderr_tail": err_tail,
          "parent_probe_after_max_abs_err": after})
    need(child.returncode != 0 and lines == ["in_range_ok"],
         f"an out-of-range slot did not fail the stream: exit "
         f"{child.returncode}, stdout {lines}, stderr {err_tail}")


# ---- the scan kernels ---------------------------------------------------------

def plain_scan(scan_ref, s):
    """The plain version of hms_scan on scan inputs ``s`` (the sequential
    walk takes every keyword but the row-group size)."""
    kw = {k: v for k, v in s["scan"].items() if k != "spg"}
    return scan_ref.hms_scan_reference(s["slot"], s["meta"], **kw)


def entry_events(torch, entries):
    """Wrap the kernels' library entries ``entries`` with CUDA events while
    the returned context is open; ``times`` then maps each entry to the
    device ms of each launch (the kernel with its launch latency, on the
    stream), read after a synchronize."""
    import contextlib
    from repro_torch import _build
    lib = _build.library()
    pairs = {e: [] for e in entries}
    inner = {e: getattr(lib, e) for e in entries}

    def wrap(e):
        def timed(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = inner[e](*args)
            b.record()
            pairs[e].append((a, b))
            return err
        return timed

    times = {}

    @contextlib.contextmanager
    def ctx():
        for e in entries:
            setattr(lib, e, wrap(e))
        try:
            yield times
        finally:
            for e in entries:
                setattr(lib, e, inner[e])
            torch.cuda.synchronize()
            for e in entries:
                times[e] = [a.elapsed_time(b) for a, b in pairs[e]]
    return ctx()


def launch_ms(torch, fn, entry: str, reps: int = 3) -> float:
    """Median time, on the stream, between CUDA events recorded just before
    and just after the kernels' library entry ``entry`` in each of ``reps``
    calls of ``fn``: the kernel with its launch latency, without the
    wrapper's checks and copies around it."""
    with entry_events(torch, (entry,)) as ev:
        for _ in range(reps):
            fn()
    need(len(ev[entry]) == reps, f"{entry}: {len(ev[entry])} launches in "
         f"{reps} calls")
    return statistics.median(ev[entry])


def device_ms(torch, fn, needle: str, entry: str, reps: int = 3,
              windows: int = 3) -> float:
    """Median device time of one launch of the kernel whose name holds
    ``needle``, from torch.profiler over ``reps`` calls of ``fn`` after a
    warm-up: the kernel alone, without the wrapper's checks and copies
    around it.  The profiler may drop records: each seen launch counts, a
    window that saw none is profiled again, and where ``windows`` windows
    saw none the time is taken by :func:`launch_ms` around the library
    entry ``entry`` instead, with a ``profiler_miss`` line saying so."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(windows):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and needle in e.name]
        if times:
            return statistics.median(times)
    ms = launch_ms(torch, fn, entry, reps)
    emit({"phase": "profiler_miss", "kernel": needle, "windows": windows,
          "reps": reps, "launch_ms": ms})
    return ms


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


# ---- the UM paging kernel ---------------------------------------------------

# the paging workload whose fault and nvlink lanes also run through
# um_scan's plain version, cut to UM_PLAIN_N requests (its 6144 pages over
# 4608 frames still page; the plain step loop takes ~0.4 ms a request)
UM_PLAIN_WORKLOAD = "llm_dec"
UM_PLAIN_N = 40_000
PLAIN_SCAN_N = 10_000            # pathfnd's requests for the plain hms_scan
# the golden trace's requests for the hms_scan rows of the 10 policy
# configs (the plain step loop takes ~1 ms a request)
GOLDEN_PLAIN_N = 1_500
# pathfnd's requests for fig18's split rounds against the plain version,
# and the sweep grid's first workload's for its recorded launch
SPLIT_ROUND_N = 40_000
SWEEP_PLAIN_N = 5_000

def um_bounds(args, counts, cycle_ms):
    """um_scan's bounds on its arguments and its counts: the slowest lane's
    chain, one dependent round trip (STEP_CYCLES) for each migrating step
    (the lane's fault counter counts exactly those) and for each pass of up
    to 32 hit steps, and the stream's bytes (page, write flag, phase) at
    the memory rate.  Lanes run side by side.  ``step_chain_bound_ms`` is
    the chain of n dependent steps that a kernel stepping one request at a
    time is held to."""
    n = args["page"].shape[0]
    passes = max((int(f) + math.ceil((n - f) / 32)
                  for f in counts[:, 0].sum(dim=1).tolist()), default=0)
    chain_ms = passes * STEP_CYCLES * cycle_ms
    per_step = 5 + (4 if args["phase"] is not None else 0)
    bytes_ms = n * per_step / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(chain_ms, bytes_ms),
            "bound_by": "operations" if chain_ms >= bytes_ms else "bytes",
            "bytes_bound_ms": bytes_ms, "chain_round_trips": passes,
            "step_chain_bound_ms": n * STEP_CYCLES * cycle_ms}


# (n, pages, phases, lanes as (n_frames, chunk, nvlink, hot_thresh)): every
# tier of the kernel's window (chunk 1 to 64), windows that wrap the frame
# ring, a clipped last chunk, both link modes, phases, and a large footprint
UM_QUIRKS = {
    "large_footprint": (1500, 40000, 1, ([30000, 50], [4, 4], [False, False],
                                         [0, 0])),
    "chunk1": (1500, 300, 1, ([40, 250], [1, 1], [False, False], [0, 0])),
    "chunk4_clip": (1500, 301, 1, ([60, 7], [4, 4], [False, False], [0, 0])),
    "chunk8_wrap": (1200, 203, 1, ([20, 9], [8, 8], [False, False], [0, 0])),
    "chunk64": (800, 517, 1, ([300, 100, 70], [64, 64, 64],
                              [False, False, False], [0, 0, 0])),
    # the kernel's window tiers of 64 and 128 candidates, wrapped and not
    "chunk16_32": (1000, 400, 1, ([200, 50, 300, 90], [16, 16, 32, 32],
                                  [False] * 4, [0] * 4)),
    "nvlink": (1500, 300, 1, ([50, 3, 120], [1, 1, 1], [True, True, True],
                              [4, 0, 2])),
    "mixed_phased": (1500, 257, 3, ([64, 5, 40, 100], [8, 2, 1, 1],
                                    [False, False, True, True],
                                    [0, 0, 4, 1])),
    # the kernel's pass edges (32 requests a pass), as (..., prefix, the
    # longest phase run): an nvlink page that crosses its threshold at its
    # 2nd, 3rd and 4th step of one pass; a migration at a pass's last and
    # first request; phase runs of 1-40 requests, several in most passes
    "pass_threshold": (1500, 300, 1, ([8, 8, 3], [1, 1, 1],
                                      [True, True, True], [2, 3, 4]),
                       [20, 21, 7, 9, 24, 25, 7, 27, 28, 29, 30, 7, 32, 33,
                        34, 35, 36, 37, 38, 7, 40, 41, 42, 43, 44, 45, 46, 7,
                        48, 9, 50, 51], 0),
    "pass_edges": (1500, 300, 1, ([64, 9], [1, 4], [False, False], [0, 0]),
                   [100] * 32 + [150, 200, 100, 150, 200], 0),
    "pass_phases": (1500, 150, 3, ([40, 7, 40, 9], [4, 2, 1, 1],
                                   [False, False, True, True], [0, 0, 3, 0]),
                    [], 40),
}


def um_quirk_checks(torch, dev) -> None:
    """um_scan against its plain version on short seeded streams that hit
    every quirk of the reference's step (UM_QUIRKS): counters and final
    state exactly."""
    import numpy as np
    from repro_torch.kernels.um_scan import ops as um_ops
    from repro_torch.kernels.um_scan import ref as um_ref
    for seed, (case, (n, n_pages, n_phases, lanes, *edges)) in enumerate(
            sorted(UM_QUIRKS.items())):
        prefix, run = edges or ([], 0)
        rng = np.random.default_rng(seed)
        # runs near the last page, and jumps
        walk = np.cumsum(rng.integers(-3, 4, n)) % n_pages
        page = np.where(rng.random(n) < 0.7, walk,
                        rng.integers(0, n_pages, n))
        page[:len(prefix)] = prefix
        page[-1] = n_pages - 1
        phase = np.arange(n) // 250 % n_phases
        if run:
            phase = np.repeat(rng.integers(0, n_phases, n),
                              rng.integers(1, run + 1, n))[:n]
        args = dict(
            page=torch.from_numpy(page.astype(np.int32)).to(dev),
            is_write=torch.from_numpy(rng.random(n) < 0.3).to(dev),
            phase=torch.from_numpy(phase.astype(np.int32)).to(dev)
            if n_phases > 1 else None,
            n_phases=n_phases, n_pages=n_pages, n_frames=lanes[0],
            chunk=lanes[1], nvlink=lanes[2], hot_thresh=lanes[3])
        got = um_ops.um_scan(**args)
        want = um_ref.um_scan_reference(**args)
        err = max([same(torch, got[0], want[0])]
                  + [same(torch, a, b) for a, b in zip(got[1], want[1])])
        need(bool((got[0][:, 1] > 0).all()), f"{case}: a lane never paged")
        emit({"phase": "kernel_vs_plain", "name": "um_scan", "case": case,
              "n": n, "lanes": len(lanes[0]), "chunks": lanes[1],
              "max_abs_err": err,
              "faults": got[0][:, 0].sum(dim=1).tolist()})


def um_baseline_checks(torch, T, dev, flush, cycle_ms):
    """um_scan against its plain version on the 16 points of
    BENCH_um.json, one call of 8 lanes a workload as the um suite batches
    them: counters and final state exactly, and both against the
    baseline's encoded counters.  Returns the moe_expert row."""
    from repro_torch.kernels.um_scan import ops as um_ops
    from repro_torch.kernels.um_scan import ref as um_ref
    from repro_torch.um import engine as um_engine
    base = json.loads(BASELINE_UM.read_text())
    traces = baseline_traces(T, base)
    fields = ("um_faults", "um_migrated", "um_writebacks", "um_remote_cols")
    rows, mismatched = {}, []
    for w, entry in base["workloads"].items():
        t = traces[w][0]
        specs = [um_engine.um_spec(T.HMSConfig(
            footprint=t.footprint, organization="hbm",
            r_hbm=1.0 / p["rel_footprint"]), p["nvlink"])
            for p in entry["points"]]
        args = um_engine.scan_args(t, specs, dev)
        run_k = lambda: um_ops.um_scan(**args)
        got = run_k()
        plain = []
        plain_ms = event_ms(torch, lambda: plain.append(
            um_ref.um_scan_reference(**args)))
        err = max([same(torch, got[0], plain[0][0])]
                  + [same(torch, a, b) for a, b in zip(got[1], plain[0][1])])
        counts = got[0].cpu().numpy()
        for j, p in enumerate(entry["points"]):
            for k, f in enumerate(fields):
                if counts[j, k].tolist() != p["counters"][f]:
                    mismatched.append((w, p["rel_footprint"], p["nvlink"], f))
        ms = event_ms(torch, run_k, reps=3, flush=flush)
        kernel_ms = device_ms(torch, run_k, "um_scan_kernel",
                              "um_scan_launch")
        rows[w] = {"name": "um_scan", "trace": w, "n": t.n,
                   "lanes": len(specs), "phases": t.n_phases,
                   "pages": args["n_pages"], "max_abs_err": err, "ms": ms,
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   **um_bounds(args, got[0], cycle_ms),
                   "ns_per_step": kernel_ms * 1e6 / t.n,
                   "faults": float(counts[:, 0].sum()),
                   "library_ms": None}
        emit({"phase": "kernel_vs_plain", **rows[w],
              "trace_rebuilt_here": traces[w][1]})
    emit({"phase": "um_baseline", "points": sum(
        len(e["points"]) for e in base["workloads"].values()),
        "mismatched": len(mismatched), "first_mismatches": mismatched[:5]})
    need(not mismatched, f"um_scan differs from BENCH_um.json at "
         f"{len(mismatched)} counters, first {mismatched[:3]}")
    return rows["moe_expert"]


def um_main_path(torch, T, dev, traces, cycle_ms):
    """The UM leg of the main path at default size, through
    ``simulate_many``: fig11's point set (inf_hbm, hbm, scm, hms) on the
    figure workloads, fig17's grid on the first four (HMS and HBM at each
    r_hbm; (0.25, tlc) overflows the HMS), and hbm in both link modes on
    every registered workload that pages.  Launch counts are reset just
    before and read just after.  Then, uncounted: every paging run's
    counters against the host build of the kernel's step code
    (``um_scan_host``), ``simulate_many`` against ``simulate`` config by
    config, the plain version once on UM_PLAIN_WORKLOAD cut to UM_PLAIN_N,
    and the kernel alone per workload.  Returns the main path's launch
    counts."""
    from repro_torch import _build
    from repro_torch.core import simulator as sim
    from repro_torch.kernels.um_scan import ops as um_ops
    from repro_torch.kernels.um_scan import ref as um_ref
    from repro_torch.um import engine as um_engine
    import numpy as np

    def hbm(t, **kw):
        return T.HMSConfig(footprint=t.footprint, organization="hbm", **kw)

    batches = []                     # (trace, configs, nvlink, results)

    def drive(t, cfgs, nvlink=False):
        """simulate_many's results, wall seconds and um_scan launches (0
        where the paging runs were memoized or early-out)."""
        before = _build.launches.get("um_scan", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = T.simulate_many(t, cfgs, nvlink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        batches.append((t, cfgs, nvlink, rs))
        return rs, wall, _build.launches.get("um_scan", 0) - before

    _build.reset_counts()
    speedups = {}
    for w in FIG_WORKLOADS:
        t = traces[(w, None)]
        cfgs = [T.HMSConfig(footprint=t.footprint, organization=o)
                for o in ("inf_hbm", "hbm", "scm", "hms")]
        (inf, hb, scm, hms), wall, um_n = drive(t, cfgs)
        speedups[w] = hb.runtime_cycles / hms.runtime_cycles
        emit({"phase": "um_main", "set": "fig11", "workload": w, "n": t.n,
              "configs": len(cfgs), "wall_s": wall, "um_scan_launches": um_n,
              "ns_per_request": wall / (t.n * len(cfgs)) * 1e9,
              "hbm_rel": hb.runtime_cycles / inf.runtime_cycles,
              "hms_rel": hms.runtime_cycles / inf.runtime_cycles,
              "scm_rel": scm.runtime_cycles / inf.runtime_cycles,
              "um_faults": hb.counters["um_faults"]})
    fig17 = {}
    for w in FIG_WORKLOADS[:4]:
        t = traces[(w, None)]
        cfgs = ([T.HMSConfig(footprint=t.footprint, r_hbm=r, scm_mode=m)
                 for r, m in FIG17_GRID]
                + [hbm(t, r_hbm=r) for r, _ in FIG17_GRID])
        rs, wall, um_n = drive(t, cfgs)
        k = len(FIG17_GRID)
        fig17[w] = [rs[k + i].runtime_cycles / rs[i].runtime_cycles
                    for i in range(k)]
        need("um_faults" in rs[k - 1].counters,
             f"{w}: fig17's (0.25, tlc) point did not overflow the HMS")
        emit({"phase": "um_main", "set": "fig17", "workload": w, "n": t.n,
              "configs": len(cfgs), "wall_s": wall, "um_scan_launches": um_n,
              "ns_per_request": wall / (t.n * len(cfgs)) * 1e9,
              "hms_speedup": dict(zip([f"{r}:{m}" for r, m in FIG17_GRID],
                                      fig17[w]))})
    paged = []
    for (w, n), t in traces.items():
        if n is not None:
            continue
        _, n_pages = um_engine._page_stream(t)
        if um_engine.um_spec(hbm(t)).n_frames >= n_pages:
            continue                 # early-out: HBM holds the footprint
        paged.append(w)
        for nv in (False, True):
            (r,), wall, um_n = drive(t, [hbm(t)], nv)
            emit({"phase": "um_main", "set": "hbm_link", "workload": w,
                  "n": t.n, "nvlink": nv, "wall_s": wall,
                  "um_scan_launches": um_n,
                  "ns_per_request": wall / t.n * 1e9,
                  "um_faults": r.counters["um_faults"],
                  "um_remote_cols": r.counters["um_remote_cols"]})
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    geo = math.exp(statistics.fmean(math.log(v) for v in speedups.values()))
    emit({"phase": "um_main_done", "launches": launches,
          "hms_over_hbm_speedup_geomean": geo,
          "hms_over_hbm_speedup": speedups,
          "fig17_hms_speedup_geomean": {
              f"{r}:{m}": math.exp(statistics.fmean(
                  math.log(v[i]) for v in fig17.values()))
              for i, (r, m) in enumerate(FIG17_GRID)},
          "paging_workloads": paged})
    need(launches.get("um_scan", 0) > 0, "um_scan never launched on the "
         "UM main path")
    need(math.isfinite(geo) and geo > 0, "fig11 speedup not finite")

    # every paging run against the host build of the kernel's step code
    host_checks = lanes = 0
    bad = []
    for t, cfgs, nv, rs in batches:
        specs = sim._um_specs(t, [c.validate() for c in cfgs], nv)
        _, n_pages = um_engine._page_stream(t)
        specs = [s for s in dict.fromkeys(specs) if s.n_frames < n_pages]
        if not specs:
            continue
        got = um_engine.simulate_um_many(t, specs)     # memoized card runs
        want, _ = um_ops.um_scan_host(**um_engine.scan_args(
            t, specs, torch.device("cpu")))
        for j, r in enumerate(got):
            have = np.stack([r.phase_faults, r.phase_migrated,
                             r.phase_writebacks, r.phase_remote_cols])
            if not np.array_equal(have, want[j].numpy()):
                bad.append((t.name, nv, dataclasses.asdict(r.spec)))
        host_checks += 1
        lanes += len(specs)
        for c, r in zip(cfgs, rs):                     # config by config
            one = T.simulate(t, c, nv)
            if (counter_bits(one) != counter_bits(r)
                    or one.runtime_cycles != r.runtime_cycles):
                bad.append((t.name, nv, "simulate_many != simulate", c))
    emit({"phase": "um_host_oracle", "calls": host_checks, "lanes": lanes,
          "mismatched": len(bad), "first_mismatches": [str(b)
                                                       for b in bad[:4]]})
    need(not bad, f"UM main path: {len(bad)} mismatches, first {bad[:2]}")

    # the plain version on a paging workload cut to UM_PLAIN_N requests:
    # fault and nvlink lanes in one call, exactly
    t = T.make_trace(UM_PLAIN_WORKLOAD, n=UM_PLAIN_N)
    specs = [um_engine.um_spec(hbm(t), nv) for nv in (False, True)]
    args = um_engine.scan_args(t, specs, dev)
    need(specs[0].n_frames < args["n_pages"],
         f"{t.name} does not page at {t.n} requests")
    got = um_ops.um_scan(**args)
    plain = []
    plain_ms = event_ms(torch, lambda: plain.append(
        um_ref.um_scan_reference(**args)))
    err = max([same(torch, got[0], plain[0][0])]
              + [same(torch, a, b) for a, b in zip(got[1], plain[0][1])])
    emit({"phase": "kernel_vs_plain", "name": "um_scan", "case": "main_path",
          "trace": t.name, "n": t.n, "lanes": len(specs),
          "pages": args["n_pages"], "frames": specs[0].n_frames,
          "max_abs_err": err, "plain_ms": plain_ms,
          "faults": got[0][:, 0].sum(dim=1).tolist(),
          "migrated": got[0][:, 1].sum(dim=1).tolist()})

    # the kernel alone per paging workload: both link modes in one call
    for w in paged:
        t = traces[(w, None)]
        specs = [um_engine.um_spec(hbm(t), nv) for nv in (False, True)]
        args = um_engine.scan_args(t, specs, dev)
        counts, _ = um_ops.um_scan(**args)
        kernel_ms = device_ms(torch, lambda: um_ops.um_scan(**args),
                              "um_scan_kernel", "um_scan_launch", reps=2)
        emit({"phase": "um_breakdown", "workload": w, "n": t.n,
              "pages": args["n_pages"], "frames": specs[0].n_frames,
              "lanes": 2, "um_scan_ms": kernel_ms,
              "ns_per_step": kernel_ms * 1e6 / t.n,
              "faults": counts[:, 0].sum(dim=1).tolist(),
              **um_bounds(args, counts, cycle_ms)})
    return launches


# synthetic streams of um_step_costs: the pure-migration streams' frames
# (a window of up to 256 wraps none) and the hit stream's resident set
UM_COST_FRAMES = 4096
UM_COST_HIT_PAGES = 8192


def um_cost_streams(n_hit=240_000, n_mig=20_000, seed=11):
    """um_step_costs' synthetic streams: (name, page int32, is_write, pages,
    lane as (n_frames, chunk, nvlink, hot_thresh), steps timed).

    ``warm`` sweeps the hit stream's 8192 pages once into as many frames;
    ``hit`` is that sweep then ``n_hit`` uniform requests, which all hit:
    the difference of the two launches is the hit steps' cost.  ``mig_*``
    migrate on every step, into full frames after the first few: fault
    mode touches a chunk never touched before each step (chunks 1, 4 and
    64), nvlink mode (threshold 0, one page a migration whatever the chunk)
    a page never touched before."""
    import numpy as np
    rng = np.random.default_rng(seed)
    wr = lambda n: rng.random(n) < 0.3
    sweep = np.arange(UM_COST_HIT_PAGES)
    hits = np.concatenate([sweep, rng.integers(0, UM_COST_HIT_PAGES, n_hit)])
    out = []
    for mode, lane in (("fault", (UM_COST_HIT_PAGES, 4, False, 0)),
                       ("nvlink", (UM_COST_HIT_PAGES, 1, True, 0))):
        out.append((f"warm_{mode}", sweep, wr(sweep.size),
                    UM_COST_HIT_PAGES, lane))
        out.append((f"hit_{mode}", hits, wr(hits.size), UM_COST_HIT_PAGES,
                    lane))
    t = np.arange(n_mig)
    for c in (1, 4, 64):
        out.append((f"mig_fault_chunk{c}", t * c, wr(n_mig), c * n_mig,
                    (UM_COST_FRAMES, c, False, 0)))
    out.append(("mig_nvlink", t, wr(n_mig), n_mig,
                (UM_COST_FRAMES, 1, True, 0)))
    return [(name, page.astype(np.int32), w, n_pages, lane)
            for name, page, w, n_pages, lane in out]


def um_step_costs(torch, T, dev, cycle_ms, traces=None):
    """Cycles a step of um_scan's kernel alone, one lane a launch: on the
    synthetic streams of :func:`um_cost_streams` (a hit step: the hit
    stream less its warm-up sweep; a migrating step: the pure-migration
    streams), and on the fault and nvlink lanes of every registered
    workload that pages at its default size.  Cycles are kernel ms x the
    card's max SM clock / steps."""
    from repro_torch.kernels.um_scan import ops as um_ops
    from repro_torch.um import engine as um_engine

    def lane_ms(args):
        counts, _ = um_ops.um_scan(**args)
        ms = device_ms(torch, lambda: um_ops.um_scan(**args),
                       "um_scan_kernel", "um_scan_launch", reps=2)
        return ms, float(counts[0, 0].sum())

    cyc = lambda ms: ms / cycle_ms
    warm = {}
    for name, page, wr, n_pages, lane in um_cost_streams():
        args = dict(page=torch.from_numpy(page).to(dev),
                    is_write=torch.from_numpy(wr).to(dev), phase=None,
                    n_phases=1, n_pages=n_pages, n_frames=[lane[0]],
                    chunk=[lane[1]], nvlink=[lane[2]], hot_thresh=[lane[3]])
        ms, faults = lane_ms(args)
        n = page.size
        row = {"phase": "um_step_costs", "stream": name, "n": n,
               "pages": n_pages, "frames": lane[0], "chunk": lane[1],
               "nvlink": lane[2], "faults": faults, "kernel_ms": ms,
               "cycles_per_step": cyc(ms) / n}
        if name.startswith("warm_"):
            warm[name[5:]] = (ms, n, faults)
        elif name.startswith("hit_"):
            w_ms, w_n, w_f = warm[name[4:]]
            need(faults == w_f, f"{name}: {faults - w_f} faults after the "
                 "warm-up")
            row["cycles_per_hit_step"] = cyc(ms - w_ms) / (n - w_n)
        else:
            need(faults == n, f"{name}: {n - faults} steps did not migrate")
        emit(row)
    if traces is None:
        traces = {(w, None): T.make_trace(w) for w in sorted(T.WORKLOADS)}
    for (w, n), t in traces.items():
        if n is not None:
            continue
        cfg = T.HMSConfig(footprint=t.footprint, organization="hbm")
        _, n_pages = um_engine._page_stream(t)
        if um_engine.um_spec(cfg).n_frames >= n_pages:
            continue                 # early-out: HBM holds the footprint
        for nv in (False, True):
            spec = um_engine.um_spec(cfg, nv)
            args = um_engine.scan_args(t, [spec], dev)
            ms, faults = lane_ms(args)
            emit({"phase": "um_step_costs", "stream": w, "n": t.n,
                  "pages": n_pages, "frames": spec.n_frames,
                  "chunk": spec.chunk, "nvlink": nv, "faults": faults,
                  "migrating_share": faults / t.n, "kernel_ms": ms,
                  "ns_per_step": ms * 1e6 / t.n,
                  "cycles_per_step": cyc(ms) / t.n})


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


def piece_bounds(flops: float, nbytes: float):
    """(bound_ms, bound_by, the three bounds) of a float32 kernel on the
    tensor cores: each product as F32_PIECE_PRODUCTS bf16 products at the
    bf16 peak (``tensor_bound_ms``) against the bytes; the FMA pipes'
    float32 rate beside them (``fma_bound_ms``)."""
    t_ops = F32_PIECE_PRODUCTS * flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            {"fma_bound_ms": flops / PEAK_FLOPS["float32"] * 1e3,
             "tensor_bound_ms": t_ops, "bytes_bound_ms": t_bytes})


def flash_row(torch, dev, g, case, B, S, T, causal, cap, H, KV, hd, dt,
              flush) -> dict:
    """flash_attention against its plain version on one random input set:
    emits and returns its ``kernel_vs_plain`` row (see ``flash_checks``)."""
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (torch.randn(B, n, h, hd, generator=g, device=dev).to(dt)
               for n, h in ((S, H), (T, KV), (T, KV)))
    run_k = lambda: ops.flash_attention(q, k, v, causal=causal, softcap=cap)
    run_p = lambda: ref.flash_attention_reference(q, k, v, causal=causal,
                                                  softcap=cap)
    _build.reset_counts()
    got = run_k()
    designs = [n.split(".")[1] for n, c in _build.launches.items()
               if n.startswith("flash_attention.") and c]
    want = run_p()
    torch.cuda.synchronize()
    err = close(torch, got, want, f"flash_attention {case}")
    need(designs == [ops.DESIGNS[dt]], f"flash_attention {case}: ran "
         f"{designs}, expected the {ops.DESIGNS[dt]} kernel for {dt}")
    # (query, key) pairs this run's masks keep
    pairs = sum(min(T, s + T - S + 1) for s in range(S)) if causal \
        else S * T
    flops = 4 * B * H * hd * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(flops, nbytes, dt)
    extra = {}
    if dt == torch.float32:
        piece_ms, piece_by, extra = piece_bounds(flops, nbytes)
        extra["blocks_per_sm"] = None
        if designs == ["mma3"]:        # else an older checkout's FMA kernel
            extra["blocks_per_sm"] = ops.blocks_per_sm(hd)
            bound_ms, bound_by = piece_ms, piece_by
    event_ms(torch, run_k, reps=3, flush=flush)             # warm-up
    library_ms = None
    if cap == 0.0:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if S == T or not causal:
            run_l = lambda: sdpa(qt, kt, vt, is_causal=causal,
                                 enable_gqa=True)
        else:                            # SDPA aligns is_causal top-left
            mask = torch.arange(T, device=dev)[None, :] \
                <= torch.arange(S, device=dev)[:, None] + (T - S)
            run_l = lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                 enable_gqa=True)
        # float32: SDPA with TF32 off for matmuls and cuDNN, as the kernel
        # keeps float32's accuracy
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
    row = {"name": "flash_attention", "case": case, "design": designs[0],
           "shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd},
           "dtype": dtype_name(dt), "causal": causal, "softcap": cap,
           "max_abs_err": err,
           "ms": event_ms(torch, run_k, reps=20, flush=flush),
           "plain_ms": event_ms(torch, run_p, reps=3, flush=flush),
           "bound_ms": bound_ms, "bound_by": bound_by, **extra,
           "library_ms": library_ms}
    emit({"phase": "kernel_vs_plain", **row})
    return row


def flash_checks(torch, dev, flush):
    """flash_attention against its plain version, every case in bf16 and in
    float32; returns the bf16 slice row.  Each row names the design that
    ran, read from the launch counts of its own call, which must be the
    one ``ops.DESIGNS`` names for the type (bf16: the wgmma kernel,
    float32: the three-piece mma kernel).  float32 rows give three bounds:
    ``bound_ms`` at the tensor cores' bf16 rate for the six piece products
    of the three-piece design (``F32_PIECE_PRODUCTS``; the larger of it and
    the bytes), ``fma_bound_ms`` at the FMA pipes' float32 rate, and
    ``bytes_bound_ms``, and the kernel's CTAs per SM.  SDPA (TF32 off for
    float32) is timed beside every case without a softcap.  A copy of this
    script beside another checkout's ``src/`` measures that checkout's
    kernels (``--only flash``)."""
    g = torch.Generator(device=dev).manual_seed(12)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    qwen = (16, 2, 128)                 # qwen2.5-3b: H, KV, hd
    zamba = (32, 32, 80)                # zamba2-2.7b's shared block
    cases = (
        ("slice", 4, 1024, 1024, True, 0.0, qwen),
        ("ragged", 2, 130, 200, True, 0.0, qwen),
        ("non_causal", 4, 1024, 1024, False, 0.0, qwen),
        ("softcap_30", 4, 1024, 1024, True, 30.0, qwen),
        ("zamba2_hd80", 4, 1024, 1024, True, 0.0, zamba),
        ("zamba2_hd80_ragged", 4, 11, 11, True, 0.0, zamba),
        ("hd16", 2, 256, 256, True, 0.0, (4, 2, 16)),
        ("hd32", 2, 256, 256, True, 0.0, (4, 2, 32)),
        ("hd64", 2, 256, 256, True, 0.0, (4, 2, 64)),
        ("edges_1000", 4, 1000, 1000, True, 0.0, qwen),
        ("right_aligned_512_1024", 4, 512, 1024, True, 0.0, qwen),
        ("launcher_11", 4, 11, 11, True, 0.0, qwen))
    for (base, B, S, T, causal, cap, (H, KV, hd)), dt in (
            (c, dt) for c in cases for dt in (bf16, f32)):
        case = base if dt == bf16 else base + "_float32"
        rows[case] = flash_row(torch, dev, g, case, B, S, T, causal, cap, H,
                               KV, hd, dt, flush)
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


# the split mode of paged_attention (a cache split over the model axis by
# head dim): (model, B, H, KV, hd) at full width, the slices d of hd it
# is held at, over the identity table of a dense 2048-token cache with
# 1055 live tokens a row (the 1024-token mix's)
PAGED_SPLIT_MODELS = (("qwen2.5-3b", 4, 16, 2, 128),
                      ("granite-8b", 4, 32, 8, 128))
PAGED_SPLIT_SLICES = (8, 32, 64)


def paged_split_checks(torch, dev, flush) -> list:
    """The split mode's two launches against their plain versions, bf16
    and float32, at PAGED_SPLIT_MODELS x PAGED_SPLIT_SLICES: the scores
    (a rank's slice of every head's q . k, float32, to ATTN_TOL float32:
    exact products, sums in another order; over the live tokens, the only
    ones the kernel writes) and the apply (the softmax of
    whole-head scores and its product with the slice of V, to the type's
    ATTN_TOL).  Each row gives its time, bytes bound, launches and, for
    the scores, ``torch.matmul`` of q by the dense cache's K^T (the apply
    has no single PyTorch call).  Returns the rows."""
    from repro_torch import _build
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models import layers
    g = torch.Generator(device=dev).manual_seed(31)
    rows = []
    max_len, pos = 2048, 1054
    for dt in (torch.bfloat16, torch.float32):
        name = dtype_name(dt)
        esize = torch.tensor([], dtype=dt).element_size()
        for model, B, H, KV, hd in PAGED_SPLIT_MODELS:
            G = H // KV
            table, lengths = layers.decode_pages(B, max_len, pos, dev)
            page = layers.DECODE_PAGE
            q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dt)
            kc, vc = (torch.randn(B, max_len, KV, hd, generator=g,
                                  device=dev).to(dt) for _ in range(2))
            pool = (B * max_len // page, page, KV, hd)
            whole = ref.paged_scores_reference(
                q.reshape(B, KV, G, hd), kc.view(pool), table, lengths)
            tokens = int(lengths.sum())
            pages = int(((lengths + page - 1) // page).sum())
            for d in PAGED_SPLIT_SLICES:
                qs = q[..., :d].contiguous()
                ks, vs = (x[..., :d].contiguous().view(
                    B * max_len // page, page, KV, d) for x in (kc, vc))
                shape = {"B": B, "H": H, "KV": KV, "hd": hd, "slice": d,
                         "page": page, "n_pages": table.shape[1]}
                # scores
                run_k = lambda: ops.paged_decode_scores(qs, ks, table,
                                                        lengths)
                run_p = lambda: ref.paged_scores_reference(
                    qs.reshape(B, KV, G, d), ks, table, lengths)
                _build.reset_counts()
                got = run_k()
                launches = _build.launches.get("paged_attention_scores", 0)
                need(launches == 1, f"paged scores {model}: {launches} "
                     "launches a call")
                # the kernel writes the live tokens' scores only
                live = (torch.arange(table.shape[1] * page, device=dev)
                        < lengths[:, None])
                err = close(torch, got.transpose(1, 2)[live],
                            run_p().transpose(1, 2)[live],
                            f"paged scores {model} {name} d {d}")
                kd = ks.view(B, max_len, KV, d).transpose(1, 2).contiguous()
                qg = qs.reshape(B, KV, G, d)
                run_l = lambda: torch.matmul(qg, kd.transpose(-1, -2))
                b_ms, b_by = bound(
                    2 * H * d * tokens,
                    q.numel() // hd * d * esize + tokens * KV * d * esize
                    + 4 * H * tokens + 4 * pages + 4 * B, dt)
                event_ms(torch, run_k, reps=3, flush=flush)
                row = {"name": "paged_attention_scores", "model": model,
                       "case": f"{model}_slice_{d}_{name}", "dtype": name,
                       "shape": shape, "live_tokens": tokens,
                       "launches": launches, "max_abs_err": err,
                       "ms": event_ms(torch, run_k, reps=20, flush=flush),
                       "plain_ms": event_ms(torch, run_p, reps=3,
                                            flush=flush),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": event_ms(torch, run_l, reps=20,
                                              flush=flush)}
                emit({"phase": "kernel_vs_plain", **row})
                rows.append(row)
                # apply, on the whole heads' scores
                scale = 1.0 / math.sqrt(hd)
                run_k = lambda: ops.paged_decode_apply(
                    whole, vs, table, lengths, scale=scale)
                run_p = lambda: ref.paged_apply_reference(
                    whole, vs, table, lengths, scale=scale).reshape(
                        B, 1, H, d)
                _build.reset_counts()
                got = run_k()
                launches = _build.launches.get("paged_attention_apply", 0)
                err = close(torch, got, run_p(),
                            f"paged apply {model} {name} d {d}")
                b_ms, b_by = bound(
                    2 * H * d * tokens,
                    4 * H * tokens + tokens * KV * d * esize
                    + B * H * d * esize + 4 * pages + 4 * B, dt)
                event_ms(torch, run_k, reps=3, flush=flush)
                row = {"name": "paged_attention_apply", "model": model,
                       "case": f"{model}_slice_{d}_{name}", "dtype": name,
                       "shape": shape, "live_tokens": tokens,
                       "launches": launches, "max_abs_err": err,
                       "ms": event_ms(torch, run_k, reps=20, flush=flush),
                       "plain_ms": event_ms(torch, run_p, reps=3,
                                            flush=flush),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None}
                emit({"phase": "kernel_vs_plain", **row})
                rows.append(row)
                need(launches == 1, f"paged apply {model}: {launches} "
                     "launches a call")
    return rows


SSD_MAMBA = (64, 1, 128, 64)          # H, G, n, p of mamba2-1.3b
SSD_ZAMBA = (80, 1, 64, 64)           # of zamba2-2.7b
SSD_SMOKE = (8, 1, 16, 16)            # of both smoke configs


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
    hands them over.  Each row names the design that ran (from the launch
    counts: the wrapper's ``ops.DESIGNS`` for the type, and bf16 must be
    the tensor-core ``mma`` kernel) and its CTAs per SM.  float32 rows give
    two bounds: ``bound_ms`` at the tensor cores' bf16 rate for the six
    piece products a term of the three-piece design
    (``F32_PIECE_PRODUCTS``), and ``fma_bound_ms`` at the FMA pipes' float32
    rate for the plain operation count.  Returns the mamba2 bf16 row."""
    from repro_torch import _build
    from repro_torch.kernels.ssd_scan import ops, ref
    g = torch.Generator(device=dev).manual_seed(15)
    bf16, f32 = torch.bfloat16, torch.float32
    need(ops.DESIGNS[bf16] == "mma", "ssd: bf16 is not the mma design")
    mamba, zamba, smoke = SSD_MAMBA, SSD_ZAMBA, SSD_SMOKE
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
        want = ops.DESIGNS[dt_]
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
        bounds = {}
        if dt_ == bf16:
            bound_ms, bound_by = bound(flops, nbytes, bf16)
        else:
            bound_ms, bound_by, bounds = piece_bounds(flops, nbytes)
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
               "bound_ms": bound_ms, "bound_by": bound_by,
               **bounds, "library_ms": None}
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
    attention layer runs flash_attention in prefill (only through the
    design of the model's type, ``flash_ops.DESIGNS``: bf16 the wgmma
    kernel, float32 the three-piece mma kernel; the
    ``flash_attention.<design>`` counts) and paged_attention, one launch,
    in decode; the moe's blocks likewise (the experts are batched
    products); the vlm's vision layers add one flash_attention each to
    prefill; the encdec's encoder layers and its decoder's cross-attention
    add one each to prefill, and its cross-attention one flash_attention a
    layer to every decode step (one query over the cached encoder K/V);
    every Mamba2 layer runs ssd_scan in prefill (only through the design of
    the model's type, ``ssd_ops.DESIGNS``: the ``ssd_scan.<design>``
    counts; its decode step is plain torch ops); the hybrid applies its
    shared attention block after every ``attn_every`` Mamba2 layers."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    L = cfg.n_layers
    design = "flash_attention." + flash_ops.DESIGNS[cfg.torch_dtype]

    def flash(n):
        return {"flash_attention": n, design: n}
    ssd = {"ssd_scan": L,
           "ssd_scan." + ssd_ops.DESIGNS[cfg.torch_dtype]: L}
    if cfg.family in ("dense", "moe"):
        return flash(L), {"paged_attention": L}
    if cfg.family == "vlm":
        return flash(cfg.n_vision_layers + L), {"paged_attention": L}
    if cfg.family == "encdec":
        return flash(cfg.n_enc_layers + 2 * L), \
            {"paged_attention": L, **flash(L)}
    if cfg.family == "ssm":
        return ssd, {}
    n_attn = L // cfg.attn_every
    return {**ssd, **flash(n_attn)}, {"paged_attention": n_attn}


def image_positions(cfg) -> int:
    """Positions ahead of each prompt: the vlm's image patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def stub_inputs(torch, cfg, B: int, seed=None) -> dict:
    """The encdec's audio frames and the vlm's image patches for a batch of
    B, float32 on the CPU: the engine's zeros (``engine.stub_inputs``), or
    (``seed``) standard normal draws of the same shapes, which drive the
    encoders."""
    from repro_torch.serving import engine
    zeros = engine.stub_inputs(cfg, B, "cpu")
    if seed is None:
        return zeros
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) for k, v in zeros.items()}


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


# the utility ops the profiler leaves out of its events (torch's
# profiler_util._filter_name)
PROFILER_SKIPPED = {"[memory]", "[OutOfMemory]",
                    "profiler::_record_function_enter",
                    "profiler::_record_function_enter_new",
                    "profiler::_record_function_exit", "aten::is_leaf",
                    "aten::output_nr", "aten::_version"}


def raw_events(prof) -> list:
    """A profiler window's records as the profiler keeps them (its own
    filter applied), read straight from its kineto results: the events
    ``prof.events()`` would build, without building them (~80 us a
    record in Python, seconds for a window of thousands of aten calls).
    Cached on ``prof``."""
    if not hasattr(prof, "_smoke_raw"):
        prof._smoke_raw = [
            e for e in prof.profiler.kineto_results.events()
            if e.name() not in PROFILER_SKIPPED
            and not getattr(e, "is_hidden_event", lambda: False)()]
    return prof._smoke_raw


def device_records(torch, prof) -> list:
    """(name, start ns, ms) of each device record in a window."""
    return [(e.name(), e.start_ns(), e.duration_ns() / 1e6)
            for e in raw_events(prof)
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def aten_ops(torch, prof) -> int:
    """The window's aten calls as the profiler's event tree counts them
    (torch's EventList._build_tree): the synchronous CPU records of a
    thread nested by interval, and a record whose parent has the same
    name and no other child merged into that parent."""
    cpu = torch.autograd.DeviceType.CPU
    nodes = [{"name": e.name(), "start": e.start_ns(), "end": e.end_ns(),
              "thread": e.start_thread_id(), "parent": None, "kids": [],
              "sync": e.device_type() == cpu and not e.is_async()
              and e.start_thread_id() == e.end_thread_id(),
              "cpu": e.device_type() == cpu} for e in raw_events(prof)]
    by_thread = sorted((n for n in nodes if n["sync"]),
                       key=lambda n: n["thread"])
    for _, group in itertools.groupby(by_thread, key=lambda n: n["thread"]):
        stack = []
        for n in sorted(group, key=lambda n: (n["start"], -n["end"])):
            while stack and (n["start"] >= stack[-1]["end"]
                             or n["end"] > stack[-1]["end"]):
                stack.pop()
            if stack:
                stack[-1]["kids"].append(n)
                n["parent"] = stack[-1]
            stack.append(n)
    nodes.sort(key=lambda n: (n["start"], -n["end"]))
    while True:
        gone = set()
        for i, n in enumerate(nodes):
            up = n["parent"]
            if up is not None and up["name"] == n["name"] \
                    and len(up["kids"]) == 1:
                up["kids"] = n["kids"]
                for k in n["kids"]:
                    k["parent"] = up
                gone.add(i)
        if not gone:
            break
        nodes = [n for i, n in enumerate(nodes) if i not in gone]
    return sum(1 for n in nodes
               if n["cpu"] and n["name"].startswith("aten::"))


def kernel_ms(torch, prof):
    """{kernel name: device ms} summed over a profiler window."""
    kernels = {}
    for name, _, ms in device_records(torch, prof):
        kernels[name] = kernels.get(name, 0.0) + ms
    return kernels


def kernel_count(torch, prof, needle: str) -> int:
    """Device kernels in a profiler window whose name holds ``needle``."""
    return sum(1 for name, _, _ in device_records(torch, prof)
               if needle in name)


def window_records(torch, prof, needle: str) -> dict:
    """The device kernels a profiler window recorded and the positions of
    ``needle``'s among them in start order: where a record went missing."""
    kern = sorted(device_records(torch, prof), key=lambda r: r[1])
    return {"kernels": len(kern),
            "needle_positions": [i for i, r in enumerate(kern)
                                 if needle in r[0]]}


def decode_profile(torch, dev, model, cfg, scfg, traffic, name, steps=3,
                   retries=2):
    """torch.profiler over one prefill and then ``steps`` decode steps of
    the traffic's first batch (zero frames or patches, as the engine
    passes them): wall time, device (kernel) time, the
    device's busy share, and the kernels that take the most of it.  Device
    time is None when the profiler records no kernel on this machine.
    Where the kernel counts miss their expected values, both windows are
    profiled again, up to ``retries`` times (the tracer can drop a
    record), and the last pair's counts must match."""
    import numpy as np
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import Request
    reqs = traffic(Request, cfg.vocab)[:scfg.max_batch]
    S = max(r.prompt.shape[0] for r in reqs)
    toks = np.zeros((len(reqs), S), np.int32)
    for i, r in enumerate(reqs):
        toks[i, S - r.prompt.shape[0]:] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             **{k: v.to(dev) for k, v in stub_inputs(
                 torch, cfg, len(reqs)).items()}}
    S += image_positions(cfg)
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
    cpu_ops = aten_ops(torch, prof)
    pdev = sum(pkern.values()) if pkern else None
    # the device's own count of the attention kernels, where the profiler
    # saw kernels at all: prefill through the design of the model's type
    # only, decode through one paged kernel per attention layer and step
    per_prefill, per_decode = path_launches(cfg)
    counts = {"prefill_flash_wgmma": kernel_count(torch, pprof,
                                                  "flash_wgmma_kernel"),
              "prefill_flash_mma3": kernel_count(torch, pprof,
                                                 "flash_mma3_kernel"),
              "prefill_ssd_mma": kernel_count(torch, pprof, "ssd_mma_kernel"),
              "prefill_ssd_mma3": kernel_count(torch, pprof,
                                               "ssd_mma3_kernel"),
              "decode_paged": kernel_count(torch, prof, "paged_kernel"),
              "decode_flash_wgmma": kernel_count(torch, prof,
                                                 "flash_wgmma_kernel")}
    want = {"prefill_flash_wgmma": per_prefill.get("flash_attention.wgmma",
                                                   0),
            "prefill_flash_mma3": per_prefill.get("flash_attention.mma3",
                                                  0),
            "prefill_ssd_mma": per_prefill.get("ssd_scan.mma", 0),
            "prefill_ssd_mma3": per_prefill.get("ssd_scan.mma3", 0),
            "decode_paged": per_decode.get("paged_attention", 0) * steps,
            "decode_flash_wgmma": per_decode.get("flash_attention.wgmma", 0)
            * steps}
    off = [k for k in counts
           if (pkern if k.startswith("prefill") else kernels)
           and counts[k] != want[k]]
    if off and retries:
        emit({"phase": "decode_profile_retry", "model": cfg.name,
              "traffic": name, "device_kernel_counts": counts,
              "expected": want,
              "prefill_records": window_records(torch, pprof,
                                                "flash_wgmma_kernel"),
              "decode_records": window_records(torch, prof,
                                               "paged_kernel")})
        return decode_profile(torch, dev, model, cfg, scfg, traffic, name,
                              steps, retries - 1)
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
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        from repro_torch.kernels.ssd_scan import ref as ssd_ref
        from repro_torch.models import layers

        def paged(q, kp, vp, table, lengths, softcap=0.0):
            B, _, H, hd = q.shape
            return paged_ref.paged_attention_reference(
                q.reshape(B, kp.shape[2], H // kp.shape[2], hd), kp, vp,
                table, lengths, softcap=softcap).reshape(q.shape)
        self.swaps = [(layers, "flash_attention",
                       flash_ref.flash_attention_reference),
                      (layers, "paged_decode_attention", paged),
                      # the forward of ops.SSD, which the Mamba2 layer calls
                      (ssd_ops, "ssd", ssd_ref.ssd_plain)]

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n, _ in self.swaps]
        for m, n, f in self.swaps:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for (m, n, _), f in zip(self.swaps, self.saved):
            setattr(m, n, f)


class routing:
    """Within it, the MoE layers' expert choices (``moe._top_k``) are
    recorded in ``routes``, one (tokens, k) tensor a layer call, or, given
    ``replay`` (another run's ``routes``), taken from it, the weights
    gathered from this run's own router probabilities.  With the float32
    run's choices replayed, a bf16 run's logits differ from the float32
    ones by rounding alone, not by a near tie that bf16 resolves to
    another expert (a flip moves a token's output by a whole expert's)."""

    def __init__(self, replay=None):
        self.replay, self.routes = replay, []

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.orig = moe, moe._top_k

        def top_k(probs, k):
            if self.replay is None:
                w, e = self.orig(probs, k)
            else:
                e = self.replay[len(self.routes)].to(probs.device)
                w = probs.gather(-1, e)
            self.routes.append(e.cpu())
            return w, e
        moe._top_k = top_k
        return self

    def __exit__(self, *exc):
        self.mod._top_k = self.orig


def route_flips(a, b) -> int:
    """(token, choice) pairs routed to another expert in run a than in b."""
    return int(sum(int((x != y).sum()) for x, y in zip(a.routes, b.routes)))


def logit_run(torch, model, cfg, where, toks, feed=None, inputs=None):
    """Logits of one prefill of ``toks`` (with ``inputs``, the stub frames
    or patches) and three decode steps at the positions after the prompt
    and any image positions, each fed the given tokens (or the run's own
    argmax); returns (logits on the CPU in float32, the tokens fed)."""
    from repro_torch.models import decode_step, prefill
    start = toks.shape[1] + image_positions(cfg)
    batch = {"tokens": toks.to(where),
             **{k: v.to(where) for k, v in (inputs or {}).items()}}
    logits, cache = prefill(model, batch, cfg,
                            max_len=max(32, -(-(start + 3) // 16) * 16))
    outs, fed = [logits.float().cpu()], []
    for i, pos in enumerate(range(start, start + 3)):
        tok = feed[i] if feed is not None else \
            outs[-1].argmax(-1, keepdim=True).to(torch.int32)
        fed.append(tok)
        logits, cache = decode_step(model, tok.to(where), cache, pos, cfg)
        outs.append(logits.float().cpu())
    return outs, fed


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def rms_diff(a, b) -> float:
    """Root mean square of the differences over every logit of the runs."""
    sq = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
    return (sq / sum(x.numel() for x in a)) ** 0.5


def bf16_distances(torch, card, host, cfg, dev, toks, inputs) -> dict:
    """The bf16 model ``card`` (on the card) and its copy ``host`` (on the
    CPU) against a float32 copy of the same weights on the CPU, over
    ``logit_run``s fed the CPU bf16 run's tokens: ``max_logit_diff`` (card
    against CPU), ``logit_scale``, each path's distance from float32 by
    the max norm and by RMS (``*_rms``), and the card with the plain
    versions of its kernels against the CPU.  For the moe the same are
    taken again on runs that replay the float32 run's expert choices
    (``routing``), and the free runs' values keep a ``free_`` prefix
    beside their routing flips."""
    import copy
    import dataclasses

    def runs(replay=None):
        with routing(replay) as rh:
            lh, feed = logit_run(torch, host, cfg, "cpu", toks,
                                 inputs=inputs)
        with routing(replay) as rc:
            lc, _ = logit_run(torch, card, cfg, dev, toks, feed, inputs)
        with routing(replay), plain_kernels(torch):
            lp, _ = logit_run(torch, card, cfg, dev, toks, feed, inputs)
        return lh, lc, lp, feed, rh, rc

    def distances(lh, lc, lp, l32):
        return {"max_logit_diff": max_diff(lc, lh),
                "logit_scale": float(lh[-1].abs().max()),
                "card_vs_float32": max_diff(lc, l32),
                "cpu_vs_float32": max_diff(lh, l32),
                "card_vs_float32_rms": rms_diff(lc, l32),
                "cpu_vs_float32_rms": rms_diff(lh, l32),
                "card_plain_vs_cpu": max_diff(lp, lh)}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    host32 = copy.deepcopy(host).float()
    lh, lc, lp, feed, rh, rc = runs()
    with routing() as r32:
        l32, _ = logit_run(torch, host32, cfg32, "cpu", toks, feed, inputs)
    out = distances(lh, lc, lp, l32)
    if cfg.family == "moe":
        out = {"free_" + k: v for k, v in out.items()}
        out["route_flips"] = {"card_vs_cpu": route_flips(rc, rh),
                              "card_vs_float32": route_flips(rc, r32),
                              "cpu_vs_float32": route_flips(rh, r32)}
        lh, lc, lp, _, _, _ = runs(r32.routes)
        out.update(distances(lh, lc, lp, l32), routing="float32 run's")
    return out


def serve_card_vs_cpu(torch, dev, arch: str, n_layers: int,
                      dtype: str = "float32", scfg=None, **cuts) -> dict:
    """``arch`` at full width cut to ``n_layers`` (and ``cuts``, e.g. the
    vision tower's depth), TF32 off for matmuls and cuDNN: the card against
    the port's CPU path on the same weights, the logits of a prefill (with
    seeded random frames or patches, which drive the encoders; the
    engine's zeros do not) and 3 decode steps fed the same tokens.
    float32: the launcher's requests served on both (``scfg``, default
    ``ServeConfig()``) give the same tokens and KV stats.  bf16 (the
    card's prefill attention is the wgmma kernel): the largest logit
    difference within BF16_LOGIT_TOL of the logit scale wherever bf16
    itself allows it, i.e. wherever the CPU path's bf16 logits stay that
    close to its float32 logits of the same weights; and always the card's
    bf16 logits no further than BF16_VS_CPU times the CPU path's from those
    float32 logits (``bf16_distances``).  For the moe, both rules judge
    runs that replay the float32 run's expert choices (``routing``), since
    a near tie that two paths round apart sends a token to another expert
    (``--only bf16_spread``: seeds whose bf16 runs land 1.77 and 7.75 from
    each other that way), and the second rule reads RMS distances: the
    moe's large residual stream (experts drawn at 1 / sqrt(E)) makes the
    max norm's ratio swing by +-35% between seeds even without a flip, the
    RMS ratio by under 10%.  The free runs' differences and their routing
    flips are shown beside them, and the card with the plain versions in
    place of its kernels."""
    import copy
    import dataclasses
    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import Transformer
    from repro_torch.serving import Engine, Request, ServeConfig
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype=dtype, **cuts)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = Transformer(cfg, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        host = copy.deepcopy(card).to("cpu")
        outs, stats, launches = [], [], {}
        for model, where in ((card, dev), (host, "cpu")):
            if dtype != "float32":
                break                   # bf16 tokens may differ: not served
            eng = Engine(cfg, model, scfg or ServeConfig(), device=where)
            for r in launcher_traffic(Request, cfg.vocab):
                eng.submit(r)
            _build.reset_counts()
            outs.append(eng.run())
            if where == dev:
                torch.cuda.synchronize()
                launches = {k: v for k, v in _build.launches.items() if v}
            stats.append(eng.kv_stats)
        toks = torch.randint(1, cfg.vocab, (4, 12), generator=torch.Generator(
        ).manual_seed(2), dtype=torch.int32)
        inputs = stub_inputs(torch, cfg, toks.shape[0], seed=3)
        extra = {}
        if dtype == "float32":
            lh, feed = logit_run(torch, host, cfg, "cpu", toks,
                                 inputs=inputs)
            lc, _ = logit_run(torch, card, cfg, dev, toks, feed, inputs)
            diff, scale = max_diff(lc, lh), float(lh[-1].abs().max())
        else:
            extra = bf16_distances(torch, card, host, cfg, dev, toks, inputs)
            diff, scale = extra.pop("max_logit_diff"), \
                extra.pop("logit_scale")
        del card, host
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    row = {"phase": "serve_card_vs_cpu", "model": cfg.name,
           "family": cfg.family, "n_layers": n_layers, "cuts": cuts,
           "dtype": dtype, "allow_tf32": False,
           "max_logit_diff": diff, "logit_scale": scale, **extra}
    if dtype == "float32":
        same_tokens = sorted(outs[0]) == sorted(outs[1]) and all(
            (outs[0][k] == outs[1][k]).all() for k in outs[0])
        row.update(requests=len(outs[0]), tokens_equal=bool(same_tokens),
                   kv_stats_equal=stats[0] == stats[1], kv_stats=stats[0],
                   launches=launches)
        emit(row)
        ssd = launches.get("ssd_scan", 0)
        need(cfg.family not in ("ssm", "hybrid") or (
            ssd > 0 and launches.get(
                "ssd_scan." + ssd_ops.DESIGNS[torch.float32], 0) == ssd),
             f"{cfg.name}: float32 ssd_scan launches {launches}")
        flash = launches.get("flash_attention", 0)
        need(cfg.family == "ssm" or (
            flash > 0 and launches.get(
                "flash_attention." + flash_ops.DESIGNS[torch.float32],
                0) == flash),
             f"{cfg.name}: float32 flash_attention launches {launches}")
        need(same_tokens, f"{cfg.name}: card and CPU generate different "
             f"tokens (max logit difference {diff} over logits up to "
             f"{scale})")
        need(stats[0] == stats[1], f"{cfg.name}: KV stats differ: {stats}")
        return row
    tol = BF16_LOGIT_TOL * scale
    norm = "_rms" if cfg.family == "moe" else ""
    row.update(logit_tol=tol,
               logit_tol_applies=extra["cpu_vs_float32"] <= tol,
               vs_cpu_norm="rms" if norm else "max")
    emit(row)
    need(not row["logit_tol_applies"] or diff <= tol,
         f"{cfg.name} bf16: max logit difference {diff} beyond "
         f"{BF16_LOGIT_TOL} of the logit scale {scale}")
    card_d, cpu_d = (extra[k + "_vs_float32" + norm] for k in ("card", "cpu"))
    need(card_d <= BF16_VS_CPU * cpu_d,
         f"{cfg.name} bf16: the card's logits are {card_d} from the float32 "
         f"run ({row['vs_cpu_norm']}), the CPU path's {cpu_d}")
    return row


def bf16_spread(torch, dev, seeds=range(1, 9)) -> None:
    """``--only bf16_spread``: ``bf16_distances`` of the 2-layer bf16 cuts
    of phi3.5-moe-42b and qwen2.5-3b over weight seeds (the serving check
    uses seed 1), one line a seed: how far the ratio of the card's to the
    CPU path's distance from float32 swings by the max norm and by RMS,
    with free and (moe) replayed routing."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in ("phi3.5-moe-42b", "qwen2.5-3b"):
            cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                      dtype="bfloat16")
            for seed in seeds:
                card = Transformer(cfg, generator=torch.Generator(
                    device=dev).manual_seed(seed), device=dev)
                host = copy.deepcopy(card).to("cpu")
                toks = torch.randint(1, cfg.vocab, (4, 12),
                                     generator=torch.Generator(
                                     ).manual_seed(2), dtype=torch.int32)
                d = bf16_distances(torch, card, host, cfg, dev, toks, {})
                row = {"phase": "bf16_spread", "model": cfg.name,
                       "seed": seed, **d}
                for pre in ("", "free_"):
                    if pre + "cpu_vs_float32" in d:
                        for norm in ("", "_rms"):
                            row[f"{pre}ratio{norm or '_max'}"] = \
                                d[f"{pre}card_vs_float32{norm}"] / \
                                d[f"{pre}cpu_vs_float32{norm}"]
                emit(row)
                del card, host
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


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


# the families phase: (arch, decoder layers served, the launcher mix's and
# the long mix's max_len).  phi3.5-moe-42b's 32 layers hold 83.7 GB of bf16
# weights, more than the card's 80 GB: its depth is cut to 24 (62.9 GB) at
# published widths.  A vlm slot holds n_patches + prompt + new tokens of
# every batch (the engine never releases a slot): pixtral's ~2,100 of the
# launcher mix's two batches and 2,080 of the long mix's one.
FAMILY_MODELS = (("phi3.5-moe-42b", 24, 256, 2048),
                 ("pixtral-12b", 40, 4096, 4096),
                 ("whisper-tiny", 4, 256, 2048))
# flash_attention at the families' new shapes (B, S, T, (H, KV, hd)), all
# non-causal: whisper-tiny's encoder over its 1500 frames, pixtral-12b's
# vision tower over its 1024 patches, and whisper's cross-attention in
# prefill (the launcher's 11 tokens) and in decode (one query)
FAMILY_FLASH = (("whisper_encoder", 4, 1500, 1500, (6, 6, 64)),
                ("pixtral_vision", 4, 1024, 1024, (16, 16, 64)),
                ("whisper_cross_prefill_11", 4, 11, 1500, (6, 6, 64)),
                ("whisper_cross_decode_1", 4, 1, 1500, (6, 6, 64)))


def families_phase(torch, dev, flush):
    """The moe, vlm and encdec families at published widths, bf16, random
    weights from seed 0: phi3.5-moe-42b (24 of its 32 layers), pixtral-12b
    (40 decoder and 24 vision layers) and whisper-tiny (4 + 4 layers,
    1500 frames), each on the launcher's mix and the long mix (``serve``:
    launches against ``path_launches``; ``decode_profile``), each freed
    before the next is made.  Then flash_attention at the new shapes
    (FAMILY_FLASH, bf16 and float32) and paged_attention on the identity
    table of phi's long-mix cache (32 over 8 heads, hd 128), each against
    its plain version; then the cuts on card and CPU: phi3.5-moe at 1
    layer (its CPU path holds 16 experts at full width a layer), pixtral
    at 1 decoder and 1 vision layer (its CPU path at 1024 patches and full
    width is the slowest of the cuts), whisper-tiny
    whole, float32 and bf16.  Returns (the launches of the serving runs summed,
    the flash and paged rows)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, layers
    from repro_torch.serving import ServeConfig
    total, paged = {}, None
    for arch, n_layers, len_a, len_b in FAMILY_MODELS:
        published = get_config(arch)
        cfg = dataclasses.replace(published, n_layers=n_layers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = Transformer(cfg, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        emit({"phase": "serve_model", "model": cfg.name,
              "family": cfg.family, "n_layers": n_layers,
              "published_n_layers": published.n_layers,
              "params": sum(p.numel() for p in model.parameters()),
              "param_bytes": sum(p.numel() * p.element_size()
                                 for p in model.parameters()),
              "init_s": time.perf_counter() - t0})
        for scfg, traffic, name in (
                (ServeConfig(max_len=len_a), launcher_traffic, "launcher"),
                (ServeConfig(max_batch=4, max_len=len_b), long_traffic,
                 "long_1024")):
            row, clock, _ = serve(torch, dev, model, cfg, scfg, traffic,
                                  name)
            for k, n in row["launches"].items():
                total[k] = total.get(k, 0) + n
            if cfg.family == "moe" and name == "long_1024":
                # layer 0 of the long mix's cache, every row at its last
                # decode position
                kc, vc = clock.cache["kv"]["k"][0], clock.cache["kv"]["v"][0]
                B, max_len, KV, hd = kc.shape
                table, lengths = layers.decode_pages(B, max_len, 1024 + 30,
                                                     dev)
                pool = (B * max_len // layers.DECODE_PAGE,
                        layers.DECODE_PAGE, KV, hd)
                q = torch.randn(B, 1, cfg.n_heads, hd,
                                generator=torch.Generator(
                                    device=dev).manual_seed(15),
                                device=dev).to(kc.dtype)
                paged = paged_row(torch, "identity_table_phi_long_cache", q,
                                  kc.view(pool), vc.view(pool), table,
                                  lengths, (kc, vc), flush)
                del kc, vc, q
            del clock
            decode_profile(torch, dev, model, cfg, scfg, traffic, name)
        del model
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(16)
    flash = [flash_row(torch, dev, g, case + suffix, B, S, T, False, 0.0, H,
                       KV, hd, dt, flush)
             for case, B, S, T, (H, KV, hd) in FAMILY_FLASH
             for dt, suffix in ((torch.bfloat16, ""),
                                (torch.float32, "_float32"))]
    for dtype in ("float32", "bfloat16"):
        serve_card_vs_cpu(torch, dev, "phi3.5-moe-42b", 1, dtype)
        serve_card_vs_cpu(torch, dev, "pixtral-12b", 1, dtype,
                          ServeConfig(max_len=4096), n_vision_layers=1)
        serve_card_vs_cpu(torch, dev, "whisper-tiny",
                          get_config("whisper-tiny").n_layers, dtype)
    return total, flash + [paged]


def scenario_baseline_checks(torch, T) -> None:
    """The 20 points of BENCH_scenarios.json through ``simulate_many`` on
    the card, as the scenarios suite runs them (the HMS and InfHBM at the
    nominal footprint, over the trace at each oversubscription level):
    each point's config digest, counters (UM overflow counters included at
    oversub 2 and 4; integer-valued ones exactly, fractional ones to rtol
    1e-9), runtime and ratios, and at oversub 1 the per-phase summary."""
    from repro_torch.resilience import sweepckpt
    base = json.loads(BASELINE_SCN.read_text())
    traces = scenario_traces(T, base)
    bad, points, overflow = [], 0, 0
    t0 = time.perf_counter()
    for name, entry in base["scenarios"].items():
        fp = entry["footprint_bytes"]
        for p in entry["sweep"]:
            t = traces[(name, p["oversub"])][0]
            hms_cfg = T.HMSConfig(footprint=fp)
            hms, inf = T.simulate_many(t, [
                hms_cfg, T.HMSConfig(footprint=fp, organization="inf_hbm")])
            what = f"{name}@{p['oversub']}"
            points += 1
            overflow += "um_faults" in hms.counters
            if sweepckpt.config_digest(hms_cfg) != p["config_digest"]:
                bad.append((what, "config_digest"))
            bad += [(what, k) for k, *_ in counter_diffs(hms.counters,
                                                         p["counters"])]
            for k, got in (("runtime_cycles", hms.runtime_cycles),
                           ("runtime_rel_inf",
                            hms.runtime_cycles / inf.runtime_cycles),
                           ("hit_rate_read", hms.hit_rate_read),
                           ("hit_rate_write", hms.hit_rate_write),
                           ("total_traffic_rel_inf", hms.total_traffic
                            / max(1.0, inf.total_traffic))):
                if not math.isclose(got, p[k], rel_tol=1e-9):
                    bad.append((what, k))
            if p["oversub"] == 1.0:
                for ph, row in entry["phases"].items():
                    got = hms.phase_summary()[ph]
                    bad += [(what, ph, k) for k, v in row.items()
                            if not math.isclose(got[k], v, rel_tol=1e-9,
                                                abs_tol=1e-9)]
    emit({"phase": "scenario_baseline", "points": points,
          "um_overflow_points": overflow, "n": base["n"],
          "wall_s": time.perf_counter() - t0,
          "traces_rebuilt_here": sum(v[1] for v in traces.values()),
          "mismatched": len(bad), "first_mismatches": [str(b)
                                                       for b in bad[:5]]})
    need(points == 20 and overflow == 10 and not bad,
         f"BENCH_scenarios.json: {points} points, {overflow} overflowing, "
         f"{len(bad)} mismatches, first {bad[:3]}")


# ---- training: the flash attention backward and the Trainer -----------------

# (case, B, S, T, causal, softcap, (H, KV, hd)): the training slice's shape,
# then the serving slice's, the masks, ragged and right-aligned rows, the
# other head dims and whisper's cross-attention
BWD_CASES = (
    ("slice", 8, 128, 128, True, 0.0, (16, 2, 128)),
    ("long_1024", 4, 1024, 1024, True, 0.0, (16, 2, 128)),
    ("non_causal", 4, 1024, 1024, False, 0.0, (16, 2, 128)),
    ("softcap_30", 4, 1024, 1024, True, 30.0, (16, 2, 128)),
    ("right_aligned_512_1024", 4, 512, 1024, True, 0.0, (16, 2, 128)),
    ("ragged_130_200", 2, 130, 200, True, 0.0, (16, 2, 128)),
    ("hd64", 2, 256, 256, True, 0.0, (4, 2, 64)),
    ("zamba2_hd80", 4, 1024, 1024, True, 0.0, (32, 32, 80)),
    ("whisper_cross_11_1500", 4, 11, 1500, False, 0.0, (6, 6, 64)))
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the backward's device kernels a call; flash_bwd_sum_kernel (the GQA sum of
# the heads' partials) runs only where H > KV
BWD_KERNELS = ("flash_bwd_dsum_kernel", "flash_bwd_dkdv_kernel",
               "flash_bwd_sum_kernel", "flash_bwd_dq_kernel")
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 128, 8, 5, 3e-4
CUT_SEQ, CUT_BATCH, CUT_LAYERS = 64, 2, 2
CUT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# steps of each cut on card and CPU (the CPU path takes 5-8 s a step at
# full width: the 151,936 x 2048 embedding), and of a cut whose steps are
# held to the CPU path's state one at a time (its one-ulp CPU run must
# have parted from the CPU path by the last)
CUT_STEPS = {"float32": 2, "bfloat16": 2}
HELD_STEPS = 3


def scaled_err(torch, got, want, tol, what) -> float:
    """max |got - want| / max |want|; raises unless finite and within
    ``tol``."""
    g, w = got.float(), want.float()
    need(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    scale = max(float(w.abs().max()), 1e-30)
    err = float((g - w).abs().max()) / scale
    need(err <= tol, f"{what}: max |kernel - plain| {err} of the largest "
         f"magnitude, beyond {tol}")
    return err


def bwd_kernels(grouped: bool) -> tuple:
    """The backward's device kernels a call: all four where the KV heads
    are shared (H > KV), else all but the sum of the heads' partials."""
    return tuple(k for k in BWD_KERNELS
                 if grouped or k != "flash_bwd_sum_kernel")


def split_ok(split: dict, want: tuple) -> bool:
    """One launch of each of the kernels ``want`` (name fragments) in a
    call's device kernels, and no other kernel."""
    return (len(split) == len(want)
            and all(sum(kn in n for n in split) == 1 for kn in want)
            and all(c == 1 for c, _ in split.values()))


def call_kernels(torch, fn, kernel: str, case: str, want: tuple,
                 windows: int = 5):
    """The device kernels of one call of ``kernel``'s wrapper ``fn`` from
    the profiler, one call a window: a window whose records do not make
    one launch of each kernel in ``want`` is profiled again, up to
    ``windows`` times (the tracer drops records now and then: the first
    kernel of a short call's window, up to twice in a row), each miss
    printed as a ``profiler_miss`` line.  Returns the last window's split
    (None: the profiler saw nothing)."""
    split = None
    for w in range(windows):
        split = call_split(torch, fn, reps=1)
        if split is None or split_ok(split, want):
            return split
        emit({"phase": "profiler_miss", "kernel": kernel, "case": case,
              "window": w, "device_kernels": split})
    return split


def parent_bwd_library(src_dir):
    """The attention backward of an earlier tree (its
    ``flash_attention_bwd.cu`` and headers in ``src_dir``; the shared ones
    from this checkout), built by nvcc into ``build/parent_bwd/`` and
    loaded, so that its time stands beside the current kernels' in one
    process; None without ``src_dir``."""
    if src_dir is None:
        return None
    import ctypes
    from repro_torch import _build
    out = ROOT / "build" / "parent_bwd"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libparent_bwd.so"
    cmd = [_build._nvcc(), *[f for f in _build.NVCC_FLAGS
                             if f != "-Xptxas=-v"],
           "-I", str(_build.SHARED_HEADERS), "-shared", "-o", str(so),
           str(Path(src_dir) / "flash_attention_bwd.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    need(r.returncode == 0, f"parent backward build failed: {r.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_launch.argtypes = [P] * 10 + [I] * 7 + [F, F, I,
                                                                   P]
    lib.flash_attention_bwd_launch.restype = I
    return lib


def parent_bwd_ms(torch, lib, q, k, v, out, lse, do, causal, cap, want,
                  flush):
    """(ms, max scaled error) of the parent tree's backward on the row's
    inputs: its time from CUDA events and its largest distance from the
    plain version, of each gradient's largest magnitude."""
    from repro_torch import _build
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    dsum = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    code = _build.dtype_code("parent_bwd", q)

    def run():
        err = lib.flash_attention_bwd_launch(
            *(t.data_ptr() for t in (q, k, v, out, do, lse, dsum, *grads)),
            B, S, T, H, KV, hd, int(causal), float(cap), 1.0 / math.sqrt(hd),
            code, _build.stream_ptr(q))
        _build.check(err, "parent flash_attention_bwd")
    run()
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max())
              / max(float(b.float().abs().max()), 1e-30)
              for a, b in zip(grads, want))
    event_ms(torch, run, reps=2, flush=flush)
    return event_ms(torch, run, reps=10, flush=flush), err


def bwd_row(torch, dev, g, case, B, S, T, causal, cap, H, KV, hd, dt,
            flush, parent=None) -> dict:
    """flash_attention's backward (dq, dk, dv) against its plain version on
    one random input set, from the forward kernel's output and log-sum-exp
    (itself held to the plain forward's), timed beside its bound, the
    backward of scaled_dot_product_attention through autograd and, given
    ``parent`` (``parent_bwd_library``), an earlier tree's backward."""
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, do = (torch.randn(B, n, h, hd, generator=g, device=dev).to(dt)
                   for n, h in ((S, H), (T, KV), (T, KV), (S, H)))
    out, lse = ops.flash_attention_forward(q, k, v, causal=causal,
                                           softcap=cap, with_lse=True)
    _, lse_p = ref.flash_attention_reference(q, k, v, causal=causal,
                                             softcap=cap, return_lse=True)
    lse_err = float((lse - lse_p).abs().max())
    need(lse_err <= (1e-3 if dt == torch.bfloat16 else 1e-4),
         f"flash_attention {case}: lse off by {lse_err}")
    run_k = lambda: ops.flash_attention_backward(
        q, k, v, out, lse, do, causal=causal, softcap=cap)
    run_p = lambda: ref.flash_attention_backward_reference(
        q, k, v, out, lse, do, causal=causal, softcap=cap)
    _build.reset_counts()
    got = run_k()
    design = ops.BWD_DESIGNS[dt]
    need(_build.launches.get("flash_attention_bwd") == 1
         and _build.launches.get(f"flash_attention_bwd.{design}") == 1,
         f"flash_attention_bwd {case}: launches {dict(_build.launches)}, "
         f"expected one call of the {design} design")
    want = run_p()
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype_name(dt)]
    errs = {n: scaled_err(torch, a, b, tol, f"flash_attention_bwd {case} {n}")
            for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    again = run_k()
    torch.cuda.synchronize()
    need(all(torch.equal(a, b) for a, b in zip(got, again)),
         f"flash_attention_bwd {case}: two calls differ")
    grouped = H > KV
    split = call_kernels(torch, run_k, "flash_attention_bwd", case,
                         bwd_kernels(grouped))
    if split is not None:               # None: the profiler saw nothing
        need(split_ok(split, bwd_kernels(grouped)),
             f"flash_attention_bwd {case}: device kernels a call {split}, "
             f"expected one launch each of {bwd_kernels(grouped)}")
    pairs = sum(min(T, s + T - S + 1) for s in range(S)) if causal \
        else S * T
    flops = 5 * 2 * B * H * hd * pairs
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + lse.numel() * 4
    bound_ms, bound_by = bound(flops, nbytes, dt)
    extra = {}
    if dt == torch.float32:
        bound_ms, bound_by, extra = piece_bounds(flops, nbytes)
    parent_ms = parent_err = None
    if parent is not None:
        parent_ms, parent_err = parent_bwd_ms(torch, parent, q, k, v, out,
                                              lse, do, causal, cap, want,
                                              flush)
    event_ms(torch, run_k, reps=2, flush=flush)             # warm-up
    library_ms = None
    if cap == 0.0:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            if S == T or not causal:
                o = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
            else:                        # SDPA aligns is_causal top-left
                mask = torch.arange(T, device=dev)[None, :] \
                    <= torch.arange(S, device=dev)[:, None] + (T - S)
                o = sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
            dot = do.transpose(1, 2)
            run_l = lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                                retain_graph=True)
            event_ms(torch, run_l, reps=2, flush=flush)
            library_ms = event_ms(torch, run_l, reps=10, flush=flush)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
    dkdv_per_sm, dq_per_sm = ops.bwd_blocks_per_sm(hd, dt)
    row = {"name": "flash_attention_bwd", "case": case, "design": design,
           "shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd},
           "dtype": dtype_name(dt), "causal": causal, "softcap": cap,
           "max_abs_err": max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, want)),
           "max_scaled_err": errs, "lse_max_abs_err": lse_err,
           "device_kernels": split,
           "blocks_per_sm": {"dkdv": dkdv_per_sm, "dq": dq_per_sm},
           "ms": event_ms(torch, run_k, reps=10, flush=flush),
           "parent_fma_ms": parent_ms, "parent_max_scaled_err": parent_err,
           "plain_ms": event_ms(torch, run_p, reps=2, flush=flush),
           "bound_ms": bound_ms, "bound_by": bound_by, **extra,
           "library_ms": library_ms}
    emit({"phase": "kernel_vs_plain", **row})
    return row


def bwd_checks(torch, dev, flush, parent_dir=None) -> dict:
    """The backward against its plain version, every BWD_CASES case in
    bf16 and float32, each row naming its design (bf16 ``mma``, float32
    ``mma3``), its kernels' CTAs per SM and, given ``parent_dir``
    (``--parent-bwd``), an earlier tree's FMA-pipe backward timed on the
    same inputs; two calls must give the same bits.  Returns the rows by
    case (float32 ones suffixed)."""
    g = torch.Generator(device=dev).manual_seed(24)
    parent = parent_bwd_library(parent_dir)
    rows = {}
    for (base, B, S, T, causal, cap, (H, KV, hd)), dt in (
            (c, dt) for c in BWD_CASES
            for dt in (torch.bfloat16, torch.float32)):
        case = base if dt == torch.bfloat16 else base + "_float32"
        rows[case] = bwd_row(torch, dev, g, case, B, S, T, causal, cap, H,
                             KV, hd, dt, flush, parent)
    need(rows["slice"]["device_kernels"] is not None
         and rows["slice_float32"]["device_kernels"] is not None,
         "the profiler saw no device kernel of the slice's backward")
    return rows


def train_launches(cfg, steps: int, remat: bool = False) -> dict:
    """Kernel launches of ``steps`` training steps: every attention layer
    runs flash_attention forward once with its log-sum-exp (twice under
    remat: the recomputation), through the design of the model's type,
    and one backward; every Mamba2 layer ssd_scan forward once (twice
    under remat) and its backward once (one count a call, and one for its
    design).  The hybrid's attention layers are its shared block's
    applications, one a super-block; the ssm family has none."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    fwd = 2 if remat else 1
    mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}.get(
        cfg.family, cfg.n_layers)
    out = {}
    if attn:
        n = steps * attn
        out.update({
            "flash_attention": n * fwd,
            "flash_attention." + flash_ops.DESIGNS[cfg.torch_dtype]: n * fwd,
            "flash_attention.lse": n * fwd, "flash_attention_bwd": n,
            "flash_attention_bwd."
            + flash_ops.BWD_DESIGNS[cfg.torch_dtype]: n})
    if mamba:
        n = steps * mamba
        out.update({
            "ssd_scan": n * fwd,
            "ssd_scan." + ssd_ops.DESIGNS[cfg.torch_dtype]: n * fwd,
            "ssd_scan_bwd": n,
            "ssd_scan_bwd." + ssd_ops.BWD_DESIGNS[cfg.torch_dtype]: n})
    return out


def check_launches(got: dict, want: dict, what: str) -> None:
    got = {k: v for k, v in got.items() if v}
    need(got == want, f"{what}: launches {got}, expected {want}")


def timed_step(torch, tr, batch) -> dict:
    """One training step of ``tr`` split by CUDA events: forward (loss),
    backward, and the AdamW update."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model = tr.model
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    ev[0].record()
    total, _ = steps.loss_fn(model, batch, tr.cfg, remat=tr.tcfg.remat)
    ev[1].record()
    total.backward()
    ev[2].record()
    params = dict(model.named_parameters())
    grads = {n: p.grad for n, p in params.items()}
    adamw.update(grads, tr.opt_state, params, adamw.AdamWConfig(
        lr=tr.tcfg.lr), decay=steps.decay_mask(params, tr.cfg))
    ev[3].record()
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    return {"forward_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "optimizer_ms": ev[2].elapsed_time(ev[3])}


def profiled_step(torch, tr, batch) -> dict:
    """torch.profiler over one Trainer step: wall, device time, the
    device's busy share and its top kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr._one_step(batch)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = kernel_ms(torch, prof)
    device = sum(kernels.values()) if kernels else None
    return {"wall_ms": wall, "device_ms": device,
            "device_busy_share": None if device is None else device / wall,
            "attention_bwd_ms": sum(v for k, v in kernels.items()
                                    if any(b in k for b in BWD_KERNELS)),
            "ssd_bwd_ms": sum(v for k, v in kernels.items()
                              if any(b in k for b in SSD_BWD_KERNELS)),
            "device_kernel_counts": {
                k: kernel_count(torch, prof, k) for k in
                ("flash_wgmma_kernel", "ssd_mma_kernel") + BWD_KERNELS
                + SSD_BWD_KERNELS},
            "top_kernels_ms": [(k[:60], v) for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1])[:10]]}


def trainer(cfg, seq, batch, steps, dev, mesh=None, **kw):
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.synthetic import for_model
    from repro_torch.train import TrainConfig, Trainer
    return Trainer(cfg, ShapeSpec("chip_smoke", seq, batch, "train"),
                   for_model(cfg, seq, batch),
                   TrainConfig(total_steps=steps, lr=TRAIN_LR, **kw),
                   mesh=mesh, seed=0, device=dev)


def train_full_width(torch, dev, arch: str = TRAIN_ARCH) -> dict:
    """``Trainer`` on ``arch`` at its published widths and depth (qwen2.5-3b:
    36 layers; mamba2-1.3b: 48; zamba2-2.7b: 54 Mamba2 layers and 9
    applications of the shared block; bf16, seed-0 weights) on
    ``for_model(cfg, 128, 8)``: TRAIN_STEPS steps, every loss finite,
    launches against ``train_launches`` (counts reset just before, read
    just after), peak memory under the card's; the step time (median of
    steps 2-5), tokens/s, the forward/backward/optimizer split and a
    profiled step; then one step with remat.  Returns the launches of the
    run."""
    from repro_torch import _build
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    t0 = time.perf_counter()
    tr = trainer(cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    out = tr.run()
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics_log]
    need(out["steps"] == TRAIN_STEPS and all(map(math.isfinite, losses)),
         f"full-width training: steps {out['steps']}, losses {losses}")
    check_launches(launches, train_launches(cfg, TRAIN_STEPS),
                   "full-width training")
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    need(peak < total_mem, f"peak {peak} over the card's {total_mem}")
    step_s = statistics.median(m["step_time_s"] for m in tr.metrics_log[1:])
    batch = tr.batch(tr.step)
    split = timed_step(torch, tr, batch)
    prof = profiled_step(torch, tr, batch)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    row = {"phase": "train", "model": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "lr": TRAIN_LR, "steps": TRAIN_STEPS,
           "params": sum(p.numel() for p in tr.model.parameters()),
           "init_s": init_s, "losses": losses,
           "grad_norms": [m["grad_norm"] for m in tr.metrics_log],
           "step_ms": [m["step_time_s"] * 1e3 for m in tr.metrics_log],
           "step_ms_median_2_5": step_s * 1e3,
           "tokens_per_s": tokens / step_s, **split,
           "peak_mem_bytes": peak, "card_mem_bytes": total_mem,
           "launches": launches, "profile": prof}
    emit(row)
    TRAIN_ROWS[cfg.name] = row
    # one step with remat: each layer recomputed in the backward
    tr.tcfg.remat = True
    tr._build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    m = tr._one_step(batch)
    check_launches(_build.launches, train_launches(cfg, 1, remat=True),
                   "remat step")
    need(math.isfinite(m["loss"]), "remat step: non-finite loss")
    emit({"phase": "train_remat", "model": cfg.name,
          "step_ms": m["step_time_s"] * 1e3,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "loss": m["loss"]})
    del tr
    torch.cuda.empty_cache()
    return launches


def train_cut(torch, dev, dtype: str, arch: str = TRAIN_ARCH,
              n_layers: int = CUT_LAYERS, from_cpu_state: bool = False
              ) -> None:
    """``arch`` at ``n_layers`` layers and full width, TF32 off: the first
    step's gradients and CUT_STEPS (HELD_STEPS where ``from_cpu_state``)
    Trainer steps from the same seeded
    weights on the card and through the port's CPU path.  float32: losses
    and grad norms to rtol 1e-4 and each gradient leaf within 1e-4 of its
    largest magnitude (floored at 1e-3 of the largest of all leaves: the
    key bias's gradient is zero in exact arithmetic, rounding noise on both
    sides); bf16: losses within 2e-2.  ``from_cpu_state`` (a model whose
    free-running steps amplify float32 rounding: the hybrid,
    ``train_ssm_phase``): each card step starts from the CPU path's whole
    training state and ends checked against it (``cut_steps_from_cpu``)."""
    import dataclasses
    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype=dtype).validate()
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_steps = HELD_STEPS if from_cpu_state else CUT_STEPS[dtype]
    try:
        host = trainer(cfg, CUT_SEQ, CUT_BATCH, n_steps, "cpu")
        card = trainer(cfg, CUT_SEQ, CUT_BATCH, n_steps, dev)
        with torch.no_grad():
            for (n, a), b in zip(host.model.named_parameters(),
                                 card.model.parameters()):
                b.copy_(a)
        from repro_torch.optim import adamw
        card.opt_state = adamw.init(card.params)
        leaf_err = None
        if dtype == "float32":
            gh, _, _ = steps.grads_of(host.model, host.batch(0), cfg, False)
            gc, _, _ = steps.grads_of(card.model, card.batch(0), cfg, False)
            top = max(float(t.abs().max()) for t in gh.values())
            leaf_err = 0.0
            for n, t in gh.items():
                scale = max(float(t.abs().max()), 1e-3 * top)
                err = float((gc[n].cpu() - t).abs().max()) / scale
                need(err <= CUT_TOL[dtype], f"float32 cut: gradient of {n} "
                     f"off by {err} of its scale")
                leaf_err = max(leaf_err, err)
            host.model.zero_grad(set_to_none=True)
            card.model.zero_grad(set_to_none=True)
        stepwise = None
        if from_cpu_state:
            launches, stepwise = cut_steps_from_cpu(torch, cfg, host, card,
                                                    n_steps)
        else:
            _build.reset_counts()
            card.run()
            launches = dict(_build.launches)
            host.metrics_log = HOST.get(
                ("run", cfg.name, n_layers, dtype, n_steps))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    got = [(m["loss"], m["grad_norm"]) for m in card.metrics_log]
    want = [(m["loss"], m["grad_norm"]) for m in host.metrics_log]
    emit({"phase": "train_card_vs_cpu", "model": cfg.name,
          "n_layers": cfg.n_layers, "dtype": dtype, "seq": CUT_SEQ,
          "batch": CUT_BATCH, "allow_tf32": False,
          "from_cpu_state": from_cpu_state, "stepwise": stepwise,
          "card": got, "cpu": want, "grad_leaf_max_scaled_err": leaf_err,
          "card_step_ms": [m["step_time_s"] * 1e3 for m in card.metrics_log],
          "cpu_step_ms": [m["step_time_s"] * 1e3 for m in host.metrics_log],
          "launches": launches})
    check_launches(launches, train_launches(cfg, n_steps),
                   f"{dtype} cut")
    if stepwise is not None:
        judge_stepwise(stepwise)
    tol = CUT_TOL[dtype]
    for (gl, gn), (wl, wn) in zip(got, want):
        need(math.isclose(gl, wl, rel_tol=tol),
             f"{dtype} cut: loss {gl} on the card, {wl} on the CPU")
        if dtype == "float32":
            need(math.isclose(gn, wn, rel_tol=tol),
                 f"{dtype} cut: grad norm {gn} on the card, {wn} on the CPU")


def host_run(job) -> list:
    """One free run of a training cut's CPU path: ``job`` = (kind, arch,
    n_layers, dtype, steps), kind ``run`` from the seeded weights or
    ``ulp`` from each weight moved one float32 ulp (up or down by a coin
    of generator seed 0).  Returns the run's metrics log."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    kind, arch, n_layers, dtype, n_steps = job
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype=dtype).validate()
    tr = trainer(cfg, CUT_SEQ, CUT_BATCH, n_steps, "cpu")
    if kind == "ulp":
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in tr.model.parameters():
                up = torch.rand(p.shape, generator=g) < 0.5
                p.copy_(torch.nextafter(p, torch.where(
                    up, torch.tensor(math.inf), torch.tensor(-math.inf))))
        tr.opt_state = adamw.init(tr.params)
    tr.run()
    return tr.metrics_log


def host_runs_worker(jobs, queue) -> None:
    """The worker process of ``HostRuns``: each job's run in turn, put on
    ``queue`` as (job, metrics log), or (job, the error's text)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(HOST_THREADS)
    for job in jobs:
        try:
            queue.put((job, host_run(job)))
        except Exception as e:              # reported by HostRuns.get
            queue.put((job, f"{type(e).__name__}: {e}"))
            return


class HostRuns:
    """The CPU path's free runs of the training cuts, which take nothing
    from the card (``train_cut``'s CPU run, the hybrid's one-ulp run): the
    whole script starts one worker process on them right after the build
    (``start``), so they run while the card works and each cut reads its
    run when it gets there; without a worker (``--only``) ``get`` runs the
    job in place."""

    def __init__(self):
        self.proc, self.queue, self.done = None, None, {}

    def start(self, jobs) -> None:
        import multiprocessing
        mp = multiprocessing.get_context("spawn")
        self.queue = mp.Queue()
        self.proc = mp.Process(target=host_runs_worker,
                               args=(list(jobs), self.queue), daemon=True)
        self.proc.start()

    def get(self, job) -> list:
        if self.proc is None:
            return host_run(job)
        import queue
        while job not in self.done:
            try:
                key, out = self.queue.get(timeout=10)
            except queue.Empty:
                need(self.proc.is_alive(), f"the CPU worker ended (exit "
                     f"code {self.proc.exitcode}) before {job}")
                continue
            self.done[key] = out
        out = self.done.pop(job)
        need(not isinstance(out, str), f"CPU run {job}: {out}")
        return out

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            self.proc.join()
            self.proc = None


HOST = HostRuns()
HOST_THREADS = 4


def host_jobs() -> list:
    """The CPU runs the whole script's training cuts read, in the order
    they read them."""
    from repro_torch.configs import get_config
    f32, bf16 = "float32", "bfloat16"
    return [("run", TRAIN_ARCH, CUT_LAYERS, f32, CUT_STEPS[f32]),
            ("run", TRAIN_ARCH, CUT_LAYERS, bf16, CUT_STEPS[bf16]),
            ("run", SSD_ARCH, CUT_LAYERS, f32, CUT_STEPS[f32]),
            ("ulp", HYBRID_ARCH, get_config(HYBRID_ARCH).attn_every, f32,
             HELD_STEPS)]


def _leaf_err(torch, got, want, floor: float = 1e-3):
    """(the largest distance of the leaves ``got`` from ``want``, name ->
    tensor, each scaled by its leaf's largest magnitude floored at
    ``floor`` of the largest of all leaves; the leaf where it lies)."""
    want = {n: w.to(got[n].device) for n, w in want.items()}
    top = max(float(t.abs().max()) for t in want.values())
    worst = (0.0, None)
    for n, w in want.items():
        scale = max(float(w.abs().max()), floor * top)
        if scale > 0:
            err = float((got[n] - w).abs().max()) / scale
            worst = max(worst, (err, n), key=lambda e: e[0])
    return worst


def cut_steps_from_cpu(torch, cfg, host, card, n_steps: int) -> dict:
    """The float32 cut's steps of a model whose free-running steps amplify
    float32 rounding, so that a card run and a CPU run from the same
    weights part after a few steps whatever computes their gradients.
    Three free runs show it: the card's, the CPU path's, and the CPU path
    from the seeded weights moved by one float32 ulp each (a rounding-size
    change that involves no card).  Then each card step starts from the
    CPU path's whole training state (the CPU path runs free) and is held
    to it: its loss and grad norm (judged by ``train_cut``); the card's
    AdamW update, m, v and the float32 master weights after the step
    against the update recomputed leaf by leaf, apart from
    ``adamw.update``, from the step's starting state and the card's own
    gradients (``steps.grads_of`` just before the step) and grad norm
    (decay mask, clipping, bias corrections, lr),
    within 1e-6 of each value plus 1e-6 of the leaf's largest (of lr for
    the weights); the model's parameters equal to the master weights; the
    step counters equal.  The distance of the card's m and sqrt(v) from
    the CPU path's after each step, scaled as the gradients are, is
    recorded.

    Launch counts are reset just before each held step and read just
    after it.  Returns (the launches of the held steps, the row's
    ``stepwise`` record, judged by ``judge_stepwise``)."""
    from repro_torch import _build
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    card.run()
    card_free = [(m["loss"], m["grad_norm"]) for m in card.metrics_log]
    card.metrics_log.clear()
    ulp_free = [(m["loss"], m["grad_norm"]) for m in HOST.get(
        ("ulp", cfg.name, cfg.n_layers, cfg.dtype, n_steps))]

    opt = adamw.AdamWConfig(lr=TRAIN_LR)
    decay = steps.decay_mask(host.params, cfg)
    held, launches = [], {}
    hs, cs = host.opt_state, card.opt_state
    for step in range(n_steps):
        with torch.no_grad():
            params = card.params
            for n, t in host.params.items():
                params[n].copy_(t)
            for key in ("master", "m", "v"):
                for n, t in hs[key].items():
                    cs[key][n].copy_(t)
            cs["step"].copy_(hs["step"])
        gc, _, _ = steps.grads_of(card.model, card.batch(step), cfg, False)
        gc = {n: t.detach().float() for n, t in gc.items()}
        before = {key: {n: t.clone() for n, t in cs[key].items()}
                  for key in ("master", "m", "v")}
        card.model.zero_grad(set_to_none=True)
        _build.reset_counts()
        card.metrics_log.append(card._one_step(card.batch(step)))
        for key, c in _build.launches.items():
            launches[key] = launches.get(key, 0) + c
        dev = next(iter(gc.values())).device
        gnorm = torch.tensor(card.metrics_log[-1]["grad_norm"], device=dev)
        scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        k = torch.tensor(float(step + 1), device=dev)
        b1c, b2c = 1.0 - opt.b1 ** k, 1.0 - opt.b2 ** k
        worst = {"m": (0.0, None), "v": (0.0, None), "master": (0.0, None)}
        same = True
        for n, grad in gc.items():
            t = grad * scale
            m = before["m"][n].mul_(opt.b1).add_(t * (1.0 - opt.b1))
            v = before["v"][n].mul_(opt.b2).add_(
                t.square().mul_(1.0 - opt.b2))
            w = before["master"][n]
            upd = (m / b1c).div_((v / b2c).sqrt_().add_(opt.eps))
            if decay[n]:
                upd.add_(opt.weight_decay * w)
            want = {"m": m, "v": v, "master": w - upd.mul_(opt.lr)}
            for key, x in want.items():
                off = (cs[key][n] - x).abs()
                lim = 1e-6 * (x.abs() + (opt.lr if key == "master"
                                         else float(x.abs().max())))
                err = float((off / lim).max()) if x.numel() else 0.0
                worst[key] = max(worst[key], (err, n), key=lambda e: e[0])
            same &= torch.equal(params[n], cs["master"][n].to(
                params[n].dtype))
        del gc, before
        host.metrics_log.append(host._one_step(host.batch(step)))
        held.append({
            "step": step + 1,
            "counters": (int(cs["step"]), int(hs["step"])),
            "params_are_master": same,
            "m_vs_cpu": _leaf_err(torch, cs["m"], hs["m"]),
            "sqrt_v_vs_cpu": _leaf_err(
                torch, {n: t.sqrt() for n, t in cs["v"].items()},
                {n: t.sqrt() for n, t in hs["v"].items()}),
            **{f"{key}_over_bound": e for key, e in worst.items()}})
    cpu = [(m["loss"], m["grad_norm"]) for m in host.metrics_log]

    def part(run):
        return max(max(abs(a - c) / abs(c), abs(b - d) / abs(d))
                   for (a, b), (c, d) in zip(run, cpu))
    return launches, {"card_free": card_free, "ulp_free": ulp_free,
                      "card_free_rel": part(card_free),
                      "ulp_free_rel": part(ulp_free), "held": held}


def judge_stepwise(rec: dict) -> None:
    """``cut_steps_from_cpu``'s record: every held step's AdamW update
    within its bound, parameters equal to the master weights, counters
    equal; and where the one-ulp CPU run stays within CUT_TOL of the CPU
    path, the card's free run must too."""
    tol = CUT_TOL["float32"]
    for h in rec["held"]:
        at = f"float32 cut step {h['step']}"
        need(tuple(h["counters"]) == (h["step"], h["step"]),
             f"{at}: step counters {h['counters']}")
        for key in ("m", "v", "master"):
            err, leaf = h[f"{key}_over_bound"]
            need(err <= 1.0, f"{at}: {key} of {leaf} {err} times the bound "
                 "from AdamW's update")
        need(h["params_are_master"], f"{at}: parameters are not the "
             "master weights")
    need(rec["ulp_free_rel"] > tol or rec["card_free_rel"] <= tol,
         f"float32 cut: the card's free run parts from the CPU path by "
         f"{rec['card_free_rel']}, a one-ulp change on the CPU by only "
         f"{rec['ulp_free_rel']}")


def train_restart(torch, dev, arch: str = TRAIN_ARCH) -> None:
    """The bf16 cut of ``arch`` on the card: 4 steps with a checkpoint, a
    new Trainer restoring it and running to 6, against an uninterrupted
    6-step run: the losses of steps 5-6 and the whole final state bit for
    bit."""
    import dataclasses
    import shutil
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=CUT_LAYERS)
    ckdir = ROOT / "build" / "train_smoke"
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        full = trainer(cfg, CUT_SEQ, CUT_BATCH, 6, dev)
        full.run()
        first = trainer(cfg, CUT_SEQ, CUT_BATCH, 4, dev, ckpt_every=100,
                        ckpt_dir=str(ckdir))
        first.run()
        del first
        t0 = time.perf_counter()
        second = trainer(cfg, CUT_SEQ, CUT_BATCH, 6, dev, ckpt_every=100,
                         ckpt_dir=str(ckdir))
        second.ckpt = None          # resumes from ckdir; no final save
        second.run()
        resume_s = time.perf_counter() - t0
        want = [m["loss"] for m in full.metrics_log[4:]]
        got = [m["loss"] for m in second.metrics_log]
        same_state = all(torch.equal(a, b) for a, b in
                         zip(full.state_leaves(), second.state_leaves()))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    emit({"phase": "train_restart", "model": cfg.name,
          "disk_free_bytes": shutil.disk_usage(ROOT).free,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          "losses_resumed": got, "losses_uninterrupted": want,
          "state_bit_equal": same_state, "resume_and_run_s": resume_s})
    need(second.step == 6 and got == want and same_state,
         f"restart: losses {got} vs {want}, state equal {same_state}")


# the full-width training rows by model (``train_full_width``), which the
# mesh phase holds its run against
TRAIN_ROWS = {}
MESH_STEPS = 3
MOE_ARCH, MOE_B, MOE_S = "phi3.5-moe-42b", 4, 128


def mesh_phase(torch, dev) -> None:
    """6d. Training on a device mesh, at world size 1 (NCCL takes one rank
    a card; the multi-rank numerics are the CPU tests' gloo worlds): the
    default group from a ``file://`` rendezvous in a fresh directory
    (gloo for CPU tensors, NCCL for the card's) and ``make_mesh_for(1, 1,
    "cuda")``, destroyed at the end.  (a) ``Trainer(mesh=...)`` on
    qwen2.5-3b at full width (as ``train_full_width``: 36 layers, bf16,
    seed 0, 8 x 128 tokens) for MESH_STEPS steps: losses and grad norms
    bit-equal to the first steps of the meshless run of 6b, the same
    kernel launches (``train_launches``), peak memory within 10% of its;
    the step time (median of steps 2-3), the NCCL kernels of a profiled
    step, and 8 more steps of the same trainer with its step function
    built for the mesh and for none in turn (the mesh's host cost).  (b)
    ``moe_ffn``'s "tp" placement on the (1, 1) mesh at
    one phi3.5-moe layer's widths (E 16, D 4096, F 6400, top-2, bf16, 4 x
    128 tokens): y, aux and every gradient bit-equal to the meshless
    layer.  (c) ``quantized_allreduce`` and two ``ErrorFeedback`` rounds
    over the gradients of the 2-layer qwen2.5-3b cut on the card, bit-equal
    to the same calls on CPU tensors (the group's gloo half); times.  (d)
    serving on the mesh (``mesh_serve``) and the dry run of one cell in a
    subprocess, started first (``dryrun_start``)."""
    import datetime
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    d = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    t0 = time.perf_counter()
    dist.init_process_group(
        "cpu:gloo,cuda:nccl", init_method=f"file://{d}/pg", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh_for(1, 1, "cuda")
        dry = dryrun_start()
        mesh_train(torch, dev, mesh)
        mesh_moe(torch, dev, mesh)
        mesh_compress(torch, dev, mesh)
        mesh_serve(torch, dev, mesh)
        dryrun_check(dry)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    emit({"phase": "mesh_done", "wall_s": time.perf_counter() - t0})


def mesh_train(torch, dev, mesh) -> None:
    from repro_torch import _build
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    ref = TRAIN_ROWS[cfg.name]
    t0 = time.perf_counter()
    tr = trainer(cfg, TRAIN_SEQ, TRAIN_BATCH, MESH_STEPS, dev, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    out = tr.run()
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics_log]
    norms = [m["grad_norm"] for m in tr.metrics_log]
    need(out["steps"] == MESH_STEPS, f"meshed training: {out['steps']} "
         "steps")
    need(losses == ref["losses"][:MESH_STEPS]
         and norms == ref["grad_norms"][:MESH_STEPS],
         f"meshed training on (1, 1): losses {losses}, grad norms {norms}; "
         f"meshless {ref['losses'][:MESH_STEPS]}, "
         f"{ref['grad_norms'][:MESH_STEPS]}")
    check_launches(launches, train_launches(cfg, MESH_STEPS),
                   "meshed training")
    need(peak <= 1.1 * ref["peak_mem_bytes"], f"meshed training: peak "
         f"{peak} B against the meshless {ref['peak_mem_bytes']}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    batch = tr.batch(tr.step)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        tr._one_step(batch)
        wall = (time.perf_counter() - t1) * 1e3
    kernels = kernel_ms(torch, prof)
    nccl = {k[:60]: v for k, v in kernels.items() if "nccl" in k.lower()}
    # the mesh's own cost a step: at one rank the meshed and meshless
    # trainers hold the same tensors, so one trainer's step function is
    # built for either in turn and their steps alternate
    ab = {"mesh": [], "none": []}
    for which in ("mesh", "none", "none", "mesh") * 2:
        tr.mesh = mesh if which == "mesh" else None
        tr._build()
        ab[which].append(tr._one_step(batch)["step_time_s"] * 1e3)
    emit({"phase": "mesh_train", "model": cfg.name, "mesh": [1, 1],
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "seq": TRAIN_SEQ,
          "batch": TRAIN_BATCH, "steps": MESH_STEPS, "init_s": init_s,
          "losses": losses, "grad_norms": norms,
          "bit_equal_to_meshless": True,
          "step_ms": [m["step_time_s"] * 1e3 for m in tr.metrics_log],
          "step_ms_median_2_3": statistics.median(
              m["step_time_s"] for m in tr.metrics_log[1:]) * 1e3,
          "meshless_step_ms_median_2_5": ref["step_ms_median_2_5"],
          "peak_mem_bytes": peak,
          "meshless_peak_mem_bytes": ref["peak_mem_bytes"],
          "launches": launches,
          "profiled_step_wall_ms": wall,
          "profiled_step_device_ms": sum(kernels.values()),
          "nccl_kernels_a_step": len(nccl), "nccl_ms_a_step": nccl,
          "alternated_step_ms": ab,
          "alternated_median_ms": {k: statistics.median(v)
                                   for k, v in ab.items()}})
    del tr
    torch.cuda.empty_cache()


def mesh_moe(torch, dev, mesh) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoE, moe_ffn
    from repro_torch.parallel.mesh_ctx import make_ctx
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = MoE(cfg, gen, device=dev)
    x = torch.randn((MOE_B, MOE_S, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.float32).to(cfg.torch_dtype)
    r = torch.randn(x.shape, generator=gen, device=dev,
                    dtype=torch.float32).to(cfg.torch_dtype)
    ctx = make_ctx(mesh)

    def run(c):
        xg = x.clone().requires_grad_()
        y, aux = moe_ffn(p, xg, cfg, c)
        ((y.float() * r.float()).sum() + aux).backward()
        grads = [xg.grad] + [t.grad for t in p.parameters()]
        p.zero_grad(set_to_none=True)
        return [y.detach(), aux.detach()] + grads

    want, got = run(None), run(ctx)
    need(all(torch.equal(a, b) for a, b in zip(want, got)),
         "moe_ffn's tp placement on (1, 1) differs from the meshless layer")
    with torch.no_grad():
        ms = event_ms(torch, lambda: moe_ffn(p, x, cfg, ctx), reps=3)
        plain = event_ms(torch, lambda: moe_ffn(p, x, cfg), reps=3)
    emit({"phase": "mesh_moe", "model": cfg.name, "impl": ctx.moe_impl,
          "mesh": [1, 1], "experts": cfg.n_experts, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "top_k": cfg.top_k, "dtype": cfg.dtype,
          "tokens": MOE_B * MOE_S, "bit_equal": True,
          "forward_ms": ms, "meshless_forward_ms": plain})
    del p, want, got
    torch.cuda.empty_cache()


def mesh_compress(torch, dev, mesh) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.parallel.compress import (ErrorFeedback, quantize,
                                               quantized_allreduce)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=CUT_LAYERS).validate()
    tr = trainer(cfg, TRAIN_SEQ, TRAIN_BATCH, 1, dev)
    grads, _, _ = steps.grads_of(tr.model, tr.batch(0), cfg, False)
    grads = {k: v.detach() for k, v in grads.items()}
    del tr
    host = {k: v.cpu() for k, v in grads.items()}

    def calls(g):
        ef = ErrorFeedback()
        return [quantized_allreduce(g, mesh, "data"), ef.apply(g),
                ef.apply(g)]

    t0 = time.perf_counter()
    on_cpu = calls(host)
    cpu_s = time.perf_counter() - t0
    on_card = calls(grads)
    for a, b in zip(on_card, on_cpu):
        need(all(torch.equal(a[k].cpu(), b[k]) for k in b),
             "quantized_allreduce / ErrorFeedback: card differs from CPU")
    n = sum(v.numel() for v in grads.values())
    flat = torch.cat([v.float().reshape(-1) for v in grads.values()])
    emit({"phase": "mesh_compress", "model": cfg.name,
          "n_layers": cfg.n_layers, "elements": n, "bit_equal": True,
          "quantize_ms": event_ms(torch, lambda: quantize(flat), reps=3),
          "quantized_allreduce_ms": event_ms(
              torch, lambda: quantized_allreduce(grads, mesh, "data"),
              reps=3),
          "error_feedback_ms": event_ms(
              torch, lambda: ErrorFeedback().apply(grads), reps=3),
          "cpu_three_calls_s": cpu_s})
    del grads, host, on_cpu, on_card, flat


# the serving path's kernel launches on the (1, 1) mesh (``mesh_serve``),
# added to the serving phases' in the kernels line
MESH_SERVE_LAUNCHES = {}
DRYRUN_CELL = ("whisper-tiny", "decode_32k")
# the reference's figure for DRYRUN_CELL on 16 x 16: the cache's shard
DRYRUN_ALIASED = 105_271_296
# the port's collective bytes a rank for DRYRUN_CELL: the FSDP weights
# and the split mode's query heads and output slices all-gathered, its
# partial scores all-reduced (the cache is no longer gathered)
DRYRUN_COLLECTIVES = {"all-gather": 87_823_872, "all-reduce": 26_342_400,
                      "reduce-scatter": 0, "all-to-all": 0,
                      "collective-permute": 0}


def dryrun_start():
    """The dry run of DRYRUN_CELL in a subprocess with no card visible
    (``CUDA_VISIBLE_DEVICES`` empty): (process, its JSON path, start)."""
    import os
    import tempfile
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_")) / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_CELL[0], "--shape", DRYRUN_CELL[1], "--json", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, out, time.perf_counter()


def dryrun_check(dry) -> None:
    """The dry run's exit code 0, its 256 devices, the reference's
    aliased bytes and DRYRUN_COLLECTIVES; emits its figures."""
    import shutil
    proc, out, t0 = dry
    try:
        log, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure("the dry run took more than 300 s")
    wall = time.perf_counter() - t0
    need(proc.returncode == 0, f"the dry run exited {proc.returncode}: "
         f"{log[-2000:]}")
    (r,) = json.loads(out.read_text())
    shutil.rmtree(out.parent, ignore_errors=True)
    d = r["deploy"]
    need(r["n_devices"] == 256 and d["per_device_bytes"]["aliased"]
         == DRYRUN_ALIASED, f"dry run: {r['n_devices']} devices, aliased "
         f"{d['per_device_bytes']['aliased']}")
    need(d["collective_bytes"] == DRYRUN_COLLECTIVES, f"dry run: "
         f"collective bytes {d['collective_bytes']}, not "
         f"{DRYRUN_COLLECTIVES}")
    emit({"phase": "mesh_dryrun", "arch": r["arch"], "shape": r["shape"],
          "n_devices": r["n_devices"], "mesh": r["mesh"],
          "per_device_bytes": d["per_device_bytes"],
          "collective_bytes": d["collective_bytes"],
          "collective_counts": d["collective_counts"], "flops": d["flops"],
          "fake_run_s": d["compile_s"], "subprocess_wall_s": wall,
          "last_line": log.strip().splitlines()[-1]})


def mesh_serve(torch, dev, mesh) -> None:
    """Serving on the (1, 1) mesh: qwen2.5-3b at full width (36 layers,
    bf16, seed 0) placed on the mesh (``place_model``: nothing sliced at
    one rank), ``Engine(ctx=...)`` on the launcher's traffic against the
    meshless ``Engine`` on the same requests (the counts reset just before
    each run and read just after): every token equal and the same
    launches of each kernel; ``make_prefill_step`` and 3
    ``make_serve_step``s on 2 prompts of 128 tokens with and without the
    mesh: tokens and every cache leaf bit-equal.  The meshed run's
    launches go to MESH_SERVE_LAUNCHES."""
    import numpy as np
    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.mesh_ctx import make_ctx
    from repro_torch.parallel.sharding import map_leaves
    from repro_torch.serving import Engine, Request, ServeConfig
    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    model = init_params(0, cfg, device=dev)
    ctx = make_ctx(mesh)
    rows = {}
    for name, c in (("meshless", None), ("mesh", ctx)):
        if c is not None:
            coll.place_model(model, cfg, c)
        eng = Engine(cfg, model, ServeConfig(), device=dev, ctx=c)
        for r in launcher_traffic(Request, cfg.vocab):
            eng.submit(r)
        torch.cuda.synchronize()
        _build.reset_counts()
        t1 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        rows[name] = {"wall_s": time.perf_counter() - t1,
                      "launches": dict(_build.launches),
                      "tokens": {k: v.tolist() for k, v in outs.items()}}
    launches = rows["mesh"]["launches"]
    need(rows["mesh"]["tokens"] == rows["meshless"]["tokens"],
         "Engine on the (1, 1) mesh: tokens differ from the meshless run")
    need(launches == rows["meshless"]["launches"]
         and launches.get("flash_attention", 0) > 0
         and launches.get("paged_attention", 0) > 0,
         f"Engine on the (1, 1) mesh launched {launches}, the meshless "
         f"engine {rows['meshless']['launches']}")
    MESH_SERVE_LAUNCHES.update(launches)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 128)).astype(np.int32)).to(dev)
    got = []
    for c in (None, ctx):
        tok, cache = steps.make_prefill_step(cfg, c, 256)(
            model, {"tokens": toks})
        out = [tok]
        for i in range(3):
            tok, cache = steps.make_serve_step(cfg, c)(model, tok, cache,
                                                       128 + i)
            out.append(tok)
        leaves = []
        map_leaves(leaves.append, cache)
        got.append(out + leaves)
    need(all(torch.equal(a, b) for a, b in zip(*got)),
         "the serving steps on the (1, 1) mesh: tokens or caches differ "
         "from the meshless steps")
    emit({"phase": "mesh_serve", "model": cfg.name, "mesh": [1, 1],
          "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          "requests": len(rows["mesh"]["tokens"]),
          "tokens_bit_equal": True, "steps_caches_bit_equal": True,
          "launches": launches, "wall_s": rows["mesh"]["wall_s"],
          "meshless_wall_s": rows["meshless"]["wall_s"],
          "phase_s": time.perf_counter() - t0})
    del model, got
    torch.cuda.empty_cache()


# (1, 4): qwen2.5-3b's 2 KV heads do not divide the model axis, so its
# attention runs on each rank's query heads (train and prefill) and its
# decode over a cache split by head dim sums partial scores
MESH4_SHAPES = ((2, 2), (4, 1), (1, 4))
# the meshes that also train with sequence parallelism on
MESH4_SP_SHAPES = ((2, 2), (1, 4))
# the bf16 rows' limits against one card's run, from the card's readings
# (H100 80GB HBM3, 700 W): losses to 2.3e-4, grad norms to 1.3e-3 off
# one card's; bf16 rounds each rank's partial sums, which the meshes sum
# in another order than one card
MESH4_TOL = {"losses": 5e-4, "grad_norms": 3e-3}
# the same meshes in float32 at full width and MESH4_F32_LAYERS layers,
# with and without sequence parallelism: the collectives' arithmetic
# against one card's to float32 rounding
MESH4_F32_LAYERS = 4
MESH4_F32_RUNS = (((2, 2), False), ((2, 2), True), ((1, 4), False),
                  ((1, 4), True))
MESH4_F32_TOL = 1e-6            # the card read 1.25e-7 at most
# meshed serving on four cards: B prompts of PROMPT tokens, a cache of
# MAX_LEN, STEPS teacher-forced decode steps; float32 logits within
# LOGIT_TOL of one card's meshless run, relative to the logit scale
MESH4_B, MESH4_PROMPT, MESH4_MAX_LEN, MESH4_STEPS = 4, 64, 128, 16
MESH4_LOGIT_TOL = 1e-4


def mesh4_tokens(vocab: int):
    """The prompts (B, PROMPT) and the forced decode inputs (B, STEPS)."""
    import numpy as np
    rng = np.random.default_rng(4)
    return (rng.integers(1, vocab, size=(MESH4_B, MESH4_PROMPT)),
            rng.integers(1, vocab, size=(MESH4_B, MESH4_STEPS)))


def mesh4_serve(torch, dev, dtype: str, ctx=None) -> dict:
    """qwen2.5-3b at full width in ``dtype`` (seed 0), placed on ``ctx``'s
    mesh: a prefill of the prompts into a MAX_LEN cache, then STEPS decode
    steps fed the forced tokens.  Every step's logits (all rows, gathered
    over the data axes, float32 numpy), and this rank's bytes of its
    weight and cache shards: as tensors (and their number), and as the
    growth over building the shards and the prefill of the caching
    allocator's requested bytes and of ``torch.cuda.memory_allocated()``
    (whole blocks)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import local_batch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import map_leaves
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype=dtype).validate()
    prompts, forced = mesh4_tokens(cfg.vocab)
    meshed = ctx is not None and ctx.active

    def rows(t):
        return local_batch({"t": t}, ctx)["t"] if meshed else t

    def whole(t):
        return coll.gathered(t, 0, ctx.group(ctx.dp)) if meshed else t

    from repro_torch import _build
    for dt in (torch.float32, torch.bfloat16):      # the cuBLAS workspaces
        torch.ones(8, 8, device=dev, dtype=dt) @ torch.ones(
            8, 8, device=dev, dtype=dt)

    def mem():
        torch.cuda.synchronize(dev)
        return (torch.cuda.memory_stats(dev)["requested_bytes.all.current"],
                torch.cuda.memory_allocated(dev))

    m0 = mem()
    model = init_params(0, cfg, device=dev)
    if meshed:
        coll.place_model(model, cfg, ctx)
    m1 = mem()
    batch = {"tokens": rows(torch.from_numpy(prompts).to(
        device=dev, dtype=torch.int32))}
    _build.reset_counts()
    logits, cache = prefill(model, batch, cfg, max_len=MESH4_MAX_LEN, ctx=ctx)
    out = [whole(logits).float().cpu().numpy()]
    del logits, batch
    m2 = mem()
    leaves = []
    map_leaves(leaves.append, cache)
    held = list(model.parameters()) + leaves
    n_held = len(held)
    held = sum(t.numel() * t.element_size() for t in held)
    forced_dev = rows(torch.from_numpy(forced).to(device=dev,
                                                  dtype=torch.int32))
    for i in range(MESH4_STEPS):
        lg, cache = decode_step(model, forced_dev[:, i:i + 1], cache,
                                MESH4_PROMPT + i, cfg, ctx=ctx)
        out.append(whole(lg).float().cpu().numpy())
    launches = dict(_build.launches)
    del model, cache, leaves, lg
    torch.cuda.empty_cache()
    return {"logits": out, "shards": n_held, "shard_bytes": held,
            "launches": launches,
            "requested_bytes": m2[0] - m0[0],
            "allocated_bytes": m2[1] - m0[1],
            "weights_allocated_bytes": m1[1] - m0[1]}


def mesh4_dry_arguments(shape) -> dict:
    """The dry run of the float32 qwen2.5-3b decode step (B, MAX_LEN) on a
    ``shape`` mesh, rank 0, over a fake group in this process (destroyed
    after): its per_device_bytes and input bytes."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    try:
        r = dryrun.lower_cell(
            cfg, ShapeSpec("mesh4_decode", MESH4_MAX_LEN, MESH4_B, "decode"),
            False, verbose=False, mesh_shape=shape)
    finally:
        dist.destroy_process_group()
    return {k: r["deploy"][k] for k in ("per_device_bytes", "input_bytes")}


def mesh4_phase(torch) -> None:
    """``--only mesh4`` (four cards, a four-chip call): qwen2.5-3b at full
    width (36 layers, bf16, seed 0, 8 x 128 tokens) on real NCCL meshes of
    four ranks, one a card.  First the meshless trainer on card 0 for
    MESH_STEPS steps (the reference), then, in four spawned processes (a
    ``file://`` rendezvous), ``Trainer(mesh=...)`` on MESH4_SHAPES:
    losses and grad norms within MESH4_TOL of the meshless run's (the
    summation order of the reduce-scatters and all-reduces is not the
    meshless one), and in float32 at MESH4_F32_LAYERS layers on
    MESH4_F32_RUNS within MESH4_F32_TOL of one card's float32 run, every
    rank's peak memory, the step time (median of
    steps 2-3) and, on rank 0, the NCCL kernels of a profiled step.  Then
    serving (``mesh4_serve``), float32 and bf16, one card meshless and the
    four ranks on MESH4_SHAPES: the float32 logits of the prefill and
    of 16 teacher-forced decode steps within MESH4_LOGIT_TOL
    (``mesh4_serve_checks``), and each rank's weight and cache shards
    equal to the dry run's arguments for that mesh and the decode shape
    (``mesh4_dry_arguments``), less the token and pos bytes.  On (1, 4)
    the attention runs on each rank's query heads and decode through
    ``paged_attention``'s split mode; the trainer also runs with
    sequence parallelism on MESH4_SP_SHAPES (each row's peak memory by
    rank beside the same mesh's without it)."""
    import shutil
    import tempfile
    need(torch.cuda.device_count() >= 4, "--only mesh4 needs four cards")
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    tr = trainer(cfg, TRAIN_SEQ, TRAIN_BATCH, MESH_STEPS, torch.device(
        "cuda:0"))
    torch.cuda.reset_peak_memory_stats()
    tr.run()
    ref = {"losses": [m["loss"] for m in tr.metrics_log],
           "grad_norms": [m["grad_norm"] for m in tr.metrics_log],
           "step_ms_median_2_3": statistics.median(
               m["step_time_s"] for m in tr.metrics_log[1:]) * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit({"phase": "mesh4_meshless", "model": cfg.name, **ref})
    del tr
    torch.cuda.empty_cache()
    tr = trainer(dataclasses.replace(cfg, dtype="float32",
                                     n_layers=MESH4_F32_LAYERS),
                 TRAIN_SEQ, TRAIN_BATCH, MESH_STEPS, torch.device("cuda:0"))
    tr.run()
    ref32 = {"losses": [m["loss"] for m in tr.metrics_log],
             "grad_norms": [m["grad_norm"] for m in tr.metrics_log]}
    emit({"phase": "mesh4_meshless", "model": cfg.name, "dtype": "float32",
          "layers": MESH4_F32_LAYERS, **ref32})
    del tr
    torch.cuda.empty_cache()
    serve_ref = {dt: mesh4_serve(torch, torch.device("cuda:0"), dt)
                 for dt in ("float32", "bfloat16")}
    dry = {shape: mesh4_dry_arguments(shape) for shape in MESH4_SHAPES}
    d = tempfile.mkdtemp(prefix="chip_smoke_mesh4_")
    try:
        torch.multiprocessing.start_processes(
            mesh4_rank, args=(d,), nprocs=4, start_method="spawn", join=True)
        rows = json.loads(Path(d, "rows.json").read_text())
        served = torch.load(Path(d, "served.pt"), weights_only=False)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    mesh4_serve_checks(serve_ref, served, dry)
    bad = []
    for row in rows:
        f32 = row["dtype"] == "float32"
        want = ref32 if f32 else ref
        for k in ("losses", "grad_norms"):
            err = max(abs(a - b) / abs(b) for a, b in zip(row[k], want[k]))
            row[k + "_rel_err"] = err
            tol = MESH4_F32_TOL if f32 else MESH4_TOL[k]
            if err > tol:
                bad.append(f"mesh {row['mesh']} {row['dtype']} sp "
                           f"{row['sequence_parallel']}: {k} {row[k]} "
                           f"against the meshless {want[k]} ({err} > {tol})")
        if not f32:
            row["meshless_step_ms_median_2_3"] = ref["step_ms_median_2_3"]
            row["meshless_peak_mem_bytes"] = ref["peak_mem_bytes"]
        emit({"phase": "mesh4_train", **row})
    need(not bad, "; ".join(bad))


def mesh4_rank(rank: int, d: str) -> None:
    """One rank of ``mesh4_phase``: card ``rank``, NCCL."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_for
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{d}/pg", rank=rank,
                            world_size=4, device_id=dev,
                            timeout=datetime.timedelta(seconds=300))
    rows = []
    try:
        cfg = get_config(TRAIN_ARCH)
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    n_layers=MESH4_F32_LAYERS)
        runs = [(cfg, shape, False) for shape in MESH4_SHAPES] + [
            (cfg, shape, True) for shape in MESH4_SP_SHAPES] + [
            (cfg32, shape, sp) for shape, sp in MESH4_F32_RUNS]
        for c, shape, sp in runs:
            mesh = make_mesh_for(4, shape[1], "cuda")
            tr = trainer(c, TRAIN_SEQ, TRAIN_BATCH, MESH_STEPS, dev,
                         mesh=mesh, sequence_parallel=sp)
            torch.cuda.reset_peak_memory_stats(dev)
            tr.run()
            peak = torch.tensor([torch.cuda.max_memory_allocated(dev)],
                                device=dev)
            peaks = [torch.zeros_like(peak) for _ in range(4)]
            dist.all_gather(peaks, peak)
            batch = tr.batch(tr.step)
            torch.cuda.synchronize(dev)
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                tr._one_step(batch)
                wall = (time.perf_counter() - t0) * 1e3
            kernels = kernel_ms(torch, prof)
            nccl = {k[:60]: v for k, v in kernels.items()
                    if "nccl" in k.lower()}
            rows.append({
                "model": cfg.name, "mesh": list(shape), "ranks": 4,
                "dtype": c.dtype, "layers": c.n_layers,
                "sequence_parallel": sp, "steps": MESH_STEPS,
                "losses": [m["loss"] for m in tr.metrics_log],
                "grad_norms": [m["grad_norm"] for m in tr.metrics_log],
                "step_ms": [m["step_time_s"] * 1e3 for m in tr.metrics_log],
                "step_ms_median_2_3": statistics.median(
                    m["step_time_s"] for m in tr.metrics_log[1:]) * 1e3,
                "peak_mem_bytes_by_rank": [int(p) for p in peaks],
                "rank0_profiled_step_wall_ms": wall,
                "rank0_profiled_step_device_ms": sum(kernels.values()),
                "rank0_nccl_ms_a_step": sum(nccl.values()),
                "rank0_nccl_kernels_a_step": sum(
                    1 for name, _, _ in device_records(torch, prof)
                    if "nccl" in name.lower()),
                "rank0_nccl_ms_by_kernel": nccl})
            del tr
            torch.cuda.empty_cache()
        served = mesh4_rank_serve(torch, dev)
        if rank == 0:
            Path(d, "rows.json").write_text(json.dumps(rows))
            torch.save(served, Path(d, "served.pt"))
    finally:
        dist.destroy_process_group()


def mesh4_rank_serve(torch, dev) -> dict:
    """One rank's meshed serving (``mesh4_serve``) on each mesh shape in
    float32 and bf16: {(dtype, shape): the logits, and every rank's bytes
    (gathered)}."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.parallel.mesh_ctx import make_ctx
    out = {}
    for shape in MESH4_SHAPES:
        ctx = make_ctx(make_mesh_for(4, shape[1], "cuda"))
        for dt in ("float32", "bfloat16"):
            r = mesh4_serve(torch, dev, dt, ctx)
            sizes = torch.tensor([r["shard_bytes"], r["requested_bytes"],
                                  r["allocated_bytes"],
                                  r["weights_allocated_bytes"],
                                  r["shards"]],
                                 dtype=torch.int64, device=dev)
            every = [torch.zeros_like(sizes) for _ in range(4)]
            dist.all_gather(every, sizes)
            r["by_rank"] = [t.tolist() for t in every]
            out[(dt, shape)] = r
    return out


def mesh4_serve_checks(ref: dict, served: dict, dry: dict) -> None:
    """Every step's float32 logits on each mesh within MESH4_LOGIT_TOL of
    one card's meshless run, relative to its logit scale (the bf16
    distance reported), and every rank's weight and cache shards, as
    tensors and as the allocator's requested bytes, equal to the dry
    run's arguments less the token and pos bytes.  The growth of
    ``memory_allocated`` counts whole blocks: the allocator rounds a
    request up to 512 bytes and leaves a cached block unsplit when the
    rest would be 1 MiB or less, so it may exceed that by as much a
    tensor, and no more.  The launches of each kernel on each mesh: the
    prefill's attention layers, and per decode step either the whole-head
    kernel or the split mode's two launches a layer."""
    import numpy as np
    from repro_torch.configs import get_config
    for (dt, shape), r in sorted(served.items()):
        errs = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(r["logits"], ref[dt]["logits"])]
        args = dry[shape]["input_bytes"]
        want = args["params"] + args["cache"]
        row = {"phase": "mesh4_serve", "model": TRAIN_ARCH, "dtype": dt,
               "mesh": list(shape), "ranks": 4, "batch": MESH4_B,
               "prompt": MESH4_PROMPT, "max_len": MESH4_MAX_LEN,
               "decode_steps": MESH4_STEPS,
               "logit_rel_err_by_step": errs, "logit_rel_err_max": max(errs),
               "by_rank_shard_requested_allocated_weights_shards":
                   r["by_rank"],
               "dry_run_per_device_bytes": dry[shape]["per_device_bytes"],
               "dry_run_input_bytes": args,
               "dry_run_arguments_less_tokens_pos": want}
        # where the KV heads do not divide the model axis the cache is
        # split by head dim: two split-mode launches a layer and step
        cfg = get_config(TRAIN_ARCH)
        layers = cfg.n_layers
        want_launches = ({"paged_attention_scores": layers * MESH4_STEPS,
                          "paged_attention_apply": layers * MESH4_STEPS}
                         if cfg.n_kv_heads % shape[1] else
                         {"paged_attention": layers * MESH4_STEPS})
        row["launches"] = r["launches"]
        emit(row)
        need(all(r["launches"].get(k, 0) == n
                 for k, n in want_launches.items())
             and r["launches"].get("flash_attention", 0) == layers,
             f"meshed serving on {shape}: launches {r['launches']}, "
             f"expected {want_launches} and {layers} flash_attention")
        if dt == "float32":
            need(max(errs) <= MESH4_LOGIT_TOL,
                 f"meshed serving on {shape}: logits {max(errs)} from the "
                 f"meshless run's, relative to their scale")
            need(all(b[0] == b[1] == want
                     and 0 <= b[2] - want <= b[4] * (2**20 + 512)
                     for b in r["by_rank"]),
                 f"meshed serving on {shape}: shard, requested and "
                 f"allocated bytes by rank {r['by_rank']}, the dry run's "
                 f"arguments less tokens and pos {want}")


def train_phase(torch, dev, flush, parent_dir=None):
    """The training phase: the backward rows, the full-width trainer, the
    float32 and bf16 cuts on card and CPU, the restart.  Returns (the
    bf16 slice row of the backward, its launches on the main path)."""
    rows = bwd_checks(torch, dev, flush, parent_dir)
    torch.cuda.empty_cache()
    launches = train_full_width(torch, dev)
    mesh_phase(torch, dev)
    train_cut(torch, dev, "float32")
    train_cut(torch, dev, "bfloat16")
    train_restart(torch, dev)
    torch.cuda.empty_cache()
    return rows["slice"], launches.get("flash_attention_bwd", 0)


# the backward's device kernels; the walks run only where a call has more
# than one chunk or an initial state
SSD_BWD_KERNELS = ("ssd_bwd_walk_kernel", "ssd_bwd_chunk_kernel",
                   "ssd_bwd_sum_kernel")
# (case, b, l, (H, G, n, p), initial state, dstate): both training
# shapes, mamba2's prefill length, ragged with both states, two groups,
# the smoke shape
SSD_BWD_CASES = (
    ("mamba2_train", 8, 128, SSD_MAMBA, False, False),
    ("zamba2_train", 8, 128, SSD_ZAMBA, False, False),
    ("long_1024", 4, 1024, SSD_MAMBA, False, False),
    ("ragged_200_states", 2, 200, SSD_MAMBA, True, True),
    ("groups_2", 2, 512, (64, 2, 128, 64), False, False),
    ("smoke", 8, 128, SSD_SMOKE, False, False))
SSD_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "zamba2-2.7b"


def ssd_bwd_bound(x, B, l, chunk, has_init, has_dstate):
    """(flops, bytes) of the SSD scan's gradient: over the positions < l,
    the causal half of each chunk's square products, C B^T once per
    (b, group) (its scores are shared by the group's heads) and per (b, h)
    dy u^T and M^T dy over p, Wd B and Wd^T C over n (2n + 2p a pair);
    four (p x n) products a position per (b, h) (dS B, S0^T dy, whose
    product with C is also R, dS^T u and the dS update) and one more a
    position before the last chunk (the entering states recomputed); x, dy
    and dx once, dt and ddt, B, C, dB and dC once per group, A and dA, and
    the states given or written."""
    b, _, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pairs = 0
    for c0 in range(0, l, chunk):
        v = min(chunk, l - c0)
        pairs += v * (v + 1) // 2
    recompute = max(0, -(-l // chunk) - 1) * chunk    # chunks before the last
    flops = 2 * (b * g * pairs * n
                 + b * h * (pairs * (2 * n + 2 * p) + 4 * l * p * n
                            + recompute * p * n))
    e = x.element_size()
    nbytes = (3 * b * l * h * p * e + 2 * 4 * b * l * h + 2 * 4 * h
              + 4 * b * l * g * n * B.element_size()
              + 4 * b * h * p * n * (2 * has_init + has_dstate))
    return flops, nbytes


def ptxas_usage(needle: str) -> dict:
    """{entry: {registers, spill stores, spill loads}} of the kernels
    whose mangled names hold ``needle``, from the build's ``-Xptxas=-v``
    log (empty when this run loaded an earlier build)."""
    from repro_torch import _build
    out, entry = {}, None
    for ln in str(_build.build_info.get("log", "")).splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entry = name if needle in name else None
            if entry:
                out[entry] = {}
        elif entry and "spill stores" in ln:
            w = ln.replace(",", " ").split()
            out[entry]["spill_stores"] = int(w[w.index("spill") - 2])
            out[entry]["spill_loads"] = int(w[-4])
        elif entry and "Used" in ln and "registers" in ln:
            w = ln.replace(",", " ").split()
            out[entry]["registers"] = int(w[w.index("Used") + 1])
    return out


def ssd_bwd_ptxas(torch, p: int, n: int, dt_) -> dict:
    """ptxas's registers and spills of the backward's kernels for (p, n)
    and the type (the sum kernel's for the type), by mangled name."""
    tag = "I13__nv_bfloat16" if dt_ == torch.bfloat16 else "If"
    return {k: v for k, v in ptxas_usage("ssd_bwd").items()
            if tag in k and ("sum_kernel" in k or f"Li{p}ELi{n}E" in k)}


def parent_module(root, module: str):
    """Module ``module`` (e.g. ``kernels.ssd_scan.ops``) of the port in an
    earlier checkout ``root``, imported beside this tree's as the package
    ``parent_repro_torch``: its own wrappers, C interface and library (built
    by its own ``_build`` into ``root/build/``), so that the earlier tree's
    kernels run through its own entry points in this process; None without
    ``root``."""
    if root is None:
        return None
    import importlib
    import importlib.util
    name = "parent_repro_torch"
    if name not in sys.modules:
        pkg = Path(root).resolve() / "src" / "repro_torch"
        need((pkg / "__init__.py").exists(), f"no port under {root}")
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.{module}")


def host_ms(torch, fn, reps: int = 10) -> float:
    """Median host time of one call of ``fn`` (its checks, allocations
    and launches; the device drained before each), in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def ssd_bwd_row(torch, dev, g, case, b, l, shape, dt_, init, dstate,
                flush, parent=None) -> dict:
    """ssd_scan's backward against its plain version
    (``ssd_plain_backward``, autograd through ``ssd_plain``) on one
    random input set: every gradient within BWD_TOL of its largest
    magnitude, two calls bit-equal, launches counted under the design of
    the type, one launch of each of its device kernels a call (the walks
    only with more than one chunk or an initial state; read from a
    captured CUDA graph, ``graph_nodes``); the call timed by
    CUDA events (L2 flushed), each launch by the profiler, beside its bound
    (float32: ``piece_bounds``, as the other float32 rows), the plain
    version (no PyTorch call computes this gradient: library_ms is None)
    and, given ``parent`` (an earlier tree's ``ssd_scan.ops``,
    ``parent_module``), that tree's ``ssd_backward`` on the same inputs:
    its distance from the plain version and its device and host times
    beside this tree's."""
    from repro_torch import _build
    from repro_torch.kernels.ssd_scan import ops, ref
    h, G, n, p = shape
    chunk = 128
    x = (torch.randn(b, l, h, p, generator=g, device=dev) * 0.5).to(dt_)
    dt = torch.rand(b, l, h, generator=g, device=dev) * 0.5 + 0.1
    A = -(torch.rand(h, generator=g, device=dev) * 0.5 + 0.5)
    bc = (torch.randn(b, l, 2 * G * n, generator=g, device=dev)
          * 0.3).to(dt_)
    Bm = bc[..., :G * n].reshape(b, l, G, n)
    Cm = bc[..., G * n:].reshape(b, l, G, n)
    s0 = torch.randn(b, h, p, n, generator=g, device=dev) * 0.5 \
        if init else None
    ds = torch.randn(b, h, p, n, generator=g, device=dev) * 0.5 \
        if dstate else None
    dy = torch.randn(b, l, h, p, generator=g, device=dev).to(dt_)
    run_k = lambda: ops.ssd_backward(x, dt, A, Bm, Cm, chunk, s0, dy, ds)
    run_p = lambda: ref.ssd_plain_backward(x, dt, A, Bm, Cm, chunk, s0,
                                           dy, ds)
    design = ops.BWD_DESIGNS[dt_]
    _build.reset_counts()
    got = run_k()
    need(_build.launches.get("ssd_scan_bwd") == 1
         and _build.launches.get("ssd_scan_bwd." + design) == 1,
         f"ssd_scan_bwd {case}: launches {dict(_build.launches)}, expected "
         f"one call of the {design} design")
    want = run_p()
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype_name(dt_)]
    names = ("dx", "ddt", "dA", "dB", "dC", "dinit")
    errs = {}
    for name, a, w in zip(names, got, want):
        need((a is None) == (w is None), f"ssd_scan_bwd {case}: {name}")
        if w is not None:
            need(a.shape == w.shape and a.dtype == w.dtype,
                 f"ssd_scan_bwd {case} {name}: {a.shape} {a.dtype} vs "
                 f"{w.shape} {w.dtype}")
            errs[name] = scaled_err(torch, a, w, tol,
                                    f"ssd_scan_bwd {case} {name}")
    again = run_k()
    torch.cuda.synchronize()
    need(all(torch.equal(a, c) for a, c in zip(got, again)
             if a is not None), f"ssd_scan_bwd {case}: two calls differ")
    # a call's device kernels judged from a captured CUDA graph (the
    # profiler's tracer drops records; the graph cannot), their times from
    # the profiler
    kernels = tuple(k for k in SSD_BWD_KERNELS
                    if k != "ssd_bwd_walk_kernel" or l > chunk or init)
    nodes = graph_nodes(torch, run_k)
    knames = [nm for kind, nm in nodes if kind == "kernel"]
    need(len(nodes) == len(knames) == len(kernels)
         and all(sum(k in nm for nm in knames) == 1 for k in kernels),
         f"ssd_scan_bwd {case}: a call's graph nodes {nodes}, expected one "
         f"kernel node each of {kernels}")
    split = call_kernels(torch, run_k, "ssd_scan_bwd", case, kernels)
    flops, nbytes = ssd_bwd_bound(x, Bm, l, chunk, init, dstate)
    if dt_ == torch.float32:
        bound_ms, bound_by, bounds = piece_bounds(flops, nbytes)
    else:
        bound_ms, bound_by = bound(flops, nbytes, dt_)
        bounds = {"fma_bound_ms": flops / PEAK_FLOPS["float32"] * 1e3}
    parent_row = None
    if parent is not None:
        run_q = lambda: parent.ssd_backward(x, dt, A, Bm, Cm, chunk, s0, dy,
                                            ds)
        theirs = run_q()
        torch.cuda.synchronize()
        event_ms(torch, run_q, reps=2, flush=flush)         # warm-up
        parent_row = {
            "ms": event_ms(torch, run_q, reps=10, flush=flush),
            "host_ms": host_ms(torch, run_q),
            "max_scaled_err": max(
                float((a.float() - w.float()).abs().max())
                / max(float(w.float().abs().max()), 1e-30)
                for a, w in zip(theirs, want) if w is not None)}
    event_ms(torch, run_k, reps=2, flush=flush)             # warm-up
    row = {"name": "ssd_scan_bwd", "case": case, "design": design,
           "shape": {"b": b, "l": l, "h": h, "p": p, "g": G, "n": n,
                     "chunk": chunk},
           "dtype": dtype_name(dt_), "initial_state": init,
           "dstate": dstate,
           "max_abs_err": max(float((a.float() - w.float()).abs().max())
                              for a, w in zip(got, want) if w is not None),
           "max_scaled_err": errs, "tol": tol, "bit_equal_twice": True,
           "device_kernels": split, "graph_nodes": nodes,
           "ptxas": ssd_bwd_ptxas(torch, p, n, dt_),
           "blocks_per_sm": ops.bwd_blocks_per_sm(p, n, chunk, dt_),
           "ms": event_ms(torch, run_k, reps=10, flush=flush),
           "host_ms": host_ms(torch, run_k), "parent": parent_row,
           "plain_ms": event_ms(torch, run_p, reps=2, flush=flush),
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by, **bounds,
           "library_ms": None, "library_call": "none"}
    emit({"phase": "kernel_vs_plain", **row})
    return row


def ssd_bwd_checks(torch, dev, flush, parent_dir=None) -> dict:
    """The SSD scan's backward against its plain version, every
    SSD_BWD_CASES case in bf16 and float32 (rows of float32 cases
    suffixed), each naming its design (bf16 ``mma``, float32 ``mma3``)
    and, given ``parent_dir`` (``--parent-ssd-bwd``), an earlier
    checkout's backward timed on the same inputs.  Returns the rows by
    case."""
    g = torch.Generator(device=dev).manual_seed(26)
    parent = parent_module(parent_dir, "kernels.ssd_scan.ops")
    rows = {}
    for (base, b, l, shape, init, dstate), dt_ in (
            (c, dt_) for c in SSD_BWD_CASES
            for dt_ in (torch.bfloat16, torch.float32)):
        case = base if dt_ == torch.bfloat16 else base + "_float32"
        rows[case] = ssd_bwd_row(torch, dev, g, case, b, l, shape, dt_,
                                 init, dstate, flush, parent)
    return rows


def ssd_bwd_step_ab(torch, dev, arch: str, parent, rounds: int = 6) -> dict:
    """``arch``'s full-width training step (as ``train_full_width`` builds
    it) with this tree's ``ssd_backward`` and with an earlier tree's
    (``parent``, its ``ssd_scan.ops``) in turn, in one process on one
    batch: after a step of each, ``rounds`` rounds of change, parent,
    parent, change.  Each step's wall (``Trainer`` ends a step in a device
    sync), and in how many rounds the change's pair of steps took longer
    than the parent's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops
    mine = ops.ssd_backward
    tr = trainer(get_config(arch), TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, dev)
    batch = tr.batch(0)
    walls = {"change": [], "parent": []}

    def step(which):
        ops.ssd_backward = mine if which == "change" else parent.ssd_backward
        try:
            ms = tr._one_step(batch)["step_time_s"] * 1e3
        finally:
            ops.ssd_backward = mine
        walls[which].append(ms)
        return ms
    step("change")
    step("parent")
    for w in walls.values():
        w.clear()
    slower = 0
    for _ in range(rounds):
        change = step("change")
        parent_pair = step("parent") + step("parent")
        slower += change + step("change") > parent_pair
    del tr
    torch.cuda.empty_cache()
    row = {"phase": "ssd_bwd_step_ab", "model": arch, "rounds": rounds,
           "step_ms": walls, "change_slower_rounds": slower,
           **{f"{w}_median_ms": statistics.median(v)
              for w, v in walls.items()}}
    emit(row)
    return row


def train_ssm_phase(torch, dev, flush, full_hybrid: bool = False,
                    parent_dir=None):
    """The ssm and hybrid families' training: the ssd_scan backward rows,
    ``Trainer`` on mamba2-1.3b at full width and depth, the float32 cuts of
    mamba2-1.3b (2 layers) and zamba2-2.7b (one super-block: 6 Mamba2
    layers and the shared block) on card and CPU, a mamba2 restart; with
    ``full_hybrid`` (``--only train_ssm``) zamba2-2.7b at full width and
    depth too; ``parent_dir`` (``--parent-ssd-bwd``): an earlier
    checkout's backward timed beside every backward row, and the two
    training steps' walls with either backward in turn
    (``ssd_bwd_step_ab``).  Returns (the bf16 mamba2 training-shape row,
    the ssd_scan_bwd launches of the mamba2 run)."""
    from repro_torch.configs import get_config
    rows = ssd_bwd_checks(torch, dev, flush, parent_dir)
    torch.cuda.empty_cache()
    launches = train_full_width(torch, dev, SSD_ARCH)
    train_cut(torch, dev, "float32", SSD_ARCH, CUT_LAYERS)
    # the hybrid's free-running steps amplify float32 rounding (AdamW's
    # first steps move every weight by about lr whatever its gradient's
    # size): its steps are held one at a time, beside a one-ulp CPU run
    train_cut(torch, dev, "float32", HYBRID_ARCH,
              get_config(HYBRID_ARCH).attn_every, from_cpu_state=True)
    train_restart(torch, dev, SSD_ARCH)
    if full_hybrid:
        train_full_width(torch, dev, HYBRID_ARCH)
    torch.cuda.empty_cache()
    if parent_dir is not None:
        parent = parent_module(parent_dir, "kernels.ssd_scan.ops")
        for arch in (SSD_ARCH, HYBRID_ARCH):
            ssd_bwd_step_ab(torch, dev, arch, parent)
    return rows["mamba2_train"], launches.get("ssd_scan_bwd", 0)


def hms_scan_timing(torch, T, dev, flush) -> None:
    """``--only hms_scan``: pathfnd at its default size, one config at
    (1, 1), the call the kernel_vs_plain row times: the ``hms_scan``
    wrapper's call, the kernel alone, and ``ema_scan`` as a control, each
    in 3 windows of 5 runs.  A copy of this script beside another
    checkout's ``src/`` measures that checkout, so two trees compare in
    one call (parent, change, change, parent)."""
    from repro_torch.core import simulator as sim
    from repro_torch.kernels.hms_scan import ops as scan_ops

    t = T.make_trace("pathfnd")
    cfg = T.HMSConfig(footprint=t.footprint).validate()
    s = sim.scan_inputs(t, cfg, dev)
    run_k = lambda: scan_ops.hms_scan(s["slot"], s["meta"], **s["scan"])
    pen = s["derived"]["pen64"]
    w = float(s["params"]["ema_weight"])
    run_k()
    windows = [{"call_ms": event_ms(torch, run_k, reps=5, flush=flush),
                "kernel_ms": device_ms(torch, run_k, "hms_chain_kernel",
                                       "hms_scan_launch", reps=5),
                "ema_ms": event_ms(torch, lambda: scan_ops.ema_scan(pen, w),
                                   reps=5, flush=flush)}
               for _ in range(3)]
    emit({"phase": "hms_scan_timing", "trace": t.name, "n": t.n,
          "shards": s["key"].shards, "lanes": s["slot"].shape[0],
          "src": str(ROOT / "src"), "windows": windows,
          **{k: statistics.median(r[k] for r in windows)
             for k in ("call_ms", "kernel_ms", "ema_ms")}})


class capture:
    """Record the arguments of the first ``keep`` calls of a kernel's
    wrapper ``module.name`` made inside the block (tensors cloned, so
    what a later round writes cannot change them), and pass every call on
    to the wrapper unchanged: the main path's own inputs, for holding the
    kernel against its plain version afterwards."""

    def __init__(self, torch, module, name: str, keep: int):
        self.torch, self.module, self.name, self.keep = (torch, module, name,
                                                         keep)
        self.calls = []

    def _clone(self, v):
        if isinstance(v, self.torch.Tensor):
            return v.clone()
        if isinstance(v, tuple):
            return tuple(self._clone(x) for x in v)
        return v

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def rec(*args, **kw):
            if len(self.calls) < self.keep:
                self.calls.append(([self._clone(a) for a in args],
                                   {k: self._clone(v) for k, v in kw.items()}))
            return self.orig(*args, **kw)

        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def scan_call_vs_plain(torch, scan_ops, scan_ref, call, what: dict,
                       cycle_ms) -> dict:
    """One recorded ``hms_scan`` call of the main path (per-lane CTC ways,
    set counts and row-group sizes, seeded cache words and CTC rows, the
    live bits of its round, the stitch's ``prepared`` plan) run again
    through the kernel and through its plain version on the same inputs:
    decision words and final state exactly."""
    args, kw = call
    plain_kw = {k: v for k, v in kw.items() if k not in ("spg", "prepared")}
    got = scan_ops.hms_scan(*args, **kw)
    plain = []
    plain_ms = event_ms(torch, lambda: plain.append(
        scan_ref.hms_scan_reference(*args, **plain_kw)))
    err = max(same(torch, a, b) for a, b in zip(got, plain[0]))
    ms = event_ms(torch, lambda: scan_ops.hms_scan(*args, **kw), reps=3)
    slot, meta = args
    lanes, depth = slot.shape
    live = int(((meta >> 16) & 1).sum())
    plan = kw["prepared"].plan if kw.get("prepared") else \
        scan_ops.scan_plan(slot, meta, **kw)
    chain_ms = plan.longest_chain * STEP_CYCLES * cycle_ms
    bytes_ms = lanes * depth * 16 / HBM_BYTES_PER_S * 1e3
    row = {"phase": "kernel_vs_plain", "name": "hms_scan", **what,
           "lanes": lanes, "depth": depth, "live_steps": live,
           "dead_steps": lanes * depth - live,
           "e_ways": sorted(set(scan_ops.per_lane("e_ways", kw["e_ways"],
                                                  lanes))),
           "n_sets": sorted(set(scan_ops.per_lane("n_sets", kw["n_sets"],
                                                  lanes))),
           "seeded": kw.get("cache") is not None
           and bool((kw["cache"] != 0).any()),
           "longest_chain": plan.longest_chain, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(chain_ms, bytes_ms),
           "bound_by": "operations" if chain_ms >= bytes_ms else "bytes"}
    emit(row)
    return row


def um_call_vs_plain(torch, um_ops, um_ref, call, what: dict) -> dict:
    """One recorded ``um_scan`` call of the main path's split run ((T, L)
    gathered streams, the ``real``/``live`` gates of its round, seeded
    carries) run again through the kernel and its plain version: counts
    and final state exactly."""
    args, kw = call
    got = um_ops.um_scan(*args, **kw)
    plain = []
    plain_ms = event_ms(torch, lambda: plain.append(
        um_ref.um_scan_reference(*args, **kw)))
    err = max([same(torch, got[0], plain[0][0])]
              + [same(torch, a, b) for a, b in zip(got[1], plain[0][1])])
    ms = event_ms(torch, lambda: um_ops.um_scan(*args, **kw), reps=3)
    page = args[0]
    real, live = kw["real"], kw["live"]
    row = {"phase": "kernel_vs_plain", "name": "um_scan", **what,
           "rows": page.shape[0], "row_len": page.shape[1],
           "lanes": len(kw["n_frames"]) * page.shape[0],
           "real_steps": int(real.sum()), "live_steps": int(live.sum()),
           "seeded": bool((kw["state"][0] != 0).any()),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "faults": got[0][:, 0].sum().item()}
    emit(row)
    return row


def lanes_phase(torch, T, dev, traces, cycle_ms) -> None:
    """The sweep engine's lanes at the main path's size (see the module
    docstring, phase 5c): fig18's grid and the sweep grid as one batch,
    the forced (S, T) shapes, UM segments, the planner's shapes against
    (1, 1), the kernels against their plain versions on recorded rounds,
    and the faulted sweep.  Launch counts are read around each batched
    call and must equal its stitch rounds (one ``hms_scan`` launch a
    round); outside the faulted sweep every run must stay on its planned
    (or forced) rung with no ladder event."""
    from repro_torch import _build
    from repro_torch.core import costmodel, tsplit
    from repro_torch.core import simulator as sim
    from repro_torch.kernels.hms_scan import ops as scan_ops
    from repro_torch.kernels.hms_scan import ref as scan_ref
    from repro_torch.kernels.um_scan import ops as um_ops
    from repro_torch.kernels.um_scan import ref as um_ref
    from repro_torch.resilience import faults
    from repro_torch.um import engine as um_engine

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def forced(S, Tt, replay=0):
        """Pin (S, T) and the replay prefix; returns the undo."""
        old = (costmodel.set_forced_shards(S), costmodel.set_forced_tsplit(Tt),
               tsplit.set_replay_prefix(replay))
        return lambda: (costmodel.set_forced_shards(old[0]),
                        costmodel.set_forced_tsplit(old[1]),
                        tsplit.set_replay_prefix(old[2]))

    def on_rung(run, S, Tt, what):
        """The run stayed on the shape it was given: no ladder event, its
        first rung, its shards and segments."""
        need(not run["events"] and run["rung"] == f"S{S}T{Tt}"
             and run["shards"] == S and run["t_segments"] == Tt,
             f"{what}: ran {run['rung']} at ({run['shards']}, "
             f"{run['t_segments']}) with events {run['events']}, not "
             f"S{S}T{Tt}")

    def batch(t, cfgs):
        """simulate_many over one group: results, wall, launches, runs."""
        key = sim.group_engine_key(t, cfgs)
        before = _build.launches.get("hms_scan", 0)
        del sim._RUNS[:]
        rs, wall = timed(lambda: T.simulate_many(t, cfgs))
        runs = list(sim._RUNS)
        launched = _build.launches.get("hms_scan", 0) - before
        need(launched == sum(r["rounds"] for r in runs),
             f"{t.name}: {launched} hms_scan launches for "
             f"{sum(r['rounds'] for r in runs)} stitch rounds")
        for r in runs:
            on_rung(r, key.shards, key.t_segments, f"{t.name} batch")
        return rs, wall, launched, runs

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # fig18's grid: one batch a workload against the six sequential calls
    for w in FIG_WORKLOADS[:5]:
        t = traces[(w, None)]
        cfgs = [T.HMSConfig(footprint=t.footprint, **kw) for kw in FIG18_GRID]
        seq = [T.simulate(t, c) for c in cfgs]          # warms host caches
        walls = [timed(lambda: T.simulate(t, c))[1] for c in cfgs]
        rs, wall, launched, runs = batch(t, cfgs)
        need(len(runs) == 1 and runs[0]["batch"] == len(cfgs),
             f"{w}: fig18's grid ran as {len(runs)} groups, not one batch")
        need(all(counter_bits(a) == counter_bits(b) for a, b in zip(rs, seq)),
             f"{w}: fig18's batch differs from simulate")
        kernel_ms = device_ms(torch, lambda: T.simulate_many(t, cfgs),
                              "hms_chain_kernel", "hms_scan_launch", reps=1)
        emit({"phase": "lanes_fig18", "workload": w, "n": t.n,
              "configs": len(cfgs), "shards": runs[0]["shards"],
              "t_segments": runs[0]["t_segments"],
              "lanes": len(cfgs) * runs[0]["shards"]
              * runs[0]["t_segments"], "rounds": runs[0]["rounds"],
              "hms_scan_launches": launched, "batched_wall_s": wall,
              "sequential_walls_s": walls, "sequential_wall_s": sum(walls),
              "batched_kernel_ms": kernel_ms, "bit_equal": True})

    # the sweep grid at n = 20000: one batch a workload, against the
    # committed counters; then the grid's launch on the first workload cut
    # to SWEEP_PLAIN_N requests is recorded and held against the plain
    # version (the planner's shape, per-lane CTC ways and set counts)
    base = json.loads(BASELINE.read_text())
    sweep_traces = baseline_traces(T, base)

    def sweep_equal(w, rs):
        entry = base["workloads"][w]
        return all(not counter_diffs(r.counters, entry["point_counters"][i])
                   and math.isclose(r.runtime_cycles,
                                    entry["point_runtime_cycles"][i],
                                    rel_tol=1e-9)
                   for i, r in enumerate(rs))

    for w in base["workloads"]:
        t = sweep_traces[w][0]
        cfgs = [T.HMSConfig(footprint=t.footprint, **kw)
                for kw in base["grid"]]
        rs, wall, launched, runs = batch(t, cfgs)
        need(len(runs) == 1 and sweep_equal(w, rs),
             f"{w}: the batched sweep grid differs from BENCH_sweep.json "
             f"or ran as {len(runs)} groups")
        emit({"phase": "lanes_sweep", "workload": w, "n": t.n,
              "configs": len(cfgs), "shards": runs[0]["shards"],
              "t_segments": runs[0]["t_segments"],
              "rounds": runs[0]["rounds"], "hms_scan_launches": launched,
              "wall_s": wall, "equals_baseline": True})
    t = T.make_trace(next(iter(base["workloads"])), n=SWEEP_PLAIN_N)
    cfgs = [T.HMSConfig(footprint=t.footprint, **kw) for kw in base["grid"]]
    with capture(torch, scan_ops, "hms_scan", 1) as rec:
        _, _, _, runs = batch(t, cfgs)
    need(len(runs) == 1, f"{t.name}: the sweep grid ran as {len(runs)} "
         "groups")
    scan_call_vs_plain(torch, scan_ops, scan_ref, rec.calls[0], {
        "case": "sweep_grid_planned", "trace": t.name, "n": t.n,
        "configs": len(cfgs), "shards": runs[0]["shards"],
        "t_segments": runs[0]["t_segments"], "round": 0}, cycle_ms)

    # a split round's inputs: fig18's batch on pathfnd (cut to
    # SPLIT_ROUND_N requests) at a forced (4, 16) with replay LANE_REPLAY;
    # the warm-up round (cold state, replay steps live) and the next
    # (seeded state, replay steps dead) against the plain version, the
    # batch's counters against simulate's
    t = T.make_trace("pathfnd", n=SPLIT_ROUND_N)
    cfgs = [T.HMSConfig(footprint=t.footprint, **kw) for kw in FIG18_GRID]
    undo = forced(4, 16, LANE_REPLAY)
    try:
        with capture(torch, scan_ops, "hms_scan", 2) as rec:
            rs, wall, launched, runs = batch(t, cfgs)
    finally:
        undo()
    need(all(counter_bits(a) == counter_bits(T.simulate(t, c))
             for a, c in zip(rs, cfgs)),
         "pathfnd: fig18's batch at (4, 16) differs from simulate")
    for i, call in enumerate(rec.calls):
        row = scan_call_vs_plain(torch, scan_ops, scan_ref, call, {
            "case": "fig18_split_round", "trace": t.name,
            "configs": len(cfgs), "shards": 4, "t_segments": 16,
            "replay": LANE_REPLAY, "round": i, "rounds": runs[0]["rounds"],
            "hms_scan_launches": launched}, cycle_ms)
        need(row["seeded"] == (i > 0), f"round {i}: seeded {row['seeded']}")

    # forced (S, T), at replay 0 and LANE_REPLAY: bit-identical counters,
    # each run on its forced rung, one launch a round
    for key in (("pathfnd", None), ("zipf", 10**6)):
        t = traces[key]
        cfg = T.HMSConfig(footprint=t.footprint)
        want = None
        rows = []
        for replay in (0, LANE_REPLAY):
            for S, Tt in LANE_SHAPES:
                undo = forced(S, Tt, replay)
                try:
                    before = _build.launches.get("hms_scan", 0)
                    r, wall = timed(lambda: T.simulate(t, cfg))
                    run = sim._RUNS[-1]
                    predicted = costmodel.plan_hms_split(
                        sim.plan_depth(t, [cfg]), 1,
                        replay).predicted_us
                finally:
                    undo()
                launched = _build.launches.get("hms_scan", 0) - before
                on_rung(run, S, Tt, f"{t.name} forced ({S}, {Tt})")
                need(launched == run["rounds"],
                     f"{t.name} ({S}, {Tt}): {launched} launches for "
                     f"{run['rounds']} rounds")
                bits = counter_bits(r)
                want = bits if want is None else want
                rows.append({"shards": S, "t_segments": Tt,
                             "replay": replay, "rounds": run["rounds"],
                             "launches": launched, "wall_s": wall,
                             "predicted_us": predicted,
                             "bit_equal": bits == want})
        emit({"phase": "lanes_forced", "workload": t.name, "n": t.n,
              "profile": costmodel.active_profile().fingerprint,
              "shapes": rows})
        need(all(r["bit_equal"] for r in rows),
             f"{t.name}: counters differ across forced (S, T): {rows}")

    # UM segments: T in UM_SEGMENTS, both link modes in one call, each run
    # on its forced rung, one um_scan launch a round
    for w in ("llm_dec", "gpt_train"):
        t = traces[(w, None)]
        hbm = T.HMSConfig(footprint=t.footprint, organization="hbm")
        specs = [um_engine.um_spec(hbm, nv) for nv in (False, True)]
        need(specs[0].n_frames < um_engine._page_stream(t)[1],
             f"{w} does not page at its default size")
        want, rows = None, []
        for Tt in UM_SEGMENTS:
            undo = forced(None, Tt, LANE_REPLAY if Tt == UM_SEGMENTS[-1]
                          else 0)
            try:
                um_engine._RESULT_CACHE.pop(t, None)
                before = _build.launches.get("um_scan", 0)
                res, wall = timed(lambda: um_engine.simulate_um_many(t,
                                                                     specs))
                launched = _build.launches.get("um_scan", 0) - before
                run = um_engine._RUNS[-1]
                kernel_ms = device_ms(
                    torch, lambda: (um_engine._RESULT_CACHE.pop(t, None),
                                    um_engine.simulate_um_many(t, specs)),
                    "um_scan_kernel", "um_scan_launch", reps=1)
            finally:
                undo()
            need(not run["events"] and run["rung"] == f"T{Tt}"
                 and run["t_segments"] == Tt and launched == run["rounds"],
                 f"{w} T = {Tt}: rung {run['rung']}, T {run['t_segments']}, "
                 f"events {run['events']}, {launched} um_scan launches for "
                 f"{run['rounds']} rounds")
            got = [[getattr(r, f).tolist() for f in um_engine._FIELDS]
                   for r in res]
            want = got if want is None else want
            lanes = len(specs) * Tt
            rows.append({"t_segments": Tt, "lanes": lanes,
                         "sms_in_use": min(lanes, sms),
                         "replay": run["replay"], "rounds": run["rounds"],
                         "um_scan_launches": launched, "wall_s": wall,
                         "kernel_ms": kernel_ms, "bit_equal": got == want})
        emit({"phase": "lanes_um", "workload": w, "n": t.n,
              "frames": specs[0].n_frames, "segments": rows})
        need(all(r["bit_equal"] for r in rows),
             f"{w}: UM counters differ across T: {rows}")
    # llm_dec cut to UM_PLAIN_N requests (it still pages) at T = 16 with
    # replay LANE_REPLAY: its warm-up and next um_scan rounds recorded and
    # held against the plain version
    t = T.make_trace(UM_PLAIN_WORKLOAD, n=UM_PLAIN_N)
    hbm = T.HMSConfig(footprint=t.footprint, organization="hbm")
    specs = [um_engine.um_spec(hbm, nv) for nv in (False, True)]
    need(specs[0].n_frames < um_engine._page_stream(t)[1],
         f"{t.name} does not page at {t.n} requests")
    Tt = UM_SEGMENTS[-1]
    undo = forced(None, Tt, LANE_REPLAY)
    try:
        with capture(torch, um_ops, "um_scan", 2) as rec:
            um_engine.simulate_um_many(t, specs)
        run = um_engine._RUNS[-1]
    finally:
        undo()
    need(len(rec.calls) == 2, f"{t.name}: {len(rec.calls)} um_scan rounds "
         "recorded")
    for i, call in enumerate(rec.calls):
        row = um_call_vs_plain(torch, um_ops, um_ref, call, {
            "case": "split_round", "trace": t.name, "n": t.n,
            "t_segments": Tt,
            "replay": LANE_REPLAY, "round": i, "rounds": run["rounds"]})
        need(row["seeded"] == (i > 0)
             and (row["live_steps"] > row["real_steps"]) == (i == 0),
             f"um round {i}: seeded {row['seeded']}, live "
             f"{row['live_steps']}, real {row['real_steps']}")

    # the planner's shapes for the main path under the active profile
    prof = costmodel.active_profile()
    shapes = {}
    for (name, n), t in traces.items():
        k = sim.group_engine_key(t, [T.HMSConfig(footprint=t.footprint)])
        shapes[f"{name}@{t.n}"] = {
            "shards": k.shards, "t_segments": k.t_segments,
            "um_t_segments": costmodel.plan_um_split(t.n, 2).t_segments}
    emit({"phase": "lanes_planner", "profile": prof.fingerprint,
          "source": prof.source, "shapes": shapes})

    # the planner's shape against (1, 1) end to end, interleaved after a
    # warm-up: no slower than PLANNED_SLACK x the (1, 1) median
    for key in (("pathfnd", None), ("zipf", 10**6)):
        t = traces[key]
        cfg = T.HMSConfig(footprint=t.footprint)
        k = sim._engine_key(t, cfg)
        planned = (k.shards, k.t_segments)
        undo = forced(1, 1)
        try:
            one_us = costmodel.plan_hms_split(
                sim.plan_depth(t, [cfg]), 1).predicted_us
        finally:
            undo()
        walls = {"planned": [], "one": []}
        for rep in range(PLANNED_REPS + 1):
            for name in walls:
                undo = forced(1, 1) if name == "one" else (lambda: None)
                try:
                    _, wall = timed(lambda: T.simulate(t, cfg))
                    run = sim._RUNS[-1]
                finally:
                    undo()
                shape = planned if name == "planned" else (1, 1)
                on_rung(run, *shape, f"{t.name} {name}")
                if rep:
                    walls[name].append(wall)
        med = {n_: statistics.median(v) for n_, v in walls.items()}
        emit({"phase": "lanes_planned_vs_one", "workload": t.name, "n": t.n,
              "profile": prof.fingerprint, "planned": planned,
              "planned_predicted_us": sim._PLAN_BY_KEY[k].predicted_us,
              "one_predicted_us": one_us, "planned_wall_s": med["planned"],
              "one_wall_s": med["one"], "walls_s": walls,
              "ratio": med["planned"] / med["one"]})
        need(med["planned"] <= PLANNED_SLACK * med["one"],
             f"{t.name}: the planner's {planned} takes {med['planned']:.5f} "
             f"s, (1, 1) {med['one']:.5f} s")
    # the UM planner on llm_dec's two link-mode lanes against T = 1
    t = traces[("llm_dec", None)]
    hbm = T.HMSConfig(footprint=t.footprint, organization="hbm")
    specs = [um_engine.um_spec(hbm, nv) for nv in (False, True)]
    plan = costmodel.plan_um_split(t.n, len(specs))
    undo = forced(None, 1)
    try:
        one_us = costmodel.plan_um_split(t.n, len(specs)).predicted_us
    finally:
        undo()
    walls = {"planned": [], "one": []}
    for rep in range(PLANNED_REPS + 1):
        for name in walls:
            undo = forced(None, 1) if name == "one" else (lambda: None)
            try:
                um_engine._RESULT_CACHE.pop(t, None)
                _, wall = timed(lambda: um_engine.simulate_um_many(t, specs))
                run = um_engine._RUNS[-1]
            finally:
                undo()
            want_t = plan.t_segments if name == "planned" else 1
            need(not run["events"] and run["t_segments"] == want_t,
                 f"UM {name}: {run}")
            if rep:
                walls[name].append(wall)
    med = {n_: statistics.median(v) for n_, v in walls.items()}
    emit({"phase": "lanes_planned_vs_one", "workload": "um:" + t.name,
          "n": t.n, "profile": prof.fingerprint,
          "planned": (1, plan.t_segments),
          "planned_predicted_us": plan.predicted_us,
          "one_predicted_us": one_us, "planned_wall_s": med["planned"],
          "one_wall_s": med["one"], "walls_s": walls,
          "ratio": med["planned"] / med["one"]})
    need(med["planned"] <= PLANNED_SLACK * med["one"],
         f"UM {t.name}: the planner's T = {plan.t_segments} takes "
         f"{med['planned']:.5f} s, T = 1 {med['one']:.5f} s")

    # faults injected on the sweep grid, at a forced (4, 4) whose ladder
    # has rungs below it: counters still equal the baseline
    undo = forced(4, 4)
    events = []
    try:
        with faults.inject(LANE_FAULTS):
            # two passes: at least 7 guarded calls
            for w in list(base["workloads"]) * 2:
                t = sweep_traces[w][0]
                cfgs = [T.HMSConfig(footprint=t.footprint, **kw)
                        for kw in base["grid"]]
                del sim._RUNS[:]
                rs = T.simulate_many(t, cfgs)
                need(sweep_equal(w, rs), f"{w}: the faulted sweep differs "
                     "from BENCH_sweep.json")
                events += [dict(e, workload=w) for r in sim._RUNS
                           for e in r["events"]]
            pending = [f"{f.kind}@{f.at}" for f in faults.pending()]
    finally:
        undo()
    emit({"phase": "lanes_faults", "faults": LANE_FAULTS,
          "events": events, "unfired": pending, "equals_baseline": True})
    need(not pending and {e["kind"] for e in events} >= {"oom", "stitch",
                                                         "nan"},
         f"injected faults did not all fire: events {events}, unfired "
         f"{pending}")


def obs_phase(torch, T, dev) -> None:
    """The run ledger, span tracer, sentinel and design-space store on the
    main path (``--only obs``), collection on into ``build/obs_smoke/``:
    pathfnd's ``simulate``, fig18's grid on pathfnd as one ``simulate_many``
    batch and a UM batch on llm_dec (4 specs and a duplicate, then the same
    batch memoized) each emit their records; digests bit-equal at (1, 1)
    and a forced (4, 4), and across batch widths (fig18's lanes against
    their ``simulate`` calls and a batch of two); every ``scan`` span's wall
    at least the device time of the ``hms_scan`` launches inside it (CUDA
    events around the library entry, and the profiler's kernel time), and
    the ``um_scan`` span's at least its launch's; a warm repeat passes
    ``assert_no_retrace``; ``host`` names the card and its power limit; the
    ledger and the three committed baselines ingest into a port
    ``SilverStore`` (a re-ingest adds nothing) and its markdown renders.
    Prints pathfnd's wall over OBS_REPS interleaved runs with collection
    off and on, and the median per-span split of a call."""
    import shutil

    from repro_torch import _build, obs
    from repro_torch.core import costmodel
    from repro_torch.obs.store import SilverStore, render_markdown
    from repro_torch.um import engine as um_engine

    out = ROOT / "build" / "obs_smoke"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    path = T.make_trace("pathfnd")
    llm = T.make_trace("llm_dec")
    cfg = T.HMSConfig(footprint=path.footprint)
    fig18 = [T.HMSConfig(footprint=path.footprint, **kw) for kw in FIG18_GRID]
    obs.disable()
    obs.clear_records()
    obs.clear_events()
    T.simulate(path, cfg)                  # warms the host caches
    T.simulate_many(path, fig18)
    card = smi("name,power.limit")

    def wall():
        torch.cuda.synchronize()
        a = time.perf_counter()
        T.simulate(path, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - a

    # pathfnd with collection off and on, interleaved; the span split of
    # each run with collection on
    _build.reset_counts()
    off, on, splits = [], [], []
    for _ in range(OBS_REPS):
        off.append(wall())
        obs.clear_events()
        obs.enable(str(out))
        on.append(wall())
        obs.disable()
        splits.append({k: v["total_ms"] for k, v in obs.totals().items()})
    recs = obs.records()
    need(len(recs) == OBS_REPS and all(
        (r.entry, r.engine, r.batch, r.host.get("device"))
        == ("simulate", "hms", 1, "cuda") for r in recs),
         f"pathfnd: {len(recs)} records for {OBS_REPS} simulate calls with "
         "collection on, or not one hms record on the card each")
    need(len({r.counter_digest for r in recs}) == 1,
         "pathfnd: digests differ between runs")
    need(not any(r.compiled for r in recs),
         "pathfnd: a warm call built or loaded the kernel library")
    host = recs[0].host
    need(host.get("gpu") == torch.cuda.get_device_name(0)
         and host.get("gpu_power_limit") == card.split(",")[1].strip(),
         f"host names {host.get('gpu')!r}, {host.get('gpu_power_limit')!r}; "
         f"nvidia-smi says {card!r}")
    names = ("preprocess", "shard_plan", "scan", "postprocess")
    need(all(set(names) <= set(sp) for sp in splits),
         f"pathfnd: spans {sorted(splits[0])}, expected {names}")
    split = {k: statistics.median(sp[k] for sp in splits)
             for k in splits[0]}
    off_ms = statistics.median(off) * 1e3
    on_ms = statistics.median(on) * 1e3
    emit({"phase": "obs_pathfnd", "nvidia_smi": card, "n": path.n,
          "reps": OBS_REPS, "wall_off_ms": off_ms, "wall_on_ms": on_ms,
          "walls_off_ms": [w * 1e3 for w in off],
          "walls_on_ms": [w * 1e3 for w in on],
          "overhead": on_ms / off_ms - 1.0, "span_ms": split,
          "outside_spans_ms": on_ms - sum(split[k] for k in names),
          "engine_key": recs[0].engine_key, "shards": recs[0].shards,
          "t_segments": recs[0].t_segments,
          "launches": dict(_build.launches)})

    # the scan span against its kernel's device time, in one call
    obs.clear_events()
    obs.enable(str(out))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with entry_events(torch, ("hms_scan_launch", "ema_scan_launch")) \
                as ev:
            T.simulate(path, cfg)
        torch.cuda.synchronize()
    obs.disable()
    scans = [e for e in obs.events() if e[0] == "scan"]
    need(len(scans) == 1, f"{len(scans)} scan spans in one simulate")
    scan_ms = scans[0][2] / 1e6
    kernel = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "hms_chain_kernel" in e.name]
    entry_ms = sum(ev["hms_scan_launch"])
    need(len(ev["hms_scan_launch"]) >= 1, "hms_scan: no launch in a "
         "simulate")
    need(scan_ms >= entry_ms and scan_ms >= sum(kernel),
         f"scan span {scan_ms} ms shorter than its kernel: events "
         f"{entry_ms} ms, profiler {sum(kernel)} ms")
    emit({"phase": "obs_scan_span", "workload": "pathfnd",
          "scan_span_ms": scan_ms, "hms_scan_entry_ms": entry_ms,
          "hms_scan_kernel_ms": sum(kernel) if kernel else None,
          "ema_scan_entry_ms": sum(ev["ema_scan_launch"])})

    # digests: (1, 1) against a forced (4, 4); batch widths
    one = recs[0]
    obs.clear_records()
    obs.enable(str(out))
    old = (costmodel.set_forced_shards(4), costmodel.set_forced_tsplit(4))
    try:
        T.simulate(path, cfg)
    finally:
        costmodel.set_forced_shards(old[0])
        costmodel.set_forced_tsplit(old[1])
    (four,) = obs.records()
    need((four.shards, four.t_segments) == (4, 4),
         f"forced (4, 4) ran at ({four.shards}, {four.t_segments})")
    need(four.counter_digest == one.counter_digest
         and four.counters == one.counters,
         "pathfnd: digest at (4, 4) differs from (1, 1)")
    obs.clear_records()
    T.simulate_many(path, fig18)
    T.simulate_many(path, fig18[:2])
    for c in fig18:
        T.simulate(path, c)
    recs = obs.records()
    need([r.batch for r in recs] == [6, 2, 1, 1, 1, 1, 1, 1],
         f"fig18: record widths {[r.batch for r in recs]}")
    wide, two = recs[0], recs[1]
    lane = [obs.counter_digest(c) for c in wide.counters]
    need(lane == [r.counter_digest for r in recs[2:]]
         and [obs.counter_digest(c) for c in two.counters] == lane[:2],
         "fig18: a lane's digest depends on the batch width")

    # the UM leg: a batch with a duplicate, then the same batch memoized
    specs = [um_engine.um_spec(T.HMSConfig(footprint=llm.footprint,
                                           organization="hbm", r_hbm=r), nv)
             for r in (0.5, 0.25) for nv in (False, True)]
    specs.append(specs[0])
    obs.reset(hms=False, keep_compiled=True)       # drop memoized results
    obs.clear_records()
    obs.clear_events()
    with entry_events(torch, ("um_scan_launch",)) as ev:
        um_engine.simulate_um_many(llm, specs)
    um_engine.simulate_um_many(llm, specs)
    obs.disable()
    ran, memo = obs.records()
    need((ran.um_lanes_requested, ran.um_lanes_run, ran.um_lanes_deduped)
         == (5, 4, 1) and ran.engine_key.startswith("um:")
         and (memo.engine_key, memo.um_lanes_run) == ("um:memoized", 0)
         and memo.counter_digest == ran.counter_digest,
         f"llm_dec UM records: {ran.engine_key} "
         f"{(ran.um_lanes_requested, ran.um_lanes_run)}, {memo.engine_key}")
    um_spans = [e for e in obs.events() if e[0] == "um_scan"]
    um_ms = sum(e[2] for e in um_spans) / 1e6
    um_entry = sum(ev["um_scan_launch"])
    need(len(um_spans) == 1 and um_ms >= um_entry,
         f"um_scan span {um_ms} ms against its launches' {um_entry} ms")
    emit({"phase": "obs_records", "fig18_widths": [r.batch for r in recs],
          "digest_1x1_equals_4x4": True, "lane_digests_equal": True,
          "um_engine_key": ran.engine_key, "um_lanes": [
              ran.um_lanes_requested, ran.um_lanes_run,
              ran.um_lanes_deduped], "um_span_ms": um_ms,
          "um_scan_entry_ms": um_entry, "um_wall_s": ran.wall_s})

    # the sentinel: a warm repeat loads nothing
    obs.enable(str(out))
    with obs.assert_no_retrace() as guard:
        T.simulate(path, cfg)
        T.simulate_many(path, fig18)
    obs.disable()
    stats = obs.cache_stats()
    need(guard.compiles_during() == 0 and stats["kernel_loads"] == 1,
         f"sentinel: {guard.compiles_during()} compiles, {stats}")
    trace_path = obs.export_trace(str(out / "trace.json"))

    # the design-space store: this ledger and the committed baselines
    store = SilverStore(str(out / "store"))
    ledger = out / "ledger.jsonl"
    stats_in = [store.ingest(str(ledger))] + [
        store.ingest(str(ROOT / "benchmarks" / "baselines" /
                         f"BENCH_{name}.json"))
        for name in ("sweep", "um", "scenarios")]
    again = [store.ingest(str(ledger))] + [
        store.ingest(str(ROOT / "benchmarks" / "baselines" /
                         f"BENCH_{name}.json"))
        for name in ("sweep", "um", "scenarios")]
    md = render_markdown(store)
    store.close()
    need(all(st.conflicts == 0 for st in stats_in)
         and [st.added for st in stats_in][1:] == [36, 16, 20]
         and stats_in[0].added > 0
         and all(st.added == st.merged == 0 for st in again)
         and "# Design-space report" in md,
         f"store: {[str(st) for st in stats_in]}; again "
         f"{[str(st) for st in again]}")
    (out / "report.md").write_text(md)
    emit({"phase": "obs_store", "ingested": [str(st) for st in stats_in],
          "reingested": [str(st) for st in again],
          "rows": len(store), "plan_rows": len(store.plan_rows()),
          "ledger_records": len(obs.load_ledger(str(ledger))),
          "trace_events": len(obs.events()), "trace": str(trace_path),
          "cache_stats": stats, "wall_s": time.perf_counter() - t0})
    obs.clear_records()
    obs.clear_events()


# ---- memtier: the block table and tiered training ---------------------------

# 16 GiB of 2 MiB HBM slots over 64 GiB of host blocks (the sizing the
# reference's amil_probe docstring names): 4 blocks a slot, so no two-bit
# tag aliasing
MEMTIER_TIER = {"block_bytes": 2 << 20, "num_slots": 8192,
                "num_blocks": 32768}
MEMTIER_ROUNDS, MEMTIER_N = 64, 32768
TIERED_STEPS, TIERED_FRAC = 4, 0.4


def memtier_traffic(np, cfg, seed=0, rounds=MEMTIER_ROUNDS):
    """The write-filtering oracle's mix (tests/test_train_system.py:123)
    at the card's size: ``rounds`` rounds, each MEMTIER_N random
    writes (run 1) in the first quarter of the blocks, then MEMTIER_N
    sequential reads (run 8) from a random start."""
    rng = np.random.default_rng(seed)
    n = MEMTIER_N
    out = []
    for _ in range(rounds):
        out.append((rng.integers(0, cfg.num_blocks // 4, (n,)).astype(
            np.int32), np.ones(n, bool), np.ones(n, np.float32)))
        start = int(rng.integers(0, cfg.num_blocks * 3 // 4))
        out.append((((np.arange(n) + start) % cfg.num_blocks).astype(
            np.int32), np.zeros(n, bool), np.full(n, 8.0, np.float32)))
    return out


MEMTIER_BIG_ROUNDS = 8


def block_table_big(torch, dev, num_slots: int) -> dict:
    """``memtier.access`` at a table of ``num_slots`` slots (4 blocks a
    slot) on the card against the CPU path: MEMTIER_BIG_ROUNDS rounds of
    ``memtier_traffic``, every state entry and decision bit-equal after
    each, one amil_probe launch a round (reset just before, read just
    after), and one probe kernel node a ``probe_blocks`` call."""
    import numpy as np
    from repro_torch import _build
    from repro_torch.memtier import (TierConfig, access, init_state,
                                     probe_blocks)
    cfg = TierConfig(block_bytes=2 << 20, num_slots=num_slots,
                     num_blocks=4 * num_slots)
    rounds = memtier_traffic(np, cfg, rounds=MEMTIER_BIG_ROUNDS // 2)
    st_c, st_h = init_state(cfg, device=dev), init_state(cfg, device="cpu")
    diffs, card_ms = [], []
    torch.cuda.synchronize()
    _build.reset_counts()
    for r, arrays in enumerate(rounds):
        h = tuple(torch.from_numpy(a) for a in arrays)
        c = tuple(t.to(dev) for t in h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_c, d_c = access(st_c, *c, cfg)
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t0) * 1e3)
        st_h, d_h = access(st_h, *h, cfg)
        for what, a, b in ([("state " + k, st_c[k], st_h[k]) for k in st_h]
                           + [("decision " + k, d_c[k], d_h[k])
                              for k in d_h]):
            a = a.cpu()
            if a.dtype != b.dtype or not torch.equal(a, b):
                diffs.append(f"round {r} {what}")
    launches = _build.launches.get("amil_probe", 0)
    need(not diffs, f"block table at {num_slots} slots: the card differs "
         f"from the CPU path at {len(diffs)} entries, first {diffs[:4]}")
    need(launches == len(rounds), f"block table at {num_slots} slots: "
         f"{launches} amil_probe launches over {len(rounds)} access calls")
    blocks = c[0]
    nodes = graph_nodes(torch, lambda: probe_blocks(st_c, blocks, cfg))
    probe_nodes = [n for n in nodes if n[1] and "amil_probe_kernel" in n[1]]
    need(len(probe_nodes) == 1, f"probe_blocks at {num_slots} slots put "
         f"{nodes} on its stream, not one launch of the probe kernel")
    row = {"phase": "memtier_big_table", "num_slots": num_slots,
           "num_blocks": cfg.num_blocks, "access_calls": len(rounds),
           "requests": len(rounds) * MEMTIER_N,
           "bit_equal_access_calls": len(rounds),
           "amil_probe_launches": launches,
           "card_ms_per_round_median": statistics.median(card_ms),
           "fills": int(st_h["fills"]), "probe_blocks_graph_nodes": nodes}
    emit(row)
    return row


def block_table_phase(torch, dev, flush) -> dict:
    """``memtier.access`` on the card against the port's CPU path: every
    state entry and decision bit-equal after each round of
    ``memtier_traffic``; amil_probe launches counted over the card's rounds
    (reset just before, read just after: one a round); one
    ``probe_blocks`` call's stream holds exactly one probe kernel node
    (``graph_nodes``); the probe at the main path's shape against its
    plain version; then tables past the kernel's shared memory
    (``block_table_big`` at MAX_LANES + 1 and 2^20 slots).  Returns the
    probe's kernel row."""
    import numpy as np
    from repro_torch import _build
    from repro_torch.kernels.amil_probe import ops as probe_ops
    from repro_torch.kernels.amil_probe.ref import amil_probe_reference
    from repro_torch.memtier import (TierConfig, access, init_state,
                                     probe_blocks)
    cfg = TierConfig(**MEMTIER_TIER)
    rounds = memtier_traffic(np, cfg)
    host = [tuple(torch.from_numpy(a) for a in r) for r in rounds]
    card = [tuple(t.to(dev) for t in r) for r in host]
    st_c, st_h = init_state(cfg, device=dev), init_state(cfg, device="cpu")
    card_ms, host_ms, diffs = [], [], []
    hits = fills = bypasses = 0
    torch.cuda.synchronize()
    _build.reset_counts()
    for r, (c, h) in enumerate(zip(card, host)):
        t0 = time.perf_counter()
        st_c, d_c = access(st_c, *c, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st_h, d_h = access(st_h, *h, cfg)
        t2 = time.perf_counter()
        card_ms.append((t1 - t0) * 1e3)
        host_ms.append((t2 - t1) * 1e3)
        for what, a, b in ([("state " + k, st_c[k], st_h[k]) for k in st_h]
                           + [("decision " + k, d_c[k], d_h[k])
                              for k in d_h]):
            a = a.cpu()
            if a.dtype != b.dtype or not torch.equal(a, b):
                diffs.append(f"round {r} {what}")
        hits += int(d_h["hit"].sum())
        fills += int(d_h["fill"].sum())
        bypasses += int(d_h["bypass"].sum())
    launches = _build.launches.get("amil_probe", 0)
    n_req = len(rounds) * MEMTIER_N
    need(not diffs, f"block table: the card differs from the CPU path at "
         f"{len(diffs)} entries, first {diffs[:4]}")
    need(launches == len(rounds), f"block table: {launches} amil_probe "
         f"launches over {len(rounds)} access calls")
    need(int(st_h["fills"]) == fills > 0 and bypasses > 0,
         f"block table: fills {fills}, bypasses {bypasses}")
    blocks = card[-1][0]
    nodes = graph_nodes(torch, lambda: probe_blocks(st_c, blocks, cfg))
    probe_nodes = [n for n in nodes if n[1] and "amil_probe_kernel" in n[1]]
    need(len(probe_nodes) == 1, f"probe_blocks put {nodes} on its stream, "
         "not one launch of the probe kernel")
    emit({"phase": "memtier_block_table", "tier": MEMTIER_TIER,
          "rounds": MEMTIER_ROUNDS, "access_calls": len(rounds),
          "requests": n_req,
          "amil_probe_launches": launches,
          "card_ms_per_round_median": statistics.median(card_ms),
          "card_ms_per_round_first": card_ms[0],
          "cpu_ms_per_round_median": statistics.median(host_ms),
          "hit_rate": hits / n_req, "fill_rate": fills / n_req,
          "bypass_rate": bypasses / n_req,
          "writebacks": int(st_h["writebacks"]),
          "bit_equal_access_calls": len(rounds),
          "probe_blocks_graph_nodes": nodes})

    # the probe at the main path's shape: the last round's table and blocks
    meta = st_c["meta"]
    slots, tags = blocks % cfg.num_slots, blocks // cfg.num_slots
    run = lambda: probe_ops.amil_probe(meta, slots, tags)
    err = max(same(torch, a, b) for a, b in zip(
        run(), amil_probe_reference(meta, slots, tags)))
    event_ms(torch, run, reps=5, flush=flush)              # warm-up
    ms = event_ms(torch, run, reps=20, flush=flush)
    plain_ms = event_ms(torch, lambda: amil_probe_reference(
        meta, slots, tags), reps=5, flush=flush)
    row = {"name": "amil_probe", "case": "memtier_round",
           "table_lanes": cfg.num_slots, "requests": MEMTIER_N,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": (20 * MEMTIER_N + 4 * cfg.num_slots)
           / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": None, "launches": launches}
    emit({"phase": "kernel_vs_plain", **row})

    # tables past the kernel's shared memory: the probe reads them from
    # device memory, and access stays bit-equal to the CPU path
    big_rows = [block_table_big(torch, dev, n)
                for n in (probe_ops.MAX_LANES + 1, 1 << 20)]
    row["big_tables"] = big_rows
    return row


def mem_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise SmokeFailure("no MemAvailable in /proc/meminfo")


def tiered_phase(torch, dev) -> dict:
    """Tiered training of TRAIN_ARCH at full width and depth (bf16, seed-0
    weights, ``for_model(cfg, TRAIN_SEQ, TRAIN_BATCH)``, AdamW's default
    lr 3e-4)
    through ``launch.train_tiered.run`` at a fast-tier budget of
    TIERED_FRAC of the state, against TIERED_STEPS untiered steps of the
    same step function on the same batches in this process: losses and
    grad norms bit-equal, the final weights of a streamed leaf bit-equal,
    bytes streamed each way TIERED_STEPS x ``slow_bytes``, device memory
    after each flush-out at least 0.9 x ``slow_bytes`` below the untiered
    run's after its step, a streamed leaf's round trip bit-equal, the peak
    under the card's memory, launches against ``train_launches``.  Returns
    the tiered run's launches."""
    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.convert import jax_leaf_order
    from repro_torch.data.synthetic import for_model
    from repro_torch.launch import steps, train_tiered
    from repro_torch.memtier import plan_placement
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    cfg = get_config(TRAIN_ARCH)
    total_mem = torch.cuda.get_device_properties(dev).total_memory

    # untiered: the whole state on the card
    t0 = time.perf_counter()
    model = init_params(0, cfg, device=dev)
    opt = adamw.init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = train_tiered.state_bytes(model, opt)
    plan = plan_placement(model, opt, int(nbytes * TIERED_FRAC))
    leaf = next(n for n in plan.streamed if n.startswith("params"))
    step = steps.make_train_step(cfg)          # lr 3e-4, as run's
    data = for_model(cfg, TRAIN_SEQ, TRAIN_BATCH)
    base = {"losses": [], "grad_norms": [], "step_ms": [], "mem": []}
    _build.reset_counts()
    for i in range(TIERED_STEPS):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(i).items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model, opt, m = step(model, opt, b)
        torch.cuda.synchronize()
        base["step_ms"].append((time.perf_counter() - t1) * 1e3)
        base["mem"].append(torch.cuda.memory_allocated(dev))
        base["losses"].append(float(m["loss"]))
        base["grad_norms"].append(float(m["grad_norm"]))
    check_launches(_build.launches, train_launches(cfg, TIERED_STEPS),
                   "untiered steps")
    params = dict(model.named_parameters())
    groups = {"params" + "".join(f"['{k}']" for k in path): ns
              for path, ns in jax_leaf_order(params, cfg)}
    names = groups[leaf]
    final = {n: params[n].detach().cpu() for n in names}
    del model, opt, params, m, b
    torch.cuda.empty_cache()

    # tiered
    avail = mem_available()
    emit({"phase": "memtier_host", "mem_available_bytes": avail,
          "slow_bytes": plan.slow_bytes, "fast_bytes": plan.fast_bytes,
          "state_bytes": nbytes, "streamed_leaves": len(plan.streamed),
          "pinned_leaves": len(plan.pinned)})
    need(plan.slow_bytes < avail, f"the host cannot pin the slow tier: "
         f"{plan.slow_bytes} bytes asked, MemAvailable {avail}")
    model = init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    lines = []
    t1 = time.perf_counter()
    try:
        out = train_tiered.run(cfg, model, steps=TIERED_STEPS,
                               seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                               fast_frac=TIERED_FRAC, log=lines.append)
    except RuntimeError as e:
        raise SmokeFailure(f"tiered training failed: {e} (MemAvailable "
                           f"{avail} bytes)") from e
    run_s = time.perf_counter() - t1
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    ws, model, opt = out["streamer"], out["model"], out["opt_state"]
    pl = ws.placement
    check_launches(launches, train_launches(cfg, TIERED_STEPS),
                   "tiered steps")
    in_out = (ws.bytes_streamed_in, ws.bytes_streamed_out)
    # the round trip of a streamed leaf: staged copies equal the host
    # copies, flushed host copies equal the staged ones
    views = ws.host_views(leaf)
    params = dict(model.named_parameters())
    model, opt = ws.stage_in(model, opt)
    staged = [params[n].detach().clone() for n in names]
    trip_in = all(torch.equal(s.cpu(), v) for s, v in zip(staged, views))
    ws.flush_out(model, opt)
    trip_out = all(torch.equal(s.cpu(), v) for s, v in zip(staged, views))
    same_final = all(torch.equal(final[n], v) for n, v in zip(names, views))
    pinned_host = bool(ws.host_buffer.is_pinned())
    mem_after = out["mem_after_flush"]
    saved = [b - t for b, t in zip(base["mem"], mem_after)]
    gbs_in = [pl.slow_bytes / s / 1e9 for s in out["stage_in_s"]]
    gbs_out = [pl.slow_bytes / s / 1e9 for s in out["flush_out_s"]]
    row = {"phase": "memtier_tiered_train", "model": cfg.name,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in model.parameters()),
           "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "lr": TRAIN_LR,
           "steps": TIERED_STEPS, "fast_frac": TIERED_FRAC,
           "state_bytes": nbytes, "fast_bytes": pl.fast_bytes,
           "slow_bytes": pl.slow_bytes, "streamed_leaf_checked": leaf,
           "host_buffer_pinned": pinned_host, "init_s": init_s,
           "tiered_run_s": run_s, "lines": lines,
           "losses": out["losses"], "grad_norms": out["grad_norms"],
           "untiered_losses": base["losses"],
           "untiered_grad_norms": base["grad_norms"],
           "stage_in_ms": [s * 1e3 for s in out["stage_in_s"]],
           "flush_out_ms": [s * 1e3 for s in out["flush_out_s"]],
           "stage_in_gb_s": gbs_in, "flush_out_gb_s": gbs_out,
           "step_ms": [s * 1e3 for s in out["step_s"]],
           "untiered_step_ms": base["step_ms"],
           "mem_after_flush_bytes": mem_after,
           "untiered_mem_after_step_bytes": base["mem"],
           "mem_saved_bytes": saved, "peak_mem_bytes": peak,
           "card_mem_bytes": total_mem,
           "bytes_streamed_in": in_out[0], "bytes_streamed_out": in_out[1],
           "round_trip_in": trip_in, "round_trip_out": trip_out,
           "final_leaf_equals_untiered": same_final, "launches": launches}
    emit(row)
    need(out["losses"] == base["losses"]
         and out["grad_norms"] == base["grad_norms"],
         f"tiered losses {out['losses']} / grad norms {out['grad_norms']} "
         f"differ from untiered {base['losses']} / {base['grad_norms']}")
    need(in_out == (TIERED_STEPS * pl.slow_bytes,) * 2,
         f"streamed bytes {in_out}, expected {TIERED_STEPS} x "
         f"{pl.slow_bytes} each way")
    need(all(s >= 0.9 * pl.slow_bytes for s in saved),
         f"device memory after flush_out {mem_after} is not 0.9 x "
         f"{pl.slow_bytes} below the untiered run's {base['mem']}")
    need(trip_in and trip_out and same_final,
         f"streamed leaf {leaf}: round trip in {trip_in}, out {trip_out}, "
         f"final weights equal the untiered run's {same_final}")
    need(pinned_host, "the slow tier's host buffer is not page-locked")
    need(peak < total_mem, f"peak {peak} over the card's {total_mem}")
    del ws, model, opt, out, params, staged
    torch.cuda.empty_cache()
    return launches


def memtier_phase(torch, dev, flush) -> dict:
    """The two-tier memory runtime on the card (``--only memtier``): the
    block table, then tiered training.  Returns the amil_probe row (its
    launches those of the block table's rounds)."""
    row = block_table_phase(torch, dev, flush)
    torch.cuda.empty_cache()
    tiered_phase(torch, dev)
    return row


def main(argv=None) -> int:
    global _OUT
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--write-traces", action="store_true")
    ap.add_argument("--only", choices=["um", "um_step_costs", "amil_probe",
                                       "ssd", "flash", "paged_split",
                                       "lanes", "hms_scan",
                                       "obs", "families", "bf16_spread",
                                       "train", "bwd", "train_ssm",
                                       "ssd_bwd", "memtier", "mesh",
                                       "mesh4"],
                    default=None,
                    help="run the device and build phases, then only the "
                    "UM phases (4b, 5b and um_step_costs), um_step_costs, "
                    "the amil_probe rows (with the out-of-range check), "
                    "the ssd_scan rows, the flash_attention rows, the "
                    "paged_attention split-mode rows, the "
                    "scenario baseline and the lanes phase (4c, 5c), "
                    "hms_scan's timing on pathfnd at (1, 1), the obs "
                    "phase (5d), the families phase (7b), the bf16 "
                    "cuts' spread over weight seeds, the train phase "
                    "(6b), its backward rows alone, the ssm and hybrid "
                    "training (6c, with zamba2-2.7b at full width and "
                    "depth), its ssd_scan backward rows alone or the "
                    "two-tier memory runtime (the block table and tiered "
                    "training), the full-width trainer and the mesh "
                    "phase (6d), or qwen2.5-3b on meshes of four cards "
                    "(a four-chip call)")
    ap.add_argument("--parent-bwd", default=None, metavar="DIR",
                    help="a directory holding an earlier tree's "
                    "flash_attention_bwd.cu (and its header): built and "
                    "timed beside every backward row")
    ap.add_argument("--parent-ssd-bwd", default=None, metavar="DIR",
                    help="an earlier checkout of the repo: its port's "
                    "ssd_backward (its own wrapper and library, built "
                    "under DIR/build) timed beside every ssd_scan backward "
                    "row, and with --only train_ssm or the whole run the "
                    "ssm training steps' walls with either backward in "
                    "turn")
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
             .splitlines() if "registers" in ln or "Compiling entry" in ln
             or "stack frame" in ln]
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "nvcc_s": _build.build_info.get("seconds"),
          "sources": _build.build_info.get("sources"), "ptxas": ptxas})

    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
    if args.only:
        if args.only == "um":
            um_quirk_checks(torch, dev)
            um_baseline_checks(torch, T, dev, flush, cycle_ms)
            traces = {(w, None): T.make_trace(w) for w in sorted(T.WORKLOADS)}
            um_main_path(torch, T, dev, traces, cycle_ms)
            um_step_costs(torch, T, dev, cycle_ms, traces)
        elif args.only == "amil_probe":
            amil_checks(torch, dev, flush, judge=False)
            amil_out_of_range(torch, dev)
        elif args.only == "ssd":
            ssd_checks(torch, dev, flush)
        elif args.only == "flash":
            flash_checks(torch, dev, flush)
        elif args.only == "paged_split":
            paged_split_checks(torch, dev, flush)
        elif args.only == "hms_scan":
            hms_scan_timing(torch, T, dev, flush)
        elif args.only == "obs":
            obs_phase(torch, T, dev)
        elif args.only == "families":
            families_phase(torch, dev, flush)
        elif args.only == "bf16_spread":
            bf16_spread(torch, dev)
        elif args.only == "train":
            train_phase(torch, dev, flush, args.parent_bwd)
        elif args.only == "bwd":
            bwd_checks(torch, dev, flush, args.parent_bwd)
        elif args.only == "train_ssm":
            train_ssm_phase(torch, dev, flush, full_hybrid=True,
                            parent_dir=args.parent_ssd_bwd)
        elif args.only == "ssd_bwd":
            ssd_bwd_checks(torch, dev, flush, args.parent_ssd_bwd)
        elif args.only == "memtier":
            memtier_phase(torch, dev, flush)
        elif args.only == "mesh":
            train_full_width(torch, dev)
            mesh_phase(torch, dev)
        elif args.only == "mesh4":
            mesh4_phase(torch)
        elif args.only == "lanes":
            scenario_baseline_checks(torch, T)
            runs = [(name, None) for name in sorted(T.WORKLOADS)] + [
                ("zipf", 10**6)]
            lanes_phase(torch, T, dev, {(name, n): T.make_trace(name, n=n)
                                        for name, n in runs}, cycle_ms)
        else:
            um_step_costs(torch, T, dev, cycle_ms)
        emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
        return 0
    summary = {}
    HOST.start(host_jobs())

    # ---- 6-8. attention kernels and the serving path, run first: the
    # profiler's device kernel counts (decode_profile) come up one record
    # short in a window late in a long process (seen from ~610 s on)
    summary["flash_attention"] = flash_checks(torch, dev, flush)
    summary["flash_attention_bwd"], train_bwd_launches = train_phase(
        torch, dev, flush, args.parent_bwd)
    summary["ssd_scan_bwd"], ssd_bwd_launches = train_ssm_phase(
        torch, dev, flush, parent_dir=args.parent_ssd_bwd)
    paged_checks(torch, dev, flush)
    paged_split_checks(torch, dev, flush)
    summary["ssd_scan"] = ssd_checks(torch, dev, flush)
    smoke_serve(torch)
    summary["paged_attention"], serve_launches = serving_phases(
        torch, dev, flush)
    for k, n in ssm_serving_phases(torch, dev).items():
        serve_launches[k] = serve_launches.get(k, 0) + n
    family_launches, _ = families_phase(torch, dev, flush)
    for k, n in family_launches.items():
        serve_launches[k] = serve_launches.get(k, 0) + n
    for k, n in MESH_SERVE_LAUNCHES.items():
        serve_launches[k] = serve_launches.get(k, 0) + n
    torch.cuda.empty_cache()

    # ---- 3. kernels against their plain versions --------------------------
    amil_checks(torch, dev, flush, judge=True)
    amil_out_of_range(torch, dev)

    for kw in GOLDEN_CONFIGS + WIDE_CTC:
        t = golden_trace(T, n=GOLDEN_PLAIN_N)
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

    # one workload at a sixteenth of its default size (PLAIN_SCAN_N): the
    # plain step loop at the full 160,000 requests took ~205 s, the run's
    # longest phase; the kernel's full-size times are the breakdown rows'
    t = T.make_trace("pathfnd", n=PLAIN_SCAN_N)
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
    # a caller sees it; kernel_ms: the kernel alone; launch_ms: the events
    # around its library entry, device_ms's fallback, run here every time
    ms = event_ms(torch, run_k, reps=3, flush=flush)
    kernel_ms = device_ms(torch, run_k, "hms_chain_kernel",
                          "hms_scan_launch")
    entry_ms = launch_ms(torch, run_k, "hms_scan_launch")
    bounds = scan_bounds(scan_ops, s, cycle_ms)
    summary["hms_scan"] = {
        "name": "hms_scan", "trace": t.name, "n": t.n, "depth": depth,
        **bounds,
        "max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
        "launch_ms": entry_ms, "plain_ms": plain_ms,
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

    # ---- 4b. the UM paging kernel: its quirks, the committed UM baseline --
    um_quirk_checks(torch, dev)
    summary["um_scan"] = um_baseline_checks(torch, T, dev, flush, cycle_ms)

    # ---- 4c. the committed scenarios baseline -----------------------------
    scenario_baseline_checks(torch, T)

    # ---- 5. the main path at full size ------------------------------------
    runs = [(name, None) for name in sorted(T.WORKLOADS)] + [("zipf", 10**6)]
    traces = {(name, n): T.make_trace(name, n=n) for name, n in runs}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    del sim._RUNS[:]
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
    # one hms_scan launch a stitch round (the planner's (S, T)), one
    # ema_scan launch a simulate
    rounds = sum(r["rounds"] for r in sim._RUNS)
    shapes = sorted({(r["shards"], r["t_segments"]) for r in sim._RUNS})
    need(main_launches.get("hms_scan", 0) == rounds > 0, "hms_scan: "
         f"{main_launches.get('hms_scan', 0)} launches on the main path for "
         f"{rounds} stitch rounds")
    need(main_launches.get("ema_scan", 0) == 4 * len(rows), "ema_scan: "
         f"{main_launches.get('ema_scan', 0)} launches on the main path, not "
         f"one per simulate ({4 * len(rows)})")
    emit({"phase": "main_done", "runs": len(rows), "launches": main_launches,
          "stitch_rounds": rounds, "planned_shapes": shapes,
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
        scan_ms = device_ms(torch, run_s, "hms_chain_kernel",
                            "hms_scan_launch")
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
            s["slot"], s["meta"], **s["scan"]), "hms_chain_kernel",
            "hms_scan_launch", reps=2)
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

    # ---- 5b. the UM leg of the main path at default size ----------------
    um_launches = um_main_path(torch, T, dev, traces, cycle_ms)
    um_step_costs(torch, T, dev, cycle_ms, traces)

    # ---- 5c. the sweep engine's lanes ------------------------------------
    lanes_phase(torch, T, dev, traces, cycle_ms)

    # ---- 5d. the run ledger, spans, sentinel and store on the main path --
    obs_phase(torch, T, dev)

    # ---- 5e. the AMIL probe's path: the memtier block table, then tiered
    # training
    summary["amil_probe"] = memtier_phase(torch, dev, flush)
    probe_launches = summary["amil_probe"]["launches"]

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
            ("flash_attention_bwd", "src/repro_torch/kernels/"
             "flash_attention/csrc/flash_attention_bwd.cu",
             "src/repro/models/layers.py:117", train_bwd_launches),
            ("paged_attention", "src/repro_torch/kernels/paged_attention/"
             "csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/paged_attention.py:82",
             serve_launches["paged_attention"]),
            ("ssd_scan", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan/ssd_scan.py:71",
             serve_launches["ssd_scan"]),
            ("ssd_scan_bwd", "src/repro_torch/kernels/ssd_scan/csrc/"
             "ssd_scan_bwd.cu", "src/repro/kernels/ssd_scan/ref.py:39",
             ssd_bwd_launches),
            ("um_scan", "src/repro_torch/kernels/um_scan/csrc/um_scan.cu",
             "src/repro/um/engine.py:226", um_launches["um_scan"])):
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
        HOST.stop()
        if _OUT is not None:
            _OUT.close()
    sys.exit(code)
