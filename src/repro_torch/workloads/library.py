"""Scenario library: phase-heterogeneous workloads built from the phase IR.

Each scenario models one end-to-end application the paper's single-pattern
generators cannot express, with the phase structure that actually stresses
the bypass / CTC machinery:

  llm_serve       prefill (weight streaming + KV append) followed by decode
                  (weight streaming interleaved with a *growing* KV reuse
                  curve) — the ROADMAP "llm_decode with real KV reuse" item.
  train_step      fwd (weight stream + activation writes), bwd (weight
                  re-stream + activation re-reads + gradient writes), then
                  optimizer read-modify-writes — write-heavy tail per step.
  graph_pipeline  three BFS supersteps (power-law frontier bursts) feeding a
                  PageRank-style phase (skewed gathers + rank RMWs) over the
                  same graph region — multi-kernel graph pipeline.
  multi_tenant    three tenants on disjoint regions running concurrently:
                  a streaming stencil, a zipf key-value service, and a graph
                  job — the shared-GPU mix the oversubscription knob probes.
  moe_expert      MoE serving: a dense router phase followed by zipf-hot
                  expert weight-shard gathers (a few hot experts absorb most
                  tokens) interleaved with a growing KV stream — the
                  ROADMAP expert-routing item, and the natural stress case
                  for the oversubscribed-UM path (cold experts page out,
                  hot experts must stay resident).

All are registered in :data:`SCENARIOS` and (via ``repro_torch.workloads``) in
the core ``WORKLOADS`` registry, so ``make_trace("llm_serve", n=...)`` and every
benchmark entry point work on them unchanged.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.core.traces import MiB

from .ir import Phase, Scenario

LLM_SERVE = Scenario(
    name="llm_serve",
    description="LLM serving: prefill then decode with growing KV reuse",
    footprint=32 * MiB,
    regions={"weights": 0.55, "kv": 0.30, "act": 0.15},
    phases=(
        # prefill: one pass over the weights while the prompt's KV is
        # appended — compute-dense, write traffic is sequential
        Phase("prefill_w", "weights", "stream", weight=2.0,
              interleave="prefill"),
        Phase("prefill_kv", "kv", "append", weight=1.0,
              interleave="prefill"),
        # decode: weights re-streamed per token; KV reads span a reuse set
        # that grows token by token (the real KV reuse curve), with a thin
        # append stream of new entries
        Phase("decode_w", "weights", "stream", weight=4.0,
              interleave="decode"),
        Phase("decode_kv", "kv", "growing", weight=2.0, write_frac=0.12,
              params={"lo_frac": 0.08}, interleave="decode"),
    ),
)

TRAIN_STEP = Scenario(
    name="train_step",
    description="Training step: fwd -> bwd (activation re-reads) -> optimizer",
    footprint=40 * MiB,
    regions={"params": 0.40, "acts": 0.25, "grads": 0.20, "opt": 0.15},
    phases=(
        Phase("fwd_w", "params", "stream", weight=2.0, interleave="fwd"),
        Phase("fwd_act", "acts", "append", weight=1.0, interleave="fwd"),
        # bwd re-streams the weights and re-reads the activations written in
        # fwd (same region, read-only second pass), producing gradients
        Phase("bwd_w", "params", "stream", weight=2.0, interleave="bwd"),
        Phase("bwd_act", "acts", "stream", weight=1.0, interleave="bwd"),
        Phase("bwd_grad", "grads", "append", weight=1.0, interleave="bwd"),
        # optimizer: random read-modify-writes over the state, the paper's
        # worst case for SCM write recovery
        Phase("optimizer", "opt", "rmw", weight=1.5),
    ),
)

GRAPH_PIPELINE = Scenario(
    name="graph_pipeline",
    description="BFS supersteps feeding a PageRank-style kernel",
    footprint=32 * MiB,
    regions={"graph": 0.60, "frontier": 0.12, "ranks": 0.28},
    phases=(
        Phase("bfs_s0", "graph", "burst", weight=1.0, write_frac=0.08,
              params={"burst": 4}),
        Phase("bfs_s1", "graph", "burst", weight=1.0, write_frac=0.08,
              params={"burst": 4}),
        Phase("bfs_s2", "graph", "burst", weight=1.0, write_frac=0.08,
              params={"burst": 2}),
        # PageRank over the frontier-discovered graph: skewed neighbour
        # gathers interleaved with rank read-modify-writes
        Phase("pr_gather", "graph", "zipf", weight=1.5,
              params={"hot_frac": 0.10, "hot_prob": 0.7},
              interleave="pr"),
        Phase("pr_rank", "ranks", "rmw", weight=1.0, interleave="pr"),
    ),
)

MULTI_TENANT = Scenario(
    name="multi_tenant",
    description="Three tenants sharing the GPU on disjoint regions",
    footprint=48 * MiB,
    regions={"tenant_stream": 0.40, "tenant_kv": 0.22, "tenant_graph": 0.38},
    phases=(
        Phase("stencil", "tenant_stream", "stream", weight=2.0,
              write_frac=0.06, interleave="mix"),
        Phase("kv_serve", "tenant_kv", "zipf", weight=1.5, write_frac=0.3,
              params={"hot_frac": 1 / 16, "hot_prob": 0.8},
              interleave="mix"),
        Phase("graph_job", "tenant_graph", "burst", weight=1.5,
              write_frac=0.1, params={"burst": 4}, interleave="mix"),
    ),
)

MOE_EXPERT = Scenario(
    name="moe_expert",
    description="MoE serving: dense router + zipf-hot expert weight shards",
    footprint=48 * MiB,
    regions={"router": 0.08, "experts": 0.72, "kv": 0.20},
    phases=(
        # every token hits the (small, dense) router weights first — a
        # tight re-streamed region that caches perfectly
        Phase("router_gemm", "router", "stream", weight=1.0),
        # expert weight shards: token routing concentrates on a few hot
        # experts (1/8 of the shards absorb ~85% of gathers), the rest of
        # the expert pool is touched cold — exactly the residency split
        # the UM paging model's hotness-driven migration keys on
        Phase("expert_up", "experts", "zipf", weight=3.0,
              params={"hot_frac": 0.125, "hot_prob": 0.85},
              interleave="experts"),
        Phase("expert_down", "experts", "zipf", weight=2.0,
              params={"hot_frac": 0.125, "hot_prob": 0.85},
              interleave="experts"),
        # per-token KV growth rides along with the expert gathers
        Phase("kv_append", "kv", "growing", weight=1.0, write_frac=0.15,
              params={"lo_frac": 0.10}, interleave="experts"),
    ),
)

SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in (LLM_SERVE, TRAIN_STEP, GRAPH_PIPELINE, MULTI_TENANT,
                        MOE_EXPERT)
}
