"""Two-tier paged KV cache for serving (a numpy copy of the JAX package's
``memtier/paged_kv.py``: the same page table, slot owners, spills to the
slow tier, step plans and stats).

Pages live in a fixed HBM pool (fast tier); overflow pages spill to a host
pool (slow tier).  Residency + pinning decisions run through the AMIL block
table: the decode append page of every sequence is write-hot (the paper's
write-filtering — slow-tier writes are the expensive thing to avoid) and is
always pinned; older pages compete by DRAM-affinity score (hotness from
access counters x spatial locality of sequential decode scans).

The attention read path over the fast pool is the ``paged_attention``
kernel; slow-tier pages are staged into reserved streaming slots
before the step (`plan_step` returns the copy list — the engine performs
the copies so the manager stays pure-functional).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PagedKVConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 64          # tokens per page
    fast_pages: int = 64         # HBM pool capacity (pages per layer)
    max_pages_per_seq: int = 32
    stream_slots: int = 8        # reserved staging slots for bypassed pages
    dtype: str = "bfloat16"


class PagedKVManager:
    """Host-side page bookkeeping.  Device pools are plain arrays owned by
    the serving engine; the manager deals in page indices only."""

    def __init__(self, cfg: PagedKVConfig, max_seqs: int):
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.page_table = np.full(
            (max_seqs, cfg.max_pages_per_seq), -1, np.int32)
        self.lengths = np.zeros((max_seqs,), np.int32)
        # fast pool slot -> (seq, logical_page) | -1
        self.slot_owner = np.full((cfg.fast_pages, 2), -1, np.int32)
        self.slow_pages: Dict[Tuple[int, int], int] = {}   # -> slow index
        self.slow_free: List[int] = []
        self.next_slow = 0
        self.hotness = np.zeros((max_seqs, cfg.max_pages_per_seq),
                                np.int32)
        self.stats = {"fast_hits": 0, "slow_fetches": 0, "spills": 0,
                      "appends": 0}

    # -- allocation ---------------------------------------------------------
    def _alloc_fast(self) -> Optional[int]:
        free = np.where(self.slot_owner[:, 0] < 0)[0]
        if len(free) == 0:
            return None
        return int(free[0])

    def _alloc_slow(self) -> int:
        if self.slow_free:
            return self.slow_free.pop()
        idx = self.next_slow
        self.next_slow += 1
        return idx

    def _spill_coldest(self) -> int:
        """Evict the least-hot non-append fast page to the slow tier."""
        owners = self.slot_owner
        scores = []
        for slot in range(self.cfg.fast_pages):
            s, p = owners[slot]
            if s < 0:
                scores.append(np.inf)
                continue
            is_append = (p == (self.lengths[s] - 1) // self.cfg.page_size)
            # append pages are write-hot: never spill (write filtering)
            scores.append(np.inf if is_append else self.hotness[s, p])
        victim = int(np.argmin(scores))
        s, p = owners[victim]
        assert s >= 0, "no spillable page"
        slow_idx = self._alloc_slow()
        self.slow_pages[(int(s), int(p))] = slow_idx
        self.page_table[s, p] = -(slow_idx + 2)      # negative = slow tier
        self.slot_owner[victim] = (-1, -1)
        self.stats["spills"] += 1
        return victim

    def append_token(self, seq: int) -> Dict[str, int]:
        """Advance seq by one token; returns copy ops for the engine:
        {"new_fast_slot": s} when a fresh page was opened, plus
        {"spill_from": slot, "spill_to": slow_idx} when one was evicted."""
        ops: Dict[str, int] = {}
        cfg = self.cfg
        pos = int(self.lengths[seq])
        page = pos // cfg.page_size
        assert page < cfg.max_pages_per_seq, "sequence too long"
        if pos % cfg.page_size == 0:           # open a new page
            slot = self._alloc_fast()
            if slot is None:
                pre_spill = len(self.slow_pages)
                victim_slot = self._spill_coldest()
                ops["spill_from"] = victim_slot
                ops["spill_to"] = self.slow_pages[
                    list(self.slow_pages)[-1]] if len(
                        self.slow_pages) > pre_spill else -1
                slot = victim_slot
            self.slot_owner[slot] = (seq, page)
            self.page_table[seq, page] = slot
            ops["new_fast_slot"] = slot
        self.lengths[seq] = pos + 1
        self.hotness[seq, page] += 1
        self.stats["appends"] += 1
        return ops

    def plan_step(self, active: List[int]) -> Tuple[np.ndarray, np.ndarray,
                                                     List[Tuple]]:
        """Decode-step plan for ``active`` sequences.

        Returns (block_table int32[B, max_pages], lengths int32[B],
        fetches) where fetches lists (slow_idx, stream_slot, seq, page)
        copies the engine must stage before calling the kernel.  Slow-tier
        pages are mapped into the reserved streaming slots (bypass: they do
        NOT enter the resident pool — the paper's low-utility data path).
        """
        cfg = self.cfg
        B = len(active)
        bt = np.zeros((B, cfg.max_pages_per_seq), np.int32)
        ln = np.zeros((B,), np.int32)
        fetches = []
        stream_next = 0
        for i, seq in enumerate(active):
            ln[i] = self.lengths[seq]
            n_pages = (int(self.lengths[seq]) + cfg.page_size - 1) \
                // cfg.page_size
            for p in range(n_pages):
                entry = self.page_table[seq, p]
                self.hotness[seq, p] += 1
                if entry >= 0:
                    bt[i, p] = entry
                    self.stats["fast_hits"] += 1
                else:
                    slow_idx = -int(entry) - 2
                    slot = cfg.fast_pages + (stream_next % cfg.stream_slots)
                    stream_next += 1
                    fetches.append((slow_idx, slot, seq, p))
                    bt[i, p] = slot
                    self.stats["slow_fetches"] += 1
        return bt, ln, fetches
