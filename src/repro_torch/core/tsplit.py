"""Temporal trace splitting: speculative segment execution + exact stitch.

A copy of the reference package's ``repro.core.tsplit`` (pure NumPy).
The engines' scan depth is the critical path — LPT sharding tops
out on zipf traces (the hottest CTC set bounds the padded depth) and the
UM paging scan cannot shard at all.  This module splits each scan stream
into T *temporal segments* that run in parallel as extra kernel lanes, each
seeded from a guessed boundary carry (cold state, optionally preceded by
a short replay prefix of real trace steps whose outputs are discarded).
Guesses are wrong in general, so the result is speculative; exactness
comes from the *stitch*: re-run all segments with each boundary guess
replaced by the state the previous segment actually produced, until the
guesses reach a fixed point.

Why the fixed point is bit-exact: segment 0's seed is the true initial
state, so after round 1 its output carry is true; composition hands that
carry to segment 1's next round, and by induction at least one more
boundary becomes exact per round.  When a round changes nothing
(``g_new == g`` bit-for-bit), every boundary equals what sequential
execution would produce, hence every emitted flag — and therefore every
counter — is identical to the unsplit scan.  Worst case is T rounds plus
the fixed-point confirmation; in practice cache/residency state converges
in 1-2 rounds because segments forget their seed quickly.

The mechanism is engine-agnostic: :func:`stitch` takes opaque guesses
plus ``run``/``advance``/``equal`` callables, and both the HMS engine
(``core/simulator.py``) and the UM engine (``um/engine.py``) drive it, on
device tensors (one kernel launch and one host sync a round).  :func:`split_positions` builds the per-segment gather/scatter index
plan shared by both.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class StitchError(RuntimeError):
    """The fixed-point stitch exceeded its round bound.

    Mathematically impossible for a deterministic engine whose ``advance``
    chains true carries (see module docstring) — so this firing means the
    engine's composition rule is wrong, and the caller's degradation
    ladder falls back to an exact T=1 run rather than ship speculative
    counters."""


# --- replay prefix ---------------------------------------------------------
#
# A replay prefix warms each guessed boundary by re-executing the last P
# real trace steps before the segment with live state-updates but dropped
# outputs.  It only exists to cut expected stitch rounds on long segments;
# correctness never depends on it (rounds >= 2 clear the replay steps' live
# bit, so chaining reasons about core steps only).  Default 0 = cold.

_REPLAY_PREFIX = 0


def replay_prefix() -> int:
    return _REPLAY_PREFIX


def set_replay_prefix(p: int) -> int:
    """Set the replay-prefix length used when T>1 engines are planned;
    returns the previous value."""
    global _REPLAY_PREFIX
    old, _REPLAY_PREFIX = _REPLAY_PREFIX, max(0, int(p))
    return old


def seg_length(depth: int, t: int, replay: int) -> int:
    """Padded per-segment scan length: ceil(depth/t) core steps plus the
    replay prefix (replay only exists when actually splitting)."""
    core = -(-depth // t)
    return core + (replay if t > 1 else 0)


def split_positions(pos: np.ndarray, n: int, t: int,
                    replay: int) -> Dict[str, np.ndarray]:
    """Cut per-shard scan positions into ``t`` temporal segments.

    ``pos`` is int32 ``(S, depth)``, each row a shard's trace positions in
    order, padded with the sentinel ``n``.  Returns arrays of shape
    ``(S, t, L)`` with ``L = seg_length(depth, t, replay)``, segment rows
    laid out ``[replay prefix | core steps]``:

    ``spos``
        scatter positions — where each step's packed flags land in the
        full-trace output; sentinel ``n`` for replay and pad steps, so
        they scatter into the dropped overflow slot.
    ``gpos``
        gather positions — which trace record each step executes; replay
        steps re-execute the real steps preceding the segment.  Clamped
        to ``n - 1`` for pad steps (whose updates are dead anyway).
    ``replay``
        bool, True on live replay steps: state-updates on, outputs off.
        Segment 0 has no history to replay, so its prefix is all dead.
    """
    assert t >= 1
    s_shards, depth = pos.shape
    core = -(-depth // t)
    rp = replay if t > 1 else 0
    lseg = core + rp
    padded = np.full((s_shards, t * core), np.int32(n), dtype=np.int32)
    padded[:, :depth] = pos
    cores = padded.reshape(s_shards, t, core)

    spos = np.full((s_shards, t, lseg), np.int32(n), dtype=np.int32)
    spos[:, :, rp:] = cores
    gpos = spos.copy()
    rmask = np.zeros((s_shards, t, lseg), dtype=bool)
    if rp:
        flat = padded.reshape(s_shards, t * core)
        for k in range(1, t):
            # right-aligned window of the last rp real positions before
            # segment k; sentinel-padded entries are dead replay slots
            win = flat[:, k * core - rp: k * core]
            gpos[:, k, :rp] = win
            rmask[:, k, :rp] = win < n
    gpos = np.minimum(gpos, np.int32(max(n - 1, 0)))
    return {"spos": spos, "gpos": gpos, "replay": rmask}


# --- the stitch loop -------------------------------------------------------

def stitch(run: Callable[[Any, int], Tuple[Any, Any]],
           guesses: Any,
           advance: Callable[[Any, Any], Any],
           equal: Callable[[Any, Any], bool],
           max_rounds: int,
           on_round: Optional[Callable[[int], None]] = None,
           ) -> Tuple[Any, int]:
    """Iterate speculative execution to its exact fixed point.

    ``run(g, round_no)`` executes every segment from boundary guesses
    ``g`` and returns ``(outputs, aux)`` — ``outputs`` holds each
    segment's final carry, ``aux`` whatever the caller wants back (e.g.
    counters).  ``advance(g, outputs)`` composes the next guesses by
    handing each segment its predecessor's output carry.  ``equal`` is
    bit-exact equality of two guesses.  Returns ``(aux, rounds)`` from the
    converged round; raises :class:`StitchError` past ``max_rounds``.
    """
    g = guesses
    for rnd in range(1, max_rounds + 1):
        if on_round is not None:
            on_round(rnd)
        outputs, aux = run(g, rnd)
        g_new = advance(g, outputs)
        if equal(g_new, g):
            return aux, rnd
        g = g_new
    raise StitchError(
        f"temporal stitch did not reach a fixed point in {max_rounds} "
        f"rounds — engine composition rule is inconsistent")
