"""The port's temporal split (``repro_torch.core.tsplit``) against the JAX
package's (``repro.core.tsplit``), on the same seeded numpy inputs: the
replay prefix setting, segment lengths, the per-segment gather/scatter plan
of ``split_positions`` (exactly equal arrays), and the fixed-point
``stitch`` loop (the same converged output and round count on a toy
engine, and a ``StitchError`` past the round bound in both)."""

import numpy as np
import pytest

from repro.core import tsplit as R

from repro_torch.core import tsplit as P


def _pos(seed, shards, depth, n):
    """Each shard row a sorted run of trace positions, padded with n."""
    rng = np.random.default_rng(seed)
    pos = np.full((shards, depth), n, np.int32)
    owner = rng.integers(0, shards, n)
    for s in range(shards):
        mine = np.nonzero(owner == s)[0][:depth].astype(np.int32)
        pos[s, :mine.size] = mine
    return pos


@pytest.mark.parametrize("shards,t,replay", [
    (1, 1, 0), (1, 2, 0), (1, 3, 5), (2, 4, 0), (2, 4, 7), (4, 5, 3),
    (3, 16, 2), (1, 16, 64)])
def test_split_positions_equal_reference(shards, t, replay):
    n = 1500
    depth = -(-n // shards) + 40
    pos = _pos(shards * 100 + t, shards, depth, n)
    got = P.split_positions(pos, n, t, replay)
    want = R.split_positions(pos, n, t, replay)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert got["spos"].shape[-1] == P.seg_length(depth, t, replay) \
        == R.seg_length(depth, t, replay)


def test_replay_prefix_setting_matches_reference():
    old_p, old_r = P.replay_prefix(), R.replay_prefix()
    try:
        for v in (0, 5, -3, 64):
            assert P.set_replay_prefix(v) == R.set_replay_prefix(v)
            assert P.replay_prefix() == R.replay_prefix()
    finally:
        P.set_replay_prefix(old_p)
        R.set_replay_prefix(old_r)


def _toy(seed, T, state=64):
    """A deterministic segmented engine: each segment applies its own
    random permutation-and-xor to the carry, touching a random subset."""
    rng = np.random.default_rng(seed)
    touched = rng.random((T, state)) < 0.3
    key = rng.integers(0, 1 << 20, (T, state))

    def run(g, _rnd):
        out = np.where(touched, (g * 3 + key) % 1000003, g)
        return out, out.sum(axis=1)

    def advance(g, out):
        new = np.empty_like(g)
        new[0] = 0
        for t in range(1, T):
            new[t] = np.where(touched[t - 1], out[t - 1], new[t - 1])
        return new

    return run, advance, np.zeros((T, state), np.int64)


@pytest.mark.parametrize("T", [1, 2, 5, 9])
def test_stitch_reaches_the_reference_fixed_point(T):
    run, advance, g0 = _toy(T, T)
    got, rounds = P.stitch(run, g0, advance, np.array_equal, T + 1)
    want, want_rounds = R.stitch(run, g0, advance, np.array_equal, T + 1)
    assert rounds == want_rounds
    assert np.array_equal(got, want)


def test_stitch_raises_past_its_round_bound():
    run, advance, g0 = _toy(3, 6)
    seen = []
    with pytest.raises(P.StitchError):
        P.stitch(run, g0, advance, np.array_equal, 2, on_round=seen.append)
    with pytest.raises(R.StitchError):
        R.stitch(run, g0, advance, np.array_equal, 2)
    assert seen == [1, 2]
