"""The finalize statistics' on-device flat-list expansion
(ops/finalize_stats.expand_runs) vs np.repeat.

Each intron subset is a list of runs (MBS start, length, histogram base).
The device expands them into one entry per included base — src (the base's
MBS index) and base_exp (its run's histogram base) — from the tiny run
tables, by a delta scatter plus a prefix sum instead of a gather.  These
tests pin both outputs to the host np.repeat expansion, including
overlapping introns (backtracking src), zero-length runs (leading, inner and
trailing) and expansions longer than one prefix row.  All values are int32
indices, so every comparison is exact equality: no tolerance applies.
"""

import jax.numpy as jnp
import numpy as np

from irfinder_tpu.ops.finalize_stats import expand_runs


def _check(starts, lens, bases=None):
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    if bases is None:
        bases = np.arange(lens.size, dtype=np.int64) * 2048
    F = int(lens.sum())
    off = np.cumsum(lens) - lens
    want_src = (np.repeat(starts, lens) + np.arange(F) - np.repeat(off, lens)).astype(np.int32)
    want_base = np.repeat(np.asarray(bases, np.int64), lens).astype(np.int32)
    src, base_exp = expand_runs(
        jnp.asarray(starts.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)),
        jnp.asarray(np.asarray(bases).astype(np.int32)),
        F,
    )
    # exact: int32 indices
    np.testing.assert_array_equal(np.asarray(src), want_src)
    np.testing.assert_array_equal(np.asarray(base_exp), want_base)


def test_sequential_runs_exact():
    # adjacent runs walking forward
    _check([0, 500, 1200, 4000, 4100], [500, 700, 300, 100, 900])


def test_overlapping_introns_backtrack():
    # overlapping introns revisit the same MBS bases: src steps backwards
    _check([0, 100, 50, 3000, 2500], [2000, 1500, 800, 2000, 4000])


def test_distant_runs_in_one_block():
    # runs far apart in MBS next to each other in the flat list
    _check([0, 10 * 16384, 7], [64, 64, 64])


def test_zero_length_runs_and_big_block():
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 400, size=200)
    starts = np.cumsum(lens) - lens + rng.integers(0, 50, size=200)
    _check(starts, lens)


def test_multiblock():
    # longer than several prefix rows (ops/prefix.PFX_K)
    lens = np.full(40, 700)
    _check((np.cumsum(lens) - lens) + 13, lens)


def test_leading_and_trailing_zero_length_runs():
    # zero-length runs at both ends put their deltas at flat offset 0 and at
    # offset F (dropped); the owning runs' values must come through intact
    _check([5, 9, 100, 300, 40, 41], [0, 0, 30, 20, 0, 0], bases=[0, 7, 11, 13, 17, 19])
