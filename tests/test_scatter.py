"""The device path's two scatter-adds (ops/scatter.py) vs NumPy ground truth.

`scatter_add` is the counting step's fused counter update; `histogram` builds
the finalize statistics' per-intron depth histograms.  Both are integer
scatter-adds, which the GPU runs as atomics in no fixed order; integer
addition is associative, so every result must equal np.add.at / np.bincount
exactly — every update applied once, any duplicate multiplicity.  All values
are int32 counts, so every comparison is exact equality: no tolerance
applies.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from irfinder_tpu.ops.scatter import histogram, scatter_add


def _truth(m, idx, val):
    out = np.zeros(m, np.int64)
    np.add.at(out, idx, val)
    return out


@pytest.mark.parametrize(
    "m,n,seed",
    [
        (1 << 16, 1000, 0),  # many more slots than updates
        (196625, 5000, 1),  # odd length
        (131072, 3077, 2),
        (327680, 1, 3),  # single update
    ],
)
def test_matches_numpy(m, n, seed):
    # exact: int32 counts
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, size=n).astype(np.int32)
    val = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    got = jax.jit(scatter_add)(jnp.zeros(m, jnp.int32), jnp.asarray(idx), jnp.asarray(val))
    np.testing.assert_array_equal(np.asarray(got), _truth(m, idx, val))


def test_duplicates_and_hotspots():
    # exact: int32 counts.  All updates hammer a handful of slots (the
    # same-address atomics case), including the first and last slot.
    rng = np.random.default_rng(7)
    m = 1 << 17
    slots = np.array([0, 5, 65535, 65536, 65537, m - 1], np.int32)
    idx = rng.choice(slots, size=4096).astype(np.int32)
    val = np.where(rng.random(idx.size) < 0.5, 1, -1).astype(np.int32)
    got = scatter_add(jnp.zeros(m, jnp.int32), jnp.asarray(idx), jnp.asarray(val))
    np.testing.assert_array_equal(np.asarray(got), _truth(m, idx, val))


def test_accumulates_onto_existing():
    # exact: int32 counts
    rng = np.random.default_rng(9)
    m = 65539
    base = rng.integers(-50, 50, size=m).astype(np.int32)
    idx = rng.integers(0, m, size=777).astype(np.int32)
    val = np.where(rng.random(777) < 0.5, 1, -1).astype(np.int32)
    got = scatter_add(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(val))
    np.testing.assert_array_equal(np.asarray(got), base.astype(np.int64) + _truth(m, idx, val))


def test_histogram_matches_bincount():
    # exact: int32 counts.  The finalize shape: intron-major bins, most
    # updates in bin 0 of each intron (low depth), a few saturated in the
    # last bin.
    rng = np.random.default_rng(11)
    n_introns, cap = 300, 64
    local = np.sort(rng.integers(0, n_introns, size=20_000))
    depth = np.minimum(rng.geometric(0.6, size=local.size) - 1, cap - 1)
    hidx = (local * cap + depth).astype(np.int32)
    got = jax.jit(histogram, static_argnums=0)(n_introns * cap, jnp.asarray(hidx))
    np.testing.assert_array_equal(
        np.asarray(got), np.bincount(hidx, minlength=n_introns * cap)
    )
