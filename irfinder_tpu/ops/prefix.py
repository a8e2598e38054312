"""Two-level prefix sums for genome-scale int32 arrays.

A flat 1D cumsum over N elements may lower to ~log2(N) full-array passes
(28 at whole-genome MBS ~ 303M).  Splitting into (N/K, K) rows costs
log2(K) row passes plus a tiny N/K row cumsum; results are IDENTICAL mod
2^32 (addition is associative in two's-complement), so every int32
wraparound-exactness argument in the counting/finalize path carries over
unchanged.

Used by ops/step.finalize_device (depth/spans diff -> running depth),
ops/finalize_stats (prefix tables + flat-list expansion), and
parallel/genome.make_depth_reassemble.
"""

from __future__ import annotations

import jax.numpy as jnp

#: elements per row of the two-level split
PFX_K = 2048


def cumsum_1d(x):
    """Inclusive cumsum of a 1D int32 array, bit-identical to
    jnp.cumsum(x, dtype=int32) and memory-bound at large n."""
    n = x.shape[0]
    if n <= 4 * PFX_K:
        return jnp.cumsum(x, dtype=jnp.int32)
    pad = (-n) % PFX_K
    x2 = jnp.pad(x, (0, pad)).reshape(-1, PFX_K)
    rp = jnp.cumsum(x2, axis=1, dtype=jnp.int32)
    tile = rp[:, -1]
    tp = jnp.cumsum(tile, dtype=jnp.int32) - tile
    return (rp + tp[:, None]).reshape(-1)[:n]


def cumsum_last(x):
    """Inclusive cumsum along the last axis of a 2D int32 array (each row
    independently), bit-identical to jnp.cumsum(x, axis=-1, dtype=int32)."""
    if x.ndim == 1:
        return cumsum_1d(x)
    assert x.ndim == 2
    n = x.shape[1]
    if n <= 4 * PFX_K:
        return jnp.cumsum(x, axis=1, dtype=jnp.int32)
    pad = (-n) % PFX_K
    x2 = jnp.pad(x, ((0, 0), (0, pad))).reshape(x.shape[0], -1, PFX_K)
    rp = jnp.cumsum(x2, axis=2, dtype=jnp.int32)
    tile = rp[:, :, -1]
    tp = jnp.cumsum(tile, axis=1, dtype=jnp.int32) - tile
    return (rp + tp[:, :, None]).reshape(x.shape[0], -1)[:, :n]
