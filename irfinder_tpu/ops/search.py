"""Vectorized lexicographic binary search in int32 — the device-side analog of
the reference's per-chromosome sorted-map lookups (SURVEY.md §2 rows 10-12,
historical src/irfinder/ReadBlockProcessor*.cpp walked std::map/sorted vectors
per fragment; here every query lane searches in parallel).

Keys are tuples of int32 columns (e.g. (chrom, coord) or (chrom, start, end)),
sorted lexicographically.  int64 composite keys are avoided entirely (JAX
runs without x64 by default) by comparing the columns lexicographically
inside the search loop.  The loop has a static bound
of ceil(log2(n))+1 iterations, so it jits to a fixed unrolled/fori program —
no data-dependent control flow (XLA-compatible by construction).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _lex_less(key_cols, idx, q_cols, or_equal: bool):
    """(key[idx] < q) lexicographically; (<=) when or_equal."""
    lt = jnp.zeros(idx.shape, dtype=bool)
    eq = jnp.ones(idx.shape, dtype=bool)
    for col, q in zip(key_cols, q_cols):
        v = jnp.take(col, idx, mode="clip")
        lt = lt | (eq & (v < q))
        eq = eq & (v == q)
    return (lt | eq) if or_equal else lt


def searchsorted_lex(key_cols, q_cols, side: str = "left") -> jnp.ndarray:
    """For each query row, the insertion index into the lexicographically
    sorted key columns.  side='left': first i with key[i] >= q;
    side='right': first i with key[i] > q.  Shapes: each key col (n,), each
    query col (q,); returns int32 (q,).  n == 0 returns zeros.
    """
    n = int(key_cols[0].shape[0])
    q_shape = q_cols[0].shape
    if n == 0:
        return jnp.zeros(q_shape, dtype=jnp.int32)
    or_equal = side == "right"
    steps = max(1, n.bit_length())

    # Derive the initial carry from the query so it inherits the query's
    # device-varying axes under shard_map (a plain jnp.zeros would be
    # unvarying and trip fori_loop's carry-type check).
    lo = (q_cols[0] * 0).astype(jnp.int32)
    hi = lo + jnp.int32(n)

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) >> 1
        go = _lex_less(key_cols, mid, q_cols, or_equal)
        active = lo < hi
        lo = jnp.where(active & go, mid + 1, lo)
        hi = jnp.where(active & ~go, mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo


@partial(jax.jit, static_argnames=("side",))
def searchsorted2(hi_col, lo_col, q_hi, q_lo, side: str = "left"):
    """Two-column convenience wrapper (chrom, coord)."""
    return searchsorted_lex((hi_col, lo_col), (q_hi, q_lo), side=side)
