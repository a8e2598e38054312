"""Bucketed (B-tree style) device search tables for the counting step's
rank lookups.

A lexicographic binary search costs O(log N) rounds of per-lane gathers
(ops/search.py, kept as a test reference).  This module ranks by counting
instead: `rank(q) = #{keys <= q}`, computed with dense vectorized compares
plus a couple of contiguous row gathers per query.  Whether this beats a
plain `jnp.searchsorted` on the GPU has not been measured yet.

Structure (built host-side in NumPy, shipped once per run):

* the sorted key table is padded with >= 1 lex-+inf sentinel row and reshaped
  into buckets of S=128 keys;
* level j-1 stores the *last key of each level-j bucket*; levels shrink by S
  until the top fits a single dense compare (<= top_max entries);
* a query descends: count buckets-entirely-<=-q at the top (dense compare),
  then per level one row gather + in-row count.  Exactly L-1 gathers for an
  L-level table; every gather is a contiguous 512-byte row.

Padding/sentinel invariant: the final bucket at every level ends in +inf
(PAD_CHROM), so a query can never rank past the last real bucket and no
clamping branches are needed.

Payload columns ride along as (nb, S) matrices; `entry()` selects one row via
the same aligned row gather plus a one-hot in-row select — no scalar gathers.

Reference parity: replaces the per-chromosome std::map / sorted-vector walks
of the historical ReadBlockProcessor*.cpp (SURVEY.md §2 rows 10-12).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

#: Lex-+inf sentinel for the leading key column (chrom ids are small ints).
PAD_KEY = np.int32(2**31 - 1)


def _lex_le(row_cols, q_cols, or_equal: bool):
    """Vectorized lex compare of table rows vs broadcast queries.
    row_cols[i] has shape (..., S) or (M,); q_cols[i] broadcasts against it.
    Returns (keys < q) or (keys <= q) when or_equal."""
    lt = None
    eq = None
    for col, q in zip(row_cols, q_cols):
        c_lt = col < q
        c_eq = col == q
        if lt is None:
            lt, eq = c_lt, c_eq
        else:
            lt = lt | (eq & c_lt)
            eq = eq & c_eq
    return (lt | eq) if or_equal else lt


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BucketTable:
    """Static-shape layered rank table over k lexicographic int32 key columns.

    levels[0]:   tuple of k dense arrays (m0,)      — top-level last-keys
    levels[j>0]: tuple of k matrices (m_{j-1}, S)   — children's last-keys;
                 the bottom level holds the actual keys.
    payload:     tuple of matrices (nb_bottom, S)   — rides along for entry().
    """

    levels: tuple
    payload: tuple
    n: int  # real (unpadded) key count
    S: int  # bucket width

    def tree_flatten(self):
        return (self.levels, self.payload), (self.n, self.S)

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, payload = children
        return cls(levels=levels, payload=payload, n=aux[0], S=aux[1])

    # -- construction (host side) -------------------------------------------
    @staticmethod
    def build(
        key_cols,
        payload_cols=(),
        bucket: int = 128,
        top_max: int = 1024,
        pad_to: int | None = None,
    ) -> "BucketTable":
        """pad_to: pre-pad the key/payload columns with sentinels to this
        length first — lets tables of different real sizes share one static
        shape (genome-sharded stacking, parallel/genome.py).  Sentinels are
        lex-+inf, so ranks over real keys are unaffected; note `n` then
        reflects the padded count (exact-match queries can never hit a
        sentinel row because no query carries PAD_KEY)."""
        key_cols = [np.asarray(c, dtype=np.int32) for c in key_cols]
        payload_cols = [np.asarray(c, dtype=np.int32) for c in payload_cols]
        if pad_to is not None:
            extra = pad_to - int(key_cols[0].shape[0])
            if extra < 0:
                raise ValueError("pad_to smaller than table")
            if extra:
                key_cols = [
                    np.concatenate(
                        [c, np.full(extra, PAD_KEY if i == 0 else 0, np.int32)]
                    )
                    for i, c in enumerate(key_cols)
                ]
                payload_cols = [
                    np.concatenate([c, np.zeros(extra, np.int32)])
                    for c in payload_cols
                ]
        n = int(key_cols[0].shape[0])
        S = bucket
        # pad with at least one sentinel so the last bucket at every level
        # ends in +inf
        pad = S - (n % S) if n % S else S
        full = []
        for i, c in enumerate(key_cols):
            fill = PAD_KEY if i == 0 else 0
            full.append(np.concatenate([c, np.full(pad, fill, np.int32)]))
        payload_mats = []
        for c in payload_cols:
            payload_mats.append(
                np.concatenate([c, np.zeros(pad, np.int32)]).reshape(-1, S)
            )
        # build levels bottom-up
        bottoms = [c.reshape(-1, S) for c in full]  # (nb, S)
        levels = [tuple(bottoms)]
        lasts = [m[:, -1] for m in bottoms]  # (nb,)
        while lasts[0].shape[0] > top_max:
            m = lasts[0].shape[0]
            pad2 = S - (m % S) if m % S else S
            padded = []
            for i, c in enumerate(lasts):
                fill = PAD_KEY if i == 0 else 0
                padded.append(np.concatenate([c, np.full(pad2, fill, np.int32)]))
            mats = tuple(c.reshape(-1, S) for c in padded)
            levels.append(mats)
            lasts = [m2[:, -1] for m2 in mats]
        levels.append(tuple(lasts))  # dense top
        levels.reverse()  # top .. bottom
        j = jnp.asarray
        return BucketTable(
            levels=tuple(tuple(j(m) for m in lv) for lv in levels),
            payload=tuple(j(m) for m in payload_mats),
            n=n,
            S=S,
        )

    # -- queries (device side, jit-traceable) -------------------------------
    def rank(self, q_cols, side: str = "left"):
        """searchsorted: side='left' -> #{keys < q}, 'right' -> #{keys <= q}.
        q_cols: tuple of int32 (Q,) arrays.  Returns int32 (Q,)."""
        or_equal = side == "right"
        top = self.levels[0]
        q2 = tuple(q[:, None] for q in q_cols)
        cmp = _lex_le(tuple(t[None, :] for t in top), q2, or_equal)
        b = jnp.sum(cmp, axis=1, dtype=jnp.int32)
        for mats in self.levels[1:]:
            rows = tuple(jnp.take(m, b, axis=0) for m in mats)  # (Q, S)
            c = jnp.sum(_lex_le(rows, q2, or_equal), axis=1, dtype=jnp.int32)
            b = b * self.S + c
        return b

    def entry(self, idx):
        """Payload values at sorted position idx (int32 (Q,)).  Out-of-range
        idx (< 0 or >= n) returns the sentinel-padded garbage — callers mask
        with their own validity predicate.  One aligned row gather total."""
        i = jnp.clip(idx, 0, None)
        row, pos = i // self.S, i % self.S
        sel = (
            jax.lax.broadcasted_iota(jnp.int32, (1, self.S), 1) == pos[:, None]
        )
        out = []
        for m in self.payload:
            r = jnp.take(m, row, axis=0)  # (Q, S) aligned rows
            out.append(jnp.sum(jnp.where(sel, r, 0), axis=1, dtype=jnp.int32))
        return tuple(out)

    def match(self, q_cols):
        """Exact-match lookup: (index of first key == q, hit mask).
        Key columns must be included as the first len(q_cols) payload mats."""
        j = self.rank(q_cols, side="left")
        found = self.entry(j)[: len(q_cols)]
        hit = jnp.ones(j.shape, dtype=bool)
        for f, q in zip(found, q_cols):
            hit = hit & (f == q)
        return j, hit & (j < self.n)
