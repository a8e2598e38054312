"""The two integer scatter-adds of the device path, as plain XLA.

* `scatter_add`: the counting step's one fused counter update
  (`cnt.at[idx].add(val)`, ops/step.py).
* `histogram`: the finalize statistics' per-intron depth histogram
  (`zeros(n).at[idx].add(1)`, ops/finalize_stats.py).

On the GPU XLA lowers both to atomic adds.  Integer addition is associative,
so the result does not depend on the order in which the atomics land: every
count is bit-identical to np.add.at / np.bincount (tests/test_scatter.py).
"""

from __future__ import annotations

import jax.numpy as jnp


def scatter_add(cnt, idx, val):
    """cnt.at[idx].add(val) (JAX's default index handling: updates at
    indices past the end are dropped)."""
    return cnt.at[idx].add(val)


def histogram(n: int, idx):
    """int32 (n,) counts of each index in idx."""
    return jnp.zeros(n, jnp.int32).at[idx].add(1)
