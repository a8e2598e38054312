"""Data-parallel sharding of the counting step over a jax.sharding.Mesh.

The reference has no distributed capability at all — one single-threaded C++
process, POSIX pipes (SURVEY.md §2 rows 21-22).  The scale-out
(BASELINE.json:5,11) composes on one mesh:

* axis "dp" — the read stream: every PackedBatch column array is sharded on
  its leading axis; each device scatter-adds into its OWN stacked counter
  slice.  Correct for arbitrary splits because every counter update is
  per-lane independent (blocks / gaps / fragments never couple inside a
  step), so fragments may even straddle shard boundaries.
* final merge — one integer tree-sum over the device axis.  Integer addition
  is exactly associative, so results are bit-identical at any shard count
  (SURVEY.md §5.8); tests/test_shard.py asserts 1 ≡ 8 devices.

Chromosome-axis map sharding (the "genome" mesh axis for whole-genome maps,
SURVEY.md §5.7) layers on the same structure: shard DeviceRef tables and the
MBS diff array by chrom bins; see parallel/genome.py.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.device_ref import DeviceRef
from ..ops.step import count_step, init_counters


def stacked_counters(dref: DeviceRef, n_refids: int, n_shards: int) -> dict:
    """Per-shard counters with a leading device axis (n_shards, ...)."""
    base = init_counters(dref, n_refids)
    return {
        k: jnp.zeros((n_shards,) + v.shape, dtype=v.dtype) for k, v in base.items()
    }


def _counter_specs(counters: dict, axis: str) -> dict:
    return {k: P(axis, *([None] * (v.ndim - 1))) for k, v in counters.items()}


def make_sharded_step(mesh: Mesh, axis: str = "dp"):
    """Jitted sharded step: dref replicated, counters + batch sharded on
    `axis`.  Returns (step_fn, place_batch, place_counters)."""
    n = mesh.shape[axis]

    def local(dref, counters, batch):
        # counters leaves arrive as (1, ...) per-shard slices
        c = {k: v[0] for k, v in counters.items()}
        c = count_step(dref, c, batch)
        return {k: v[None] for k, v in c.items()}

    def step(dref, counters, batch):
        cspec = _counter_specs(counters, axis)
        bspec = {k: P(axis) for k in batch}
        drspec = jax.tree_util.tree_map(lambda _: P(), dref)
        fn = jax.shard_map(
            local,
            mesh=mesh,
            # the body is purely per-shard (no cross-shard collectives), so
            # the varying-mesh-axes check has nothing to verify
            check_vma=False,
            in_specs=(drspec, cspec, bspec),
            out_specs=cspec,
        )
        return fn(dref, counters, batch)

    jitted = jax.jit(step, donate_argnums=(1,))

    def place_batch(batch_arrays: dict) -> dict:
        """Host numpy batch -> device arrays sharded over the mesh axis."""
        sh = NamedSharding(mesh, P(axis))
        return {k: jax.device_put(v, sh) for k, v in batch_arrays.items()}

    def place_counters(counters: dict) -> dict:
        out = {}
        for k, v in counters.items():
            sh = NamedSharding(mesh, P(axis, *([None] * (v.ndim - 1))))
            out[k] = jax.device_put(v, sh)
        return out

    return jitted, place_batch, place_counters


@jax.jit
def merge_stacked(counters: dict) -> dict:
    """Deterministic integer merge over the device axis (the moral psum)."""
    return {k: v.sum(axis=0) for k, v in counters.items()}


def pad_batch_to_multiple(batch_arrays: dict, n: int) -> dict:
    """Pad each column array so its length divides n (pad lanes carry the
    same all-zero/-1 convention as PackedBatch.empty and provably count 0)."""
    out = {}
    for k, v in batch_arrays.items():
        rem = (-len(v)) % n
        if rem:
            fill = -1 if k.endswith("chrom") or k.endswith("refid") else 0
            v = np.concatenate([v, np.full(rem, fill, dtype=v.dtype)])
        out[k] = v
    return out
