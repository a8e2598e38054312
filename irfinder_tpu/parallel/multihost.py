"""Multi-host execution glue (SURVEY.md §5.8; BASELINE config E).

The reference has no distributed capability — one process, POSIX pipes [R].
The scale-out initializes one JAX process per host
(`jax.distributed.initialize`), builds ONE global mesh over all devices with
axes ("dp", "genome"), and runs the same counting program everywhere:

* every host decodes ITS OWN slice of the read stream (round-robin by batch
  index, or one BAM per host in batch mode) into its local dp shards;
* the reference map is genome-sharded over the global mesh exactly as in
  parallel/genome.py — shardings are global, XLA inserts the collectives
  (NVLink inside a host, the network across hosts);
* counters are integers, so the dp merge (sum) and genome merge (concat)
  are exactly associative: results are bit-identical at any host count —
  the determinism contract tested single-process in tests/test_shard.py and
  tests/test_genome_shard.py, and cross-process in
  tests/test_multihost.py (2-process CPU smoke).

Per-host batch feeding uses jax.make_array_from_process_local_data-style
assembly: each process supplies its local dp shard; the jitted step sees one
global array.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None) -> None:
    """Per-host bring-up.  Without arguments JAX discovers the cluster from
    its environment (e.g. SLURM); elsewhere pass all three explicitly."""
    import jax

    if num_processes is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )


def global_mesh(n_dp: int | None = None, n_genome: int | None = None):
    """One mesh over ALL processes' devices, axes ("dp", "genome").  Default
    factorization: genome axis spans the devices of one host (map shards live
    close together), dp spans hosts."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    n = devs.size
    if n_genome is None:
        n_genome = max(1, jax.local_device_count())
    if n_dp is None:
        n_dp = n // n_genome
    return Mesh(devs.reshape(n_dp, n_genome), ("dp", "genome"))


def host_local_batches(batches, process_index: int | None = None, num_processes: int | None = None):
    """Round-robin split of a batch stream across hosts: host p takes batch
    indices ≡ p (mod P).  Deterministic and order-preserving per host;
    add-associative counters make the interleaving irrelevant."""
    import jax

    p = jax.process_index() if process_index is None else process_index
    P = jax.process_count() if num_processes is None else num_processes
    for i, b in enumerate(batches):
        if i % P == p:
            yield b


def make_global_batch(mesh, local_arrays: dict, dp_axis: str = "dp"):
    """Assemble per-process local batch columns into global arrays sharded
    over the dp axis (each process contributes its local dp shard)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = {}
    for k, v in local_arrays.items():
        sh = NamedSharding(mesh, P(dp_axis))
        global_shape = (v.shape[0] * jax.process_count(),) + v.shape[1:]
        out[k] = jax.make_array_from_process_local_data(sh, v, global_shape)
    return out
