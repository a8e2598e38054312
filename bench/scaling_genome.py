"""dp x genome redundancy quantification (VERDICT.md round 1, next-round #5).

The dp x genome step replicates every dp-shard batch to every genome shard
(parallel/genome.py make_dp_genome_step: batch spec P(dp)), relying on
self-neutralizing queries for non-owned chromosomes.  This script measures
what that redundancy actually costs: per-step wall time vs G on the virtual
CPU mesh, for (a) the replicated-batch step and (b) the same step fed
host-routed per-shard sub-batches (each genome shard only sees reads on its
own chromosomes).

Because all virtual devices share the host's physical cores, wall time here
tracks TOTAL work — exactly the quantity the redundancy inflates.  Run:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python bench/scaling_genome.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# --smoke / BENCH_SMOKE=1: micro shapes + G=2 only, so the suite can assert
# this bench runs at HEAD (round-4 verdict #1: the published G-sweep crashed
# because nothing exercised the bench's code path)
SMOKE = os.environ.get("BENCH_SMOKE", "") not in ("", "0") or "--smoke" in sys.argv

# this bench measures total work on a virtual 8-device CPU mesh: XLA_FLAGS
# must precede the first backend init
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main() -> None:
    import jax
    from jax.sharding import Mesh

    from irfinder_tpu.backend import init_compile_cache

    init_compile_cache()

    from irfinder_tpu.io.batch import device_batch
    from irfinder_tpu.parallel.genome import (
        build_stacked_dref,
        init_dp_genome_counters,
        make_dp_genome_step,
        plan_shards,
        route_flat_batch,
    )
    from irfinder_tpu.parallel.shard import pad_batch_to_multiple
    from irfinder_tpu.synth import synth_batch_arrays, synth_ref

    n_frags = int(os.environ.get("SCALE_FRAGS", 2048 if SMOKE else 1 << 14))
    reps = int(os.environ.get("SCALE_REPS", 1 if SMOKE else 5))
    ref = synth_ref(
        n_genes=200 if SMOKE else 1200, n_chroms=24, chrom_len=400_000_000, seed=0
    )
    batch, n_reads = synth_batch_arrays(ref, n_frags=n_frags, seed=1)
    batch = device_batch(batch)
    rows = []
    for G in (1, 2) if SMOKE else (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:G]).reshape(1, G), ("dp", "genome"))
        plan = plan_shards(ref, G)
        sdref = build_stacked_dref(ref, plan)
        for routed in (False, True):
            step, place_dref, place_c, place_b = make_dp_genome_step(
                mesh, routed=routed
            )
            d = place_dref(sdref)
            c = place_c(init_dp_genome_counters(sdref, ref.n_chroms, 1, G))
            if routed:
                b, cell_reads = route_flat_batch(plan, batch, 1, G)
                b = place_b(b)
            else:
                b = place_b(pad_batch_to_multiple(batch, 1))
            c = step(d, c, b)  # compile
            jax.block_until_ready(c["cnt"])
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                c = step(d, c, b)
                jax.block_until_ready(c["cnt"])
                best = min(best, time.perf_counter() - t0)
            rows.append(
                {
                    "G": G,
                    "routed": routed,
                    "step_ms": round(best * 1e3, 2),
                    "reads_per_s": round(n_reads / best, 1),
                }
            )
            print(json.dumps(rows[-1]), file=sys.stderr)

    # ---- END-TO-END column (round-2 verdict next-round #1b): the full
    # run_bam_mesh pipeline — decode, host routing, padding inflation, H2D,
    # sharded step, merge/reassemble, finalize, table writing — in reads/s,
    # vs the unsharded run_bam on the same realistic-mix BAM ----------------
    import tempfile

    from irfinder_tpu.engine import run_bam
    from irfinder_tpu.engine_mesh import MeshSpec, run_bam_mesh
    from irfinder_tpu.io.bamgen import write_realistic_bam

    n_pairs = int(os.environ.get("SCALE_E2E_PAIRS", 2_000 if SMOKE else 150_000))
    e2e_rows = []
    with tempfile.TemporaryDirectory() as td:
        bam = os.path.join(td, "scaling.bam")
        st = write_realistic_bam(bam, ref, n_pairs=n_pairs, seed=2)
        e2e_reps = int(os.environ.get("SCALE_E2E_REPS", 1 if SMOKE else 2))
        base = float("inf")
        for r in range(e2e_reps):  # best-of: drop one-time compiles
            t0 = time.perf_counter()
            run_bam(ref, bam, os.path.join(td, f"out0_{r}"))
            base = min(base, time.perf_counter() - t0)
        e2e_rows.append(
            {
                "G": 0,
                "mode": "unsharded",
                "e2e_s": round(base, 2),
                "e2e_reads_per_s": round(st.n_records / base, 1),
            }
        )
        print(json.dumps(e2e_rows[-1]), file=sys.stderr)
        # NOTE on reading this table: every virtual device shares the host's
        # two physical cores, so e2e wall tracks TOTAL work — the unsharded
        # run (padding 1.0) is the structural floor and routed can only pay
        # its padding tax here.  The design comparison is routed vs
        # REPLICATED at matched G (replicated inflates total work xG); on
        # real chips per-chip work drops 1/G for both.
        for G in (2,) if SMOKE else (1, 2, 4, 8):
            for routed in (True, False):
                if not routed and G == 1:
                    continue
                dt = float("inf")
                for r in range(e2e_reps):
                    t0 = time.perf_counter()
                    m = run_bam_mesh(
                        ref, bam, os.path.join(td, f"outg{G}_{routed}_{r}"),
                        MeshSpec(dp=1, genome=G, routed=routed),
                    )
                    dt = min(dt, time.perf_counter() - t0)
                row = {
                    "G": G,
                    "mode": "routed" if routed else "replicated",
                    "e2e_s": round(dt, 2),
                    "e2e_reads_per_s": round(st.n_records / dt, 1),
                }
                if routed:
                    row["route_s"] = round(m.route_s, 3)
                    row["route_pad_ratio"] = round(
                        m.route_rows_padded / m.route_rows_real, 3
                    ) if m.route_rows_real else 0.0
                e2e_rows.append(row)
                print(json.dumps(e2e_rows[-1]), file=sys.stderr)
    print(json.dumps({"metric": "dp_genome_scaling", "rows": rows, "e2e": e2e_rows}))


if __name__ == "__main__":
    main()
