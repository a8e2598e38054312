"""Config C (BASELINE.json:9): whole-genome-scale intron map, ~50M-read
sample, end-to-end on one host/chip — measured, not extrapolated
(VERDICT.md round 1, next-round #2).

Synthesizes an 18k-gene / ~162k-intron / ~300M-MBS map over 24 chromosomes
(the round-1 whole-genome stand-in scale) and a realistic-mix BAM
(irfinder_tpu/io/bamgen.py), then runs the full BAM -> tables pipeline,
reporting wall time, stage times, peak host RSS, and (optionally) checkpoint
snapshot overhead at whole-genome counter size.

  python bench/config_c.py                 # full: 25M pairs (~50.7M records)
  CONFIG_C_PAIRS=1000000 python bench/config_c.py   # scaled-down shakeout
  CONFIG_C_CHECKPOINT=1 python bench/config_c.py    # + snapshot timing
  CONFIG_C_MESH=genome=4 python bench/config_c.py   # explicit binned mesh form
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = os.environ.get(
    "BENCH_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_cache"),
)
# --smoke / BENCH_SMOKE=1: micro shapes, 1 rep (suite-enforced bench health)
SMOKE = os.environ.get("BENCH_SMOKE", "") not in ("", "0") or "--smoke" in sys.argv


def main() -> None:
    from irfinder_tpu.backend import init_compile_cache

    init_compile_cache()

    from irfinder_tpu.engine import run_bam
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    n_pairs = int(os.environ.get("CONFIG_C_PAIRS", 3_000 if SMOKE else 25_000_000))
    n_genes = int(os.environ.get("CONFIG_C_GENES", 240 if SMOKE else 18_000))

    t0 = time.perf_counter()
    ref = synth_ref(n_genes=n_genes, n_chroms=24, chrom_len=2_000_000_000, seed=0)
    print(
        f"[config_c] map: {ref.n_introns} introns / {ref.n_chroms} chroms / "
        f"{ref.mbs_size/1e6:.0f}M MBS ({time.perf_counter()-t0:.1f}s)",
        file=sys.stderr,
    )

    os.makedirs(CACHE, exist_ok=True)
    bam = os.path.join(CACHE, f"configC_g{n_genes}_p{n_pairs}_v2.bam")
    if not os.path.exists(bam):
        t0 = time.perf_counter()
        st = write_realistic_bam(bam + ".tmp", ref, n_pairs=n_pairs, seed=0)
        os.replace(bam + ".tmp", bam)
        print(
            f"[config_c] generated {st.n_records} records in "
            f"{time.perf_counter()-t0:.1f}s -> {bam} "
            f"({os.path.getsize(bam)/1e9:.2f} GB)",
            file=sys.stderr,
        )

    out = os.path.join(CACHE, "configC_out")
    ckpt = os.path.join(CACHE, "configC.ckpt") if os.environ.get("CONFIG_C_CHECKPOINT") else None
    mesh = os.environ.get("CONFIG_C_MESH")
    # rep 2+ measures the in-process warm run: one-time XLA compiles land
    # in rep 1
    reps = int(os.environ.get("CONFIG_C_REPS", 1))
    for rep in range(reps):
        t0 = time.perf_counter()
        if mesh:
            from irfinder_tpu.engine_mesh import MeshSpec, run_bam_mesh

            metrics = run_bam_mesh(ref, bam, out, MeshSpec.parse(mesh))
        else:
            metrics = run_bam(ref, bam, out, checkpoint=ckpt, checkpoint_every=64)
        dt = time.perf_counter() - t0
        if rep < reps - 1:
            print(f"[config_c] rep {rep}: {dt:.1f}s (compile-inclusive)", file=sys.stderr)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(
        json.dumps(
            {
                "metric": "config_c_e2e_reads_per_s",
                "value": round(metrics.reads_total / dt, 1),
                "unit": "reads/s",
                "n_reads": metrics.reads_total,
                "wall_s": round(dt, 2),
                "decode_s": round(metrics.decode_s, 2),
                "h2d_s": round(metrics.h2d_s, 2),
                "route_s": round(metrics.route_s, 2),
                "device_s": round(metrics.device_s, 2),
                "finalize_s": round(metrics.finalize_s, 2),
                "route_pad_ratio": round(
                    metrics.route_rows_padded / metrics.route_rows_real, 3
                ) if metrics.route_rows_real else 0.0,
                "peak_host_rss_gb": round(peak_gb, 2),
                "n_introns": ref.n_introns,
                "mbs": ref.mbs_size,
                "checkpointed": bool(ckpt),
                "mesh": mesh or "",
            }
        )
    )


if __name__ == "__main__":
    main()
