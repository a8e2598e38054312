"""Config D (BASELINE.json:10): 8 BAMs streamed concurrently through one
engine (one device ref, one compiled step), realistic read mix, measured
aggregate throughput + pooled differential.

  python bench/config_d.py                    # 8 x 1M-record samples
  CONFIG_D_PAIRS=100000 python bench/config_d.py
"""

from __future__ import annotations

import json
import os
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

    from irfinder_tpu.diff import run_differential
    from irfinder_tpu.engine import run_multi_bam
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    n_pairs = int(os.environ.get("CONFIG_D_PAIRS", 1_000 if SMOKE else 500_000))
    ref = synth_ref(n_genes=200 if SMOKE else 800)
    os.makedirs(CACHE, exist_ok=True)
    bams = []
    for i in range(8):
        tag = "_smoke" if SMOKE else ""
        p = os.path.join(CACHE, f"configD_s{i}_p{n_pairs}{tag}_v2.bam")
        if not os.path.exists(p):
            write_realistic_bam(p + ".tmp", ref, n_pairs=n_pairs, seed=1000 + i)
            os.replace(p + ".tmp", p)
        bams.append(p)

    out_root = os.path.join(CACHE, "configD_out")
    out_dirs = [os.path.join(out_root, f"s{i}") for i in range(8)]
    # warm pass on one small sample to absorb compiles
    import tempfile

    from irfinder_tpu.engine import run_bam

    warm_pairs = 2_000 if SMOKE else 50_000
    warm = os.path.join(CACHE, f"realistic_p{warm_pairs}_s3_v2.bam")
    if not os.path.exists(warm):
        write_realistic_bam(warm, ref, n_pairs=warm_pairs, seed=3)
    run_bam(ref, warm, os.path.join(tempfile.mkdtemp(), "warm"))

    reps = int(os.environ.get("CONFIG_D_REPS", 1 if SMOKE else 2))
    dt = float("inf")
    for _ in range(reps):  # best-of
        t0 = time.perf_counter()
        metrics = run_multi_bam(ref, bams, out_dirs)
        dt = min(dt, time.perf_counter() - t0)
    total = sum(m.reads_total for m in metrics)

    t1 = time.perf_counter()
    run_differential(
        cond_a=out_dirs[:4], cond_b=out_dirs[4:],
        out_path=os.path.join(out_root, "IRFinder-Diff.txt"), min_cov=None,
    )
    diff_s = time.perf_counter() - t1
    m0 = metrics[0]
    print(
        json.dumps(
            {
                "metric": "config_d_aggregate_reads_per_s",
                "value": round(total / dt, 1),
                "unit": "reads/s",
                "n_samples": 8,
                "n_reads": total,
                "wall_s": round(dt, 2),
                "diff_s": round(diff_s, 2),
                # phase decomposition vs config A (round-4 verdict #2):
                # stream wall, finalize-drain wall, then per-phase sums
                # across samples (feeders overlap, so sums > wall)
                "stream_wall_s": round(m0.multi_stream_s, 2),
                "finalize_wall_s": round(m0.multi_finalize_s, 2),
                "decode_s_sum": round(sum(m.decode_s for m in metrics), 2),
                "h2d_s_sum": round(sum(m.h2d_s for m in metrics), 2),
                "device_s_sum": round(sum(m.device_s for m in metrics), 2),
                "sync_s_sum": round(sum(m.sync_s for m in metrics), 2),
                "finalize_s_sum": round(sum(m.finalize_s for m in metrics), 2),
            }
        )
    )


if __name__ == "__main__":
    main()
