"""--long-reads throughput: ONT/PacBio-shaped full-length transcript
alignments (16-96 exon blocks, 10-100kb spans; io/bamgen.write_longread_bam)
through the full BAM -> tables pipeline, with and without the --long-reads
batch geometry (LONGREAD_BLOCKS_PER_FRAG — a padding/throughput knob only;
semantics identical either way, tables asserted byte-equal).

  python bench/longread_throughput.py             # 300k reads
  LONGREAD_READS=50000 python bench/longread_throughput.py
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
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

    from irfinder_tpu.config import RunConfig
    from irfinder_tpu.engine import run_bam
    from irfinder_tpu.io.bamgen import write_longread_bam
    from irfinder_tpu.synth import synth_ref

    n_reads = int(os.environ.get("LONGREAD_READS", 1_000 if SMOKE else 300_000))
    ref = synth_ref(n_genes=200 if SMOKE else 800)
    os.makedirs(CACHE, exist_ok=True)
    tag = "_smoke" if SMOKE else ""
    bam = os.path.join(CACHE, f"longread_r{n_reads}{tag}_v1.bam")
    if not os.path.exists(bam):
        st = write_longread_bam(bam + ".tmp", ref, n_reads=n_reads, seed=5)
        os.replace(bam + ".tmp", bam)
        print(f"[longread] generated {st.n_records} records", file=sys.stderr)

    out = {}
    tmp = tempfile.mkdtemp(prefix="irlong_")
    reps = int(os.environ.get("LONGREAD_REPS", 1 if SMOKE else 2))
    try:
        results = {}
        for label, cfg in (
            ("longread_geometry", RunConfig(long_reads=True)),
            ("paired_geometry", RunConfig(long_reads=False)),
        ):
            run_bam(ref, bam, os.path.join(tmp, f"warm_{label}"), config=cfg)
            dt = float("inf")
            for r in range(reps):
                t0 = time.perf_counter()
                m = run_bam(ref, bam, os.path.join(tmp, f"{label}_{r}"), config=cfg)
                if time.perf_counter() - t0 < dt:
                    dt = time.perf_counter() - t0
                    best_m = m
            out[f"{label}_reads_per_s"] = round(m.reads_total / dt, 1)
            out[f"{label}_wall_s"] = round(dt, 2)
            # per-stage decomposition (round-4 verdict #6): which stage binds
            m = best_m
            out[f"{label}_decode_s"] = round(m.decode_s, 2)
            out[f"{label}_h2d_s"] = round(m.h2d_s, 2)
            out[f"{label}_device_s"] = round(m.device_s, 2)
            out[f"{label}_sync_s"] = round(m.sync_s, 2)
            out[f"{label}_finalize_s"] = round(m.finalize_s, 2)
            out[f"{label}_batches"] = m.batches
            results[label] = os.path.join(tmp, f"{label}_0")
        # geometry is a padding knob ONLY: tables must be byte-identical
        for t in (
            "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt",
            "IRFinder-JuncCount.txt", "IRFinder-SpansPoint.txt",
            "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
        ):
            a = open(os.path.join(results["longread_geometry"], t), "rb").read()
            b = open(os.path.join(results["paired_geometry"], t), "rb").read()
            assert a == b, f"geometry changed table {t}"
        out["tables_identical"] = True
        out["n_reads"] = m.reads_total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out["metric"] = "longread_throughput"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
