"""FastQ --stream throughput (round-2 verdict #6, round-3 verdict #3): the
streaming path counting off a PIPE (the `FastQ --stream` mode, which overlaps
counting with alignment) vs the native-decoder file path, on the same
realistic-mix BAM.

Round 4: --stream rides the NATIVE streaming decoder (bd_open_fd: reader
thread feeding the multithreaded inflate pool), so the pipe path should sit
within ~2x of the mmap file path; the pure-Python streaming decoder remains
the fallback and its ceiling is reported for honesty.

  python bench/stream_throughput.py            # 1M pairs (~2M records)
  STREAM_PAIRS=250000 python bench/stream_throughput.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = os.environ.get(
    "BENCH_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_cache"),
)
# --smoke / BENCH_SMOKE=1: micro shapes (suite-enforced bench health)
SMOKE = os.environ.get("BENCH_SMOKE", "") not in ("", "0") or "--smoke" in sys.argv

TABLES = [
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
]


def main() -> None:
    from irfinder_tpu.backend import init_compile_cache

    init_compile_cache()

    from irfinder_tpu.engine import run_bam
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.io.bampy import decode_bam
    from irfinder_tpu.synth import synth_ref

    n_pairs = int(os.environ.get("STREAM_PAIRS", 2_000 if SMOKE else 1_000_000))
    ref = synth_ref(
        n_genes=200 if SMOKE else 1200, n_chroms=8, chrom_len=40_000_000, seed=5
    )
    os.makedirs(CACHE, exist_ok=True)
    tag = "_smoke" if SMOKE else ""
    bam = os.path.join(CACHE, f"stream_p{n_pairs}{tag}_v1.bam")
    if not os.path.exists(bam):
        st = write_realistic_bam(bam + ".tmp", ref, n_pairs=n_pairs, seed=8)
        os.replace(bam + ".tmp", bam)
        print(f"[stream] generated {st.n_records} records", file=sys.stderr)

    out = {}
    tmp = tempfile.mkdtemp(prefix="irstream_")
    try:
        # warm compiles so the pipe runs below time steady-state throughput
        run_bam(ref, bam, os.path.join(tmp, "warm"))

        # 1) full --stream path: pipe -> NATIVE streaming decoder -> tables
        cat = subprocess.Popen(["cat", bam], stdout=subprocess.PIPE)
        t0 = time.perf_counter()
        m = run_bam(ref, cat.stdout, os.path.join(tmp, "stream_out"))
        dt = time.perf_counter() - t0
        cat.stdout.close()
        cat.wait()
        out["stream_e2e_reads_per_s"] = round(m.reads_total / dt, 1)
        out["n_reads"] = m.reads_total

        # 2) native file path on the same BAM (the non-stream FastQ spool)
        t0 = time.perf_counter()
        m = run_bam(ref, bam, os.path.join(tmp, "native_out"))
        dt = time.perf_counter() - t0
        out["native_file_e2e_reads_per_s"] = round(m.reads_total / dt, 1)
        out["stream_vs_file"] = round(
            out["stream_e2e_reads_per_s"] / out["native_file_e2e_reads_per_s"], 3
        )

        # stream and file paths must emit byte-identical tables
        for t in TABLES:
            a = open(os.path.join(tmp, "stream_out", t), "rb").read()
            b = open(os.path.join(tmp, "native_out", t), "rb").read()
            assert a == b, f"stream/file table mismatch: {t}"
        out["tables_identical"] = True

        # 3) decode-only ceiling of the PYTHON streaming decoder (fallback
        #    when the native library is unavailable)
        cat = subprocess.Popen(["cat", bam], stdout=subprocess.PIPE)
        ci = {c: i for i, c in enumerate(ref.chroms)}
        t0 = time.perf_counter()
        _, batches, stats = decode_bam(cat.stdout, ci)
        for _ in batches:
            pass
        dt = time.perf_counter() - t0
        cat.stdout.close()
        cat.wait()
        out["python_fallback_decode_only_reads_per_s"] = round(
            stats.reads_total / dt, 1
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out["metric"] = "fastq_stream_throughput"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
