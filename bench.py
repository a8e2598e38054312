"""Benchmark: END-TO-END BAM -> IR-table throughput on a realistic read mix.

Headline metric (VERDICT.md round 1, next-round #1): reads/s through the FULL
pipeline — native BAM decode -> H2D -> device counting step -> device/host
finalize -> all output tables — on a synthetic chr21-scale BAM with a
realistic RNA-seq composition (~30% spliced reads incl. 5% two-gap, 10%
soft-clipped, MAPQ spectrum, 3% secondary records, 5% duplicates; see
irfinder_tpu/io/bamgen.py).  Prints ONE JSON line.

vs_baseline: ratio against the single-thread scalar C++ conformance counter
(native/oracle) run over the identical decoded batch stream — the measured
stand-in for the reference's single-thread C++ counter (BASELINE.md; the
reference snapshot publishes no numbers).  The same line carries the
device-step-only metric (the round-1 headline) as `step_reads_per_s`.

Env knobs: BENCH_PAIRS (default 5M pairs ~= 10.1M records — the 10M-read
point), BENCH_MODE=step for the old step-only bench, BENCH_CACHE for the
generated-BAM cache dir (default: .bench_cache/ in the checkout).
"""

from __future__ import annotations

import json
import os
import sys
import time

CACHE = os.environ.get(
    "BENCH_CACHE", os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")
)
# --smoke / BENCH_SMOKE=1: micro shapes, 1 rep — drives every code path the
# real bench uses so the suite can assert benches run at HEAD (round-4
# verdict #1: committed benches must not be able to break silently)
SMOKE = os.environ.get("BENCH_SMOKE", "") not in ("", "0") or "--smoke" in sys.argv


def _envint(name: str, default: int, smoke: int) -> int:
    v = os.environ.get(name)
    if v is not None:
        return int(v)
    return smoke if SMOKE else default


def _jax():
    import jax

    from irfinder_tpu.backend import init_compile_cache

    init_compile_cache()
    return jax


def _cached_bam(ref, n_pairs: int, seed: int = 0) -> str:
    """Generate (once) and cache the realistic-mix benchmark BAM."""
    from irfinder_tpu.io.bamgen import write_realistic_bam

    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, f"realistic_p{n_pairs}_s{seed}_v2.bam")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        st = write_realistic_bam(path + ".tmp", ref, n_pairs=n_pairs, seed=seed)
        os.replace(path + ".tmp", path)
        print(
            f"[bench] generated {st.n_records} records "
            f"({st.n_spliced} spliced) in {time.perf_counter()-t0:.1f}s -> {path}",
            file=sys.stderr,
        )
    return path


def _oracle_reads_per_s(ref, bam: str) -> float:
    """Single-thread scalar C++ counter over the identical decoded batch
    stream (decode excluded — favorable to the baseline).  0.0 if unbuilt."""
    try:
        from irfinder_tpu.engine import open_decoder
        from irfinder_tpu.native.oracle_native import NativeOracle
    except Exception:
        return 0.0
    try:
        import itertools

        _, batches, _ = open_decoder(ref, bam, use_native=True)
        batches = list(itertools.islice(batches, 64))  # ~4M reads: stable
        n_reads = sum(b.n_reads for b in batches)
        best = float("inf")
        for _ in range(2):
            o = NativeOracle(ref)
            t0 = time.perf_counter()
            for b in batches:
                o.add_batch(b)
            o.finalize()
            best = min(best, time.perf_counter() - t0)
            o.close()
        return n_reads / best if best > 0 else 0.0
    except Exception:
        return 0.0


def _decode_only_reads_per_s(ref, bam: str) -> float:
    """Drain the native decoder with NO counting: the host-ceiling number —
    decode is the one serially-required host stage, so e2e reads/s cannot
    exceed this on the same box (BASELINE.md host-ceiling decomposition)."""
    from irfinder_tpu.engine import open_decoder

    _, batches, stats = open_decoder(ref, bam, use_native=True)
    t0 = time.perf_counter()
    for _ in batches:
        pass
    dt = time.perf_counter() - t0
    return stats.reads_total / dt if dt > 0 else 0.0


def bench_e2e() -> None:
    _jax()
    import shutil
    import tempfile

    from irfinder_tpu.engine import run_bam
    from irfinder_tpu.synth import synth_ref

    n_pairs = _envint("BENCH_PAIRS", 5_000_000, 3_000)
    ref = synth_ref(n_genes=200 if SMOKE else 800)  # chr21-scale: ~14k unique introns
    warm_bam = _cached_bam(ref, n_pairs=2_000 if SMOKE else 50_000, seed=3)
    bam = _cached_bam(ref, n_pairs=n_pairs, seed=0)

    tmp = tempfile.mkdtemp(prefix="irbench_")
    reps = _envint("BENCH_REPS", 3, 1)
    try:
        run_bam(ref, warm_bam, os.path.join(tmp, "warm"))  # compile everything
        dt = float("inf")
        for r in range(reps):  # best-of
            t0 = time.perf_counter()
            metrics = run_bam(ref, bam, os.path.join(tmp, f"out{r}"))
            dt = min(dt, time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reads_per_s = metrics.reads_total / dt

    baseline = _oracle_reads_per_s(ref, warm_bam)
    decode_only = _decode_only_reads_per_s(ref, bam)
    # the oracle measured the SAME way as our e2e (it must pay decode too):
    # serial decode + serial count on one thread
    oracle_e2e = (
        1.0 / (1.0 / baseline + 1.0 / decode_only)
        if baseline and decode_only
        else 0.0
    )
    step = bench_step(ref=ref, quiet=True)
    print(
        json.dumps(
            {
                "metric": "end_to_end_bam_reads_per_s",
                "value": round(reads_per_s, 1),
                "unit": "reads/s",
                "vs_baseline": round(reads_per_s / baseline, 2) if baseline else 0.0,
                "n_reads": metrics.reads_total,
                "wall_s": round(dt, 3),
                "decode_s": round(metrics.decode_s, 3),
                "h2d_s": round(metrics.h2d_s, 3),
                "device_s": round(metrics.device_s, 3),
                "finalize_s": round(metrics.finalize_s, 3),
                "oracle_reads_per_s": round(baseline, 1),
                "oracle_e2e_reads_per_s": round(oracle_e2e, 1),
                "vs_oracle_e2e": round(reads_per_s / oracle_e2e, 2) if oracle_e2e else 0.0,
                "decode_only_reads_per_s": round(decode_only, 1),
                "host_ceiling_fraction": round(reads_per_s / decode_only, 3) if decode_only else 0.0,
                "sync_s": round(metrics.sync_s, 3),
                "step_reads_per_s": round(step, 1),
                "read_mix": "30% spliced / 10% softclip / mapq+dup+secondary",
            }
        )
    )


def bench_step(ref=None, quiet: bool = False) -> float:
    """Device counting step alone on pre-packed, pre-transferred batches
    (the round-1 headline; BASELINE.json:2's kernel metric)."""
    jax = _jax()

    from irfinder_tpu.io.batch import device_batch
    from irfinder_tpu.ops.device_ref import build_device_ref
    from irfinder_tpu.ops.step import init_counters, make_count_step
    from irfinder_tpu.synth import synth_batch_arrays, synth_ref

    n_frags = _envint("BENCH_FRAGS", 1 << 15, 2048)
    n_batches = _envint("BENCH_BATCHES", 16, 2)
    reps = _envint("BENCH_REPS", 3, 1)

    if ref is None:
        ref = synth_ref(n_genes=200 if SMOKE else 800)
    dref = build_device_ref(ref)
    step = make_count_step()

    batches = []
    total_reads = 0
    for i in range(n_batches):
        arrs, n_reads = synth_batch_arrays(ref, n_frags=n_frags, seed=i + 1)
        batches.append({k: jax.device_put(v) for k, v in device_batch(arrs).items()})
        total_reads += n_reads

    counters = init_counters(dref, n_refids=len(ref.chroms))

    def sync(c):
        # steps are data-chained through the donated counters, so one
        # end-of-run barrier bounds the whole stream
        return jax.block_until_ready(c)

    counters = step(dref, counters, batches[0])  # warmup / compile
    sync(counters)

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for b in batches:
            counters = step(dref, counters, b)
        sync(counters)
        best = min(best, time.perf_counter() - t0)
    reads_per_s = total_reads / best
    if not quiet:
        print(
            json.dumps(
                {
                    "metric": "count_step_reads_per_s_per_chip",
                    "value": round(reads_per_s, 1),
                    "unit": "reads/s",
                    "vs_baseline": 0.0,
                }
            )
        )
    return reads_per_s


if __name__ == "__main__":
    if os.environ.get("BENCH_MODE") == "step":
        bench_step()
    else:
        bench_e2e()
