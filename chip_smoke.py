"""On-card smoke test: the BAM -> IR-table path on one NVIDIA GPU.

Run from the root of a checkout on a machine with a card:

    python chip_smoke.py          # phases 0-3 on one card
    python chip_smoke.py --four   # phase 0, then only the dp x genome mesh
                                  # on four cards

Everything runs in this one process (the CLI is called in-process), so only
one process ever opens a card.  Phases run in order; any failure raises, the
script exits non-zero and prints no result line.

  0 setup   print the card (nvidia-smi name and power limit), jax.devices(),
            JAX's version and the compile-cache directory; require the GPU
            backend; build the native libraries from the committed sources.
  1 parity  whole-genome map (bench/config_c.py: 18k genes, ~162k introns,
            ~303M measured bases) and one realistic batch of 32,768
            fragments: the MBS and boundary-point ranks vs a NumPy
            searchsorted truth, one count_step vs np.add.at, and the device
            finalize statistics vs the host _depth_stats_vectorized.
  2 main    `BAM` through cli.main on a realistic BAM over that map: counters
            equal the native C++ oracle on the same decoded batches, the IR
            tables of the device statistics are byte-identical to the host
            statistics path, and the native decoder and formatter ran.
  3 batch   `Batch` through cli.main over 8 chr21-scale samples
            (bench/config_d.py shape): every table byte-identical to a solo
            `BAM` run; the batched lax.map statistics program ran.
  four      run_bam_mesh at dp=4, dp=2 x genome=2 routed, genome=4 and
            genome=4 routed on the whole-genome map: every table set
            byte-identical to a one-card run_bam in this process, and the
            counters spread over 4 distinct devices.

Every device quantity is an int32 counter, so every comparison is exact
equality: no tolerance applies.  Timings are printed for information only,
beside the card's name and power limit.  The last line of standard output
is the JSON result: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: native libraries on the BAM -> tables path
NATIVE = ("bamdecode", "oracle", "tabfmt", "trim")
TABLES = (
    "IRFinder-IR-nondir.txt",
    "IRFinder-IR-dir.txt",
    "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt",
    "IRFinder-ROI.txt",
    "IRFinder-ChrCoverage.txt",
)
#: whole-genome map of bench/config_c.py
WHOLE_GENOME = dict(n_genes=18_000, n_chroms=24, chrom_len=2_000_000_000, seed=0)
#: fragments per device batch (the engine's default cap_frags)
STEP_FRAGS = 1 << 15
#: read pairs of the phase-2 BAM (~2 records each): config C's sample size
MAIN_PAIRS = 25_000_000
#: batch-mode samples and read pairs per sample (chr21-scale map)
BATCH_SAMPLES = 8
BATCH_PAIRS = 250_000
#: read pairs of the four-card BAM
FOUR_PAIRS = 500_000


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--four", action="store_true",
        help="run only the dp x genome mesh phase, on four cards",
    )
    return p


def phases(argv=None) -> list:
    """Phase names in run order for these arguments."""
    if _parser().parse_args(argv).four:
        return ["setup", "four"]
    return ["setup", "parity", "main", "batch"]


def _cli(argv) -> "tuple[int, str]":
    """cli.main in this process -> (exit code, its standard output).  The
    CLI's JSON metrics dump is kept out of the smoke's own output."""
    import contextlib
    import io

    from irfinder_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _same_files(a_dir: str, b_dir: str, names, what: str) -> None:
    for t in names:
        with open(os.path.join(a_dir, t), "rb") as fa, open(os.path.join(b_dir, t), "rb") as fb:
            check(fa.read() == fb.read(), f"{what}: {t} differs")


class _CallCount:
    """Counts the calls of module attributes that returned, while active
    (which decoder and which formatter actually ran)."""

    def __init__(self, targets: dict):
        self.targets = targets  # name -> (module, attr)
        self.n = {k: 0 for k in targets}
        self._saved = []

    def __enter__(self):
        for name, (mod, attr) in self.targets.items():
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _name=name, **k):
                out = _fn(*a, **k)
                self.n[_name] += 1
                return out

            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        return False


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------


def phase_setup(ctx: dict) -> None:
    import jax

    from irfinder_tpu import backend

    cache = backend.init_compile_cache()
    card = backend.gpu_name_power() or "nvidia-smi unavailable"
    print(card, flush=True)
    # one-line form for the timing lines: "4 x <name, limit>" when uniform
    lines = card.splitlines()
    ctx["card"] = (
        lines[0] if len(lines) == 1
        else f"{len(lines)} x {lines[0]}" if len(set(lines)) == 1
        else "; ".join(lines)
    )
    print(f"jax.devices(): {jax.devices()}", flush=True)
    print(f"jax {jax.__version__}", flush=True)
    print(f"compile cache: {cache}", flush=True)
    dev = backend.describe()
    check(dev["platform"] == "gpu", f"JAX found no GPU (platform {dev['platform']!r})")
    if ctx["four"]:
        check(dev["count"] >= 4, f"--four needs 4 cards, JAX sees {dev['count']}")
    ctx["device"] = dev
    for comp in NATIVE:
        d = os.path.join(REPO, "native", comp)
        r = subprocess.run(["make", "-C", d, "-j", "8"], capture_output=True, text=True)
        check(r.returncode == 0, f"make {comp} failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    log(f"built native {', '.join(NATIVE)}")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def _np_chrom_col(seg):
    import numpy as np

    return np.repeat(np.arange(len(seg) - 1, dtype=np.int64), np.diff(seg).astype(np.int64))


def _np_mbs_rank(ref, chrom, pos):
    """Included bases on chrom strictly before pos, as a global MBS offset:
    the last span at or before pos (searchsorted over (chrom, start)) plus
    the clipped overlap; pad lanes (chrom < 0) get the trash rank mbs."""
    import numpy as np

    uc = _np_chrom_col(ref.uspan_seg)
    start = ref.uspan_start.astype(np.int64)
    length = ref.uspan_end.astype(np.int64) - start
    off = ref.uspan_mbs_off.astype(np.int64)
    c = chrom.astype(np.int64)
    p = pos.astype(np.int64)
    j = np.searchsorted(uc * (1 << 32) + start, c * (1 << 32) + p, side="right") - 1
    jj = np.clip(j, 0, None)
    same = (j >= 0) & (uc[jj] == c)
    within = np.clip(p - start[jj], 0, length[jj])
    base = off[ref.uspan_seg[np.clip(c, 0, len(ref.uspan_seg) - 2)]]
    rank = np.where(same, off[jj] + within, base)
    return np.where(c >= 0, rank, int(ref.mbs_size))


def _np_point_rank(ref, chrom, coord, side: str):
    import numpy as np

    pc = _np_chrom_col(ref.point_seg)
    key = pc * (1 << 32) + ref.point_coord.astype(np.int64)
    q = chrom.astype(np.int64) * (1 << 32) + coord.astype(np.int64)
    return np.searchsorted(key, q, side=side)


def _np_count_step(ref, lay, a: dict, lo, hi, plo, phi, n_refids: int):
    """count_step's counter update in NumPy (np.add.at on the flat layout)."""
    import numpy as np

    from irfinder_tpu import semantics as S

    OH = int(S.SPANS_OVERHANG)
    cnt = np.zeros(lay.total, np.int64)
    c, s, e, st = (a[k].astype(np.int64) for k in ("blk_chrom", "blk_start", "blk_end", "blk_strand"))
    dd = lay.off_dd + st * lay.w_dd
    np.add.at(cnt, dd + lo, 1)
    np.add.at(cnt, dd + hi, -1)
    ok = (c >= 0) & (e - s >= 2 * OH)
    pb = lay.off_p + st * lay.w_p
    np.add.at(cnt, pb + np.where(ok, plo, lay.P), 1)
    np.add.at(cnt, pb + np.where(ok, phi, lay.P), -1)
    rc = _np_chrom_col(ref.roi_seg)
    fc, fs, fe, fst = (a[k].astype(np.int64) for k in ("frag_chrom", "frag_start", "frag_end", "frag_strand"))
    ov = (fc[:, None] == rc[None, :]) & (ref.roi_start[None, :] < fe[:, None]) & (fs[:, None] < ref.roi_end[None, :])
    R = lay.R
    cnt[lay.off_roi : lay.off_roi + R] += ov[fst == 0].sum(axis=0)
    cnt[lay.off_roi + R + 1 : lay.off_roi + 2 * R + 1] += ov[fst == 1].sum(axis=0)
    rid = a["frag_refid"].astype(np.int64)
    cnt[lay.off_nf] += int((rid >= 0).sum())
    chrn = np.bincount(
        np.where((rid >= 0) & (rid < n_refids), rid, n_refids), minlength=n_refids + 1
    )
    return cnt, chrn


def _timed(fn, reps: int):
    """Best wall of `reps` calls of fn() (each ends in block_until_ready)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_parity(ctx: dict) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import numpy as np

    from irfinder_tpu import semantics as S
    from irfinder_tpu.engine import open_decoder
    from irfinder_tpu.finalize import _depth_stats_vectorized
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.ops import finalize_stats as FS
    from irfinder_tpu.ops.device_ref import build_device_ref, mbs_rank
    from irfinder_tpu.ops.step import (
        CounterLayout, count_step, init_counters, make_count_step, make_finalize,
    )
    from irfinder_tpu.synth import synth_ref

    t0 = time.perf_counter()
    ref = synth_ref(**WHOLE_GENOME)
    ctx["wg_ref"] = ref
    log(
        f"whole-genome map: {ref.n_introns} introns, {ref.mbs_size} measured "
        f"bases, {ref.uspan_start.size} spans, {ref.point_coord.size} points "
        f"({time.perf_counter() - t0:.1f}s)"
    )
    dref = build_device_ref(ref)
    lay = CounterLayout.build(dref)

    # one realistic batch: the native decoder's first batch of a realistic BAM
    bam = os.path.join(ctx["work"], "parity.bam")
    write_realistic_bam(bam, ref, n_pairs=40_000, seed=1)
    hdr, batches, _ = open_decoder(ref, bam, cap_frags=STEP_FRAGS)
    b = next(batches)
    batches.close()
    n_refids = len(hdr.ref_names)
    a = b.device_arrays()
    log(f"batch: {b.n_frags} fragments, {b.n_blocks} blocks, {b.n_reads} reads")
    check(b.cap_frags == STEP_FRAGS, f"batch cap {b.cap_frags} != {STEP_FRAGS}")

    # ranks vs NumPy searchsorted
    OH = int(S.SPANS_OVERHANG)
    c, s, e = a["blk_chrom"], a["blk_start"], a["blk_end"]
    rank = jax.jit(mbs_rank)
    prank_l = jax.jit(lambda d, c, v: d.point_bt.rank((c, v), side="left"))
    prank_r = jax.jit(lambda d, c, v: d.point_bt.rank((c, v), side="right"))
    lo = _np_mbs_rank(ref, c, s)
    hi = _np_mbs_rank(ref, c, e)
    plo = _np_point_rank(ref, c, s + OH, "left")
    phi = _np_point_rank(ref, c, e - OH, "right")
    for name, got, want in (
        ("mbs_rank(start)", rank(dref, c, s), lo),
        ("mbs_rank(end)", rank(dref, c, e), hi),
        ("point rank left", prank_l(dref, c, s + OH), plo),
        ("point rank right", prank_r(dref, c, e - OH), phi),
    ):
        check(np.array_equal(np.asarray(got), want), f"{name} != NumPy searchsorted")
    log(f"ranks == NumPy searchsorted on {c.size} block lanes")

    # one count_step vs np.add.at
    batch_dev = jax.device_put(a)
    compiled = (
        jax.jit(count_step, donate_argnums=(1,))
        .lower(dref, init_counters(dref, n_refids), batch_dev)
        .compile()
    )
    print(f"count_step memory_analysis: {compiled.memory_analysis()}", flush=True)
    step = make_count_step()
    out = step(dref, init_counters(dref, n_refids), batch_dev)
    want_cnt, want_chr = _np_count_step(ref, lay, a, lo, hi, plo, phi, n_refids)
    check(np.array_equal(np.asarray(out["cnt"]), want_cnt), "count_step cnt != np.add.at")
    check(np.array_equal(np.asarray(out["chr"]), want_chr), "count_step chr != np.add.at")
    log(f"count_step == np.add.at over {lay.total} counters")

    state = {"c": init_counters(dref, n_refids)}

    def run_steps():
        for _ in range(20):
            state["c"] = step(dref, state["c"], batch_dev)
        jax.block_until_ready(state["c"])

    run_steps()
    dt = _timed(run_steps, 3) / 20
    log(
        f"count_step: {dt * 1e3:.3f} ms/batch, {b.n_reads / dt:.0f} reads/s, "
        f"{b.n_frags / dt:.0f} fragments/s ({ctx['card']})"
    )

    # device finalize statistics vs the host path on the same depth
    depth = make_finalize()(dref, out)["depth"]
    t0 = time.perf_counter()
    finref = FS.build_finalize_ref(ref)
    log(f"finalize index tables: {time.perf_counter() - t0:.1f}s host")
    t0 = time.perf_counter()
    got = FS.device_all_stats(ref, finref, depth, False)
    log(f"device stats first call (compile + run): {time.perf_counter() - t0:.1f}s")
    fn = FS._all_stats_fn(finref)
    tables = FS._stats_tables_dev(finref)
    dt = _timed(lambda: jax.block_until_ready(fn(depth, np.int32(0), tables)), 3)
    log(f"device stats program: {dt:.3f} s ({ctx['card']})")
    dt = _timed(lambda: FS.device_all_stats(ref, finref, depth, False), 2)
    log(f"device stats incl. pull + host unpack: {dt:.3f} s")

    d = np.asarray(depth).astype(np.int64)
    ist = ref.intron_strand.astype(np.int64)
    variants = {2: (d[0] + d[1], np.arange(ref.n_introns)), 0: (d[0], np.nonzero(ist == 0)[0]), 1: (d[1], np.nonzero(ist == 1)[0])}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        host = {v: ex.submit(_depth_stats_vectorized, ref, ds) for v, (ds, _) in variants.items()}
        host = {v: f.result() for v, f in host.items()}
    log(f"host _depth_stats_vectorized, 3 variants: {time.perf_counter() - t0:.1f}s")
    names = ("cov", "mean", "p25", "p50", "p75", "firstw", "lastw")
    for v, (_, idx) in variants.items():
        for name, g, w in zip(names, got[v], host[v]):
            check(
                np.array_equal(np.asarray(g)[idx], np.asarray(w)[idx]),
                f"device stats variant {v} {name} != host",
            )
    log("device stats == host _depth_stats_vectorized (3 variants)")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def phase_main(ctx: dict) -> None:
    import numpy as np

    import irfinder_tpu.engine as E
    import irfinder_tpu.native.bamdecode as NB
    import irfinder_tpu.native.tabfmt as TF
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.native.oracle_native import NativeOracle

    ref = ctx["wg_ref"]
    work = ctx["work"]
    refdir = os.path.join(work, "REF")
    ref.save(refdir)
    bam = os.path.join(work, "main.bam")
    t0 = time.perf_counter()
    st = write_realistic_bam(bam, ref, n_pairs=MAIN_PAIRS, seed=0)
    log(f"main BAM: {MAIN_PAIRS} pairs, {st.n_records} records ({time.perf_counter() - t0:.1f}s)")

    out_dev = os.path.join(work, "main_dev")
    calls = _CallCount({
        "native_decoder": (NB, "decode_bam_native"),
        "python_decoder": (E, "decode_bam"),
        "native_formatter": (TF, "format_table"),
    })
    with calls:
        t0 = time.perf_counter()
        rc, _ = _cli(["BAM", "-r", refdir, "-d", out_dev, bam])
        wall = time.perf_counter() - t0
    check(rc == 0, f"cli BAM exited {rc}")
    check(calls.n["native_decoder"] >= 1, "the native decoder did not run")
    check(calls.n["python_decoder"] == 0, "the Python decoder ran")
    # IR nondir/dir, JuncCount and SpansPoint render natively; ROI and
    # ChrCoverage are a few lines each
    check(calls.n["native_formatter"] >= 4, "the native formatter did not render the tables")
    with open(os.path.join(out_dev, "metrics.json")) as fh:
        m = json.load(fh)
    log(
        f"cli BAM: {m['reads_total']} reads in {wall:.2f}s = "
        f"{m['reads_total'] / wall:.0f} reads/s (first run in this process, "
        f"compile included; decode {m['decode_s']:.2f}s, device {m['device_s']:.2f}s, "
        f"finalize {m['finalize_s']:.2f}s) ({ctx['card']})"
    )

    # the same decoded batches through the native oracle and the engine
    hdr, batches, _ = E.open_decoder(ref, bam)
    batches = list(batches)
    nat = NativeOracle(ref, n_refids=len(hdr.ref_names))
    t0 = time.perf_counter()
    for b in batches:
        nat.add_batch(b)
    want = nat.finalize()
    nat.close()
    log(f"native oracle: {time.perf_counter() - t0:.1f}s")
    eng = E.Engine(ref)
    eng._device_stats = False  # pull the raw depth: the host statistics path
    eng.reset(n_refids=len(hdr.ref_names))
    eng.run_stream(batches)
    fc = eng.counters_host()
    for k in ("depth", "start_cnt", "end_cnt", "exact_cnt", "span_hits", "roi_cnt", "chr_frag"):
        check(np.array_equal(np.asarray(fc[k]), want[k]), f"counter {k} != native oracle")
    check(int(fc["n_frags"]) == int(want["n_frags"]) == m["fragments"], "fragment totals differ")
    log(f"counters == native oracle ({int(want['n_frags'])} fragments)")

    out_host = os.path.join(work, "main_host")
    t0 = time.perf_counter()
    res = eng.results(fc)
    E.write_outputs(out_host, ref, hdr, eng, res)
    log(f"host statistics path: {time.perf_counter() - t0:.1f}s")
    _same_files(out_dev, out_host, TABLES, "device vs host statistics")
    log("tables from device statistics == host statistics path (byte-identical)")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def phase_batch(ctx: dict) -> None:
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.ops import finalize_stats as FS
    from irfinder_tpu.synth import synth_ref

    work = ctx["work"]
    ref = synth_ref(n_genes=800)  # chr21-scale map of bench/config_d.py
    refdir = os.path.join(work, "REF_D")
    ref.save(refdir)
    bams = []
    t0 = time.perf_counter()
    for i in range(BATCH_SAMPLES):
        p = os.path.join(work, f"s{i}.bam")
        write_realistic_bam(p, ref, n_pairs=BATCH_PAIRS, seed=1000 + i)
        bams.append(p)
    log(f"batch BAMs: {BATCH_SAMPLES} x {BATCH_PAIRS} pairs ({time.perf_counter() - t0:.1f}s)")
    out = os.path.join(work, "batch")
    calls = _CallCount({"batched_stats": (FS, "device_all_stats_multi_async")})
    with calls:
        t0 = time.perf_counter()
        rc, stdout = _cli(["Batch", "-r", refdir, "-d", out, *bams])
        wall = time.perf_counter() - t0
    check(rc == 0, f"cli Batch exited {rc}")
    check(calls.n["batched_stats"] == 1, "the batched lax.map statistics program did not run")
    m0 = json.loads(stdout)["s0"]
    log(
        f"cli Batch: {BATCH_SAMPLES} samples in {wall:.2f}s (first run of this "
        f"map, compile included; stream {m0['multi_stream_s']:.2f}s, finalize "
        f"{m0['multi_finalize_s']:.2f}s) ({ctx['card']})"
    )
    for i, p in enumerate(bams):
        solo = os.path.join(work, f"solo{i}")
        check(_cli(["BAM", "-r", refdir, "-d", solo, p])[0] == 0, f"solo BAM {i} failed")
        _same_files(os.path.join(out, f"s{i}"), solo, TABLES, f"batch vs solo sample {i}")
    log(f"batch tables == solo runs for all {BATCH_SAMPLES} samples")


# ---------------------------------------------------------------------------
# --four
# ---------------------------------------------------------------------------


def phase_four(ctx: dict) -> None:
    from irfinder_tpu import engine_mesh as EM
    from irfinder_tpu.engine import run_bam
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    work = ctx["work"]
    t0 = time.perf_counter()
    ref = synth_ref(**WHOLE_GENOME)
    log(f"whole-genome map: {ref.n_introns} introns ({time.perf_counter() - t0:.1f}s)")
    bam = os.path.join(work, "four.bam")
    st = write_realistic_bam(bam, ref, n_pairs=FOUR_PAIRS, seed=4)
    log(f"BAM: {FOUR_PAIRS} pairs, {st.n_records} records")
    one = os.path.join(work, "one_card")
    t0 = time.perf_counter()
    run_bam(ref, bam, one)
    log(f"one-card run_bam: {time.perf_counter() - t0:.1f}s")

    seen = []
    real_results = EM.MeshEngine.results_async

    def recording(self, st):
        seen.append(len(st.counters["cnt"].sharding.device_set))
        return real_results(self, st)

    EM.MeshEngine.results_async = recording
    try:
        for name, spec in (
            ("dp=4", EM.MeshSpec(dp=4)),
            ("dp=2,genome=2,routed", EM.MeshSpec(dp=2, genome=2, routed=True)),
            ("dp=1,genome=4", EM.MeshSpec(dp=1, genome=4)),
            ("dp=1,genome=4,routed", EM.MeshSpec(dp=1, genome=4, routed=True)),
        ):
            out = os.path.join(work, name.replace(",", "_").replace("=", ""))
            t0 = time.perf_counter()
            m = EM.run_bam_mesh(ref, bam, out, spec)
            dt = time.perf_counter() - t0
            check(seen and seen[-1] == 4, f"{name}: counters on {seen[-1:]} devices, not 4")
            _same_files(out, one, TABLES + ("WARNINGS",), f"mesh {name} vs one card")
            log(
                f"mesh {name}: tables == one card; counters on 4 devices; "
                f"{dt:.1f}s, {m.reads_total} reads ({ctx['card']})"
            )
    finally:
        EM.MeshEngine.results_async = real_results


PHASES = {
    "setup": phase_setup,
    "parity": phase_parity,
    "main": phase_main,
    "batch": phase_batch,
    "four": phase_four,
}


def main(argv=None) -> int:
    names = phases(argv)
    ctx = {"four": "four" in names}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        ctx["work"] = work
        for name in names:
            t0 = time.perf_counter()
            log(f"phase {name}")
            PHASES[name](ctx)
            log(f"phase {name} ok ({time.perf_counter() - t0:.1f}s)")
    print(json.dumps({"ok": True, "device": ctx["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"[chip_smoke] FAILED: {e}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
