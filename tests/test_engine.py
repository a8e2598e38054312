"""Device engine vs NumPy oracle: bit-exact counter equivalence.

The contract from SURVEY.md §7.2 step 4: every device counter must equal the
oracle's on identical PackedBatch streams, for random reads, any batch
capacity, and any interleaving.  Also unit-fuzzes the lexicographic binary
search and the device MBS rank against NumPy ground truth.
"""

import io

import numpy as np
import pytest

from irfinder_tpu.engine import Engine, run_bam
from irfinder_tpu.io.bampy import decode_bam
from irfinder_tpu.oracle import OracleCounters, intron_rows, mbs_rank
from irfinder_tpu.ops.device_ref import build_device_ref, mbs_rank as dev_mbs_rank
from irfinder_tpu.ops.search import searchsorted_lex
from irfinder_tpu.refio.compile import compile_reference

from test_oracle import CHROM_INDEX, CHROMS, ROIS, random_bam_bytes, toy_exons


@pytest.fixture(scope="module")
def ref():
    return compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)


def test_searchsorted_lex_fuzz():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(0, 200))
        q = int(rng.integers(1, 300))
        hi = np.sort(rng.integers(0, 5, n)).astype(np.int32)
        lo = np.zeros(n, dtype=np.int32)
        for c in np.unique(hi):
            m = hi == c
            lo[m] = np.sort(rng.integers(0, 50, m.sum()))
        qhi = rng.integers(-1, 6, q).astype(np.int32)
        qlo = rng.integers(-5, 55, q).astype(np.int32)
        key = hi.astype(np.int64) * 1000 + lo
        qk = qhi.astype(np.int64) * 1000 + qlo
        for side in ("left", "right"):
            got = np.asarray(searchsorted_lex((hi, lo), (qhi, qlo), side=side))
            want = np.searchsorted(key, qk, side=side)
            np.testing.assert_array_equal(got, want, err_msg=f"trial={trial} side={side}")


def test_device_mbs_rank_matches_oracle(ref):
    dref = build_device_ref(ref)
    rng = np.random.default_rng(1)
    chrom = rng.integers(-1, len(CHROMS), 500).astype(np.int32)
    pos = rng.integers(0, 3000, 500).astype(np.int32)
    got = np.asarray(dev_mbs_rank(dref, chrom, pos))
    want = mbs_rank(ref, chrom, pos)
    np.testing.assert_array_equal(got, want)


def _oracle_counters(ref, bam, cap=1 << 15):
    _, batches, _ = decode_bam(io.BytesIO(bam), CHROM_INDEX, cap_frags=cap)
    c = OracleCounters.create(ref)
    for b in batches:
        c.add_batch(b)
    return c


def _engine_counters(ref, bam, cap=1 << 15):
    hdr, batches, _ = decode_bam(io.BytesIO(bam), CHROM_INDEX, cap_frags=cap)
    eng = Engine(ref, cap_frags=cap)
    eng.reset(n_refids=len(hdr.ref_names))
    eng.run_stream(batches)
    return eng, eng.counters_host()


@pytest.mark.parametrize("seed", [0, 7])
def test_engine_counters_match_oracle(ref, seed):
    bam = random_bam_bytes(seed=seed, n_frags=250)
    orc = _oracle_counters(ref, bam)
    eng, fc = _engine_counters(ref, bam)
    np.testing.assert_array_equal(fc["depth"], orc.depth)
    np.testing.assert_array_equal(fc["start_cnt"], orc.start_cnt)
    np.testing.assert_array_equal(fc["end_cnt"], orc.end_cnt)
    np.testing.assert_array_equal(fc["exact_cnt"], orc.exact_cnt)
    np.testing.assert_array_equal(fc["span_hits"], orc.span_hits)
    np.testing.assert_array_equal(fc["roi_cnt"], orc.roi_cnt)
    assert int(fc["n_frags"]) == orc.n_frags
    for rid, n in orc.chr_frag.items():
        assert int(fc["chr_frag"][rid]) == n


def test_engine_rows_match_oracle(ref):
    bam = random_bam_bytes(seed=2, n_frags=250)
    orc = _oracle_counters(ref, bam)
    eng, fc = _engine_counters(ref, bam)
    res = eng.results(fc)
    for mode, flip in (("nondir", False), ("dir", False), ("dir", True)):
        want = intron_rows(orc, mode=mode, flip_strand=flip)
        got = eng.results(fc)[f"rows_{mode}"] if not flip else None
        # compare via the shared finalize directly for the flip case
        from irfinder_tpu.finalize import intron_rows as fin_rows

        got = fin_rows(
            ref, fc["depth"], fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"],
            fc["span_hits"], mode=mode, flip_strand=flip,
        )
        assert got == want


def test_engine_batch_capacity_invariance(ref):
    bam = random_bam_bytes(seed=5, n_frags=120)
    _, a = _engine_counters(ref, bam, cap=1 << 15)
    _, b = _engine_counters(ref, bam, cap=9)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_run_bam_end_to_end(ref, tmp_path):
    bam = random_bam_bytes(seed=6, n_frags=150)
    metrics = run_bam(ref, io.BytesIO(bam), str(tmp_path))
    produced = sorted(p.name for p in tmp_path.iterdir())
    assert produced == [
        "IRFinder-ChrCoverage.txt",
        "IRFinder-IR-dir.txt",
        "IRFinder-IR-nondir.txt",
        "IRFinder-JuncCount.txt",
        "IRFinder-ROI.txt",
        "IRFinder-SpansPoint.txt",
        "WARNINGS",
        "metrics.json",
    ]
    ir = (tmp_path / "IRFinder-IR-nondir.txt").read_text().splitlines()
    assert ir[0].startswith("Chr\tStart\tEnd\tName\tNull\tStrand")
    assert len(ir) == 1 + ref.n_introns
    assert metrics.fragments > 0 and metrics.batches >= 1
    # JuncCount totals equal oracle junction-boundary hits where annotated
    orc = _oracle_counters(ref, bam)
    jc = (tmp_path / "IRFinder-JuncCount.txt").read_text().splitlines()[1:]
    tally = {}
    for line in jc:
        c, s, e, fwd, rev, tot = line.split("\t")
        tally[(CHROM_INDEX[c], int(s), int(e))] = int(tot)
    for i in range(ref.upair_start.size):
        c = int(np.searchsorted(ref.upair_seg, i, side="right")) - 1
        key = (c, int(ref.upair_start[i]), int(ref.upair_end[i]))
        assert tally.get(key, 0) == int(orc.exact_cnt[:, i].sum())


def test_inflight_bound_barrier_equality(tmp_path, monkeypatch):
    """The consumer's in-flight byte bound (engine.INFLIGHT_BYTES) blocks on
    the counters mid-stream; a tiny bound (a barrier after every batch) and
    checkpoint snapshots must leave the table set byte-identical."""
    from irfinder_tpu import engine as E
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=30)
    bam = str(tmp_path / "d.bam")
    write_realistic_bam(bam, ref, n_pairs=8000, seed=9)
    m0 = E.run_bam(ref, bam, str(tmp_path / "plain"), cap_frags=1024)

    monkeypatch.setattr(E, "INFLIGHT_BYTES", 1)
    m1 = E.run_bam(ref, bam, str(tmp_path / "bounded"), cap_frags=1024)
    E.run_bam(
        ref, bam, str(tmp_path / "bounded_ck"), cap_frags=1024,
        checkpoint=str(tmp_path / "ck.snap"), checkpoint_every=2,
    )
    for t in (
        "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt",
        "IRFinder-JuncCount.txt", "IRFinder-SpansPoint.txt",
        "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    ):
        a = (tmp_path / "plain" / t).read_bytes()
        assert a == (tmp_path / "bounded" / t).read_bytes(), t
        assert a == (tmp_path / "bounded_ck" / t).read_bytes(), t
    assert m1.batches == m0.batches > 1
    assert m1.sync_s > 0.0


def test_full_column_batch_still_flows():
    """An all-padding batch streams through and counts as a batch."""
    from irfinder_tpu.io.batch import PackedBatch
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=20)
    eng = Engine(ref)
    eng.reset(n_refids=len(ref.chroms))
    b = PackedBatch.empty(96, 32, 32)
    b.n_frags = b.n_blocks = 0
    eng.run_stream([b])
    assert eng.metrics.batches == 1


def test_native_decoder_fallback_warns(ref, tmp_path, monkeypatch, capsys):
    """When the native decoder cannot load, open_decoder still decodes (the
    Python decoder gives the same batches) but says so on stderr."""
    import irfinder_tpu.native.bamdecode as NB
    from irfinder_tpu.engine import open_decoder

    def broken(*a, **k):
        raise RuntimeError("native build failed for bamdecode")

    monkeypatch.setattr(NB, "decode_bam_native", broken)
    bam = tmp_path / "w.bam"
    bam.write_bytes(random_bam_bytes(seed=4, n_frags=60))
    _, batches, stats = open_decoder(ref, str(bam))
    assert sum(b.n_frags for b in batches) > 0
    err = capsys.readouterr().err
    assert "native BAM decoder unavailable" in err and "Python decoder" in err


def test_consumer_error_propagates_without_hanging(tmp_path, monkeypatch):
    """A consumer-side failure mid-stream must propagate promptly (the
    three-stage pipeline's feeders must never block forever on a queue once
    the consumer is gone — stop-aware puts/gets everywhere)."""
    import time as _time

    from irfinder_tpu import engine as E
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=30)
    bam = str(tmp_path / "h.bam")
    write_realistic_bam(bam, ref, n_pairs=20000, seed=13)
    eng = E.Engine(ref)
    hdr, batches, _ = E.open_decoder(ref, bam, cap_frags=256)
    eng.reset(n_refids=len(hdr.ref_names))

    class Boom(Exception):
        pass

    calls = {"n": 0}

    def on_batch(done):
        calls["n"] += 1
        if calls["n"] == 3:
            raise Boom()

    t0 = _time.monotonic()
    with pytest.raises(Boom):
        eng.run_stream(batches, on_batch=on_batch)
    assert _time.monotonic() - t0 < 30, "run_stream hung after consumer error"


def test_whole_genome_span_table_unbinned_matches_oracle(tmp_path):
    """A span table of whole-genome size (~144k measured-base spans, as the
    162k-intron human map has) runs through run_bam on one device, unbinned,
    and every counter equals the NumPy oracle's.  Introns are kept short so
    the measured-base space (and the test) stays small."""
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.refio.gtf import Exon

    rng = np.random.default_rng(0)
    exons = []
    for g in range(18_000):
        chrom, strand, gid = f"c{g % 24}", "+-"[g % 2], f"G{g:05d}"
        pos = 1000 + (g // 24) * 2000
        for k in range(9):
            elen = int(rng.integers(30, 80))
            exons.append(Exon(chrom, pos, pos + elen, strand, gid, gid, f"{gid}.t1"))
            pos += elen + int(rng.integers(20, 60))
    big = compile_reference(exons)
    assert big.uspan_start.size >= 140_000 and big.mbs_size < 20_000_000

    bam = str(tmp_path / "wg.bam")
    write_realistic_bam(bam, big, n_pairs=3000, seed=5)
    m = run_bam(big, bam, str(tmp_path / "out"))
    ir = (tmp_path / "out" / "IRFinder-IR-nondir.txt").read_text().splitlines()
    assert len(ir) == 1 + big.n_introns

    from irfinder_tpu.engine import open_decoder

    _, batches, _ = open_decoder(big, bam)
    batches = list(batches)
    orc = OracleCounters.create(big)
    for b in batches:
        orc.add_batch(b)
    eng = Engine(big)
    eng.reset(n_refids=len(big.chroms))
    eng.run_stream(batches)
    fc = eng.counters_host()
    assert int(fc["n_frags"]) == orc.n_frags == m.fragments > 0
    for k in ("depth", "start_cnt", "end_cnt", "exact_cnt", "span_hits", "roi_cnt"):
        np.testing.assert_array_equal(np.asarray(fc[k]), getattr(orc, k), err_msg=k)
