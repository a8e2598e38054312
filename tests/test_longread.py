"""Long-read spliced alignments (late-reference long-read mode, SURVEY.md §2
row 1 [R:verify]): a single read with O(100) exon blocks flows through both
decoders and the engine mechanically — the block/gap model and the 4096-block
batch floor admit it without a special mode; counters match the oracle."""

import io

import numpy as np
import pytest

from irfinder_tpu.engine import Engine
from irfinder_tpu.io import bamwrite
from irfinder_tpu.io.bampy import decode_bam
from irfinder_tpu.oracle import OracleCounters
from irfinder_tpu.synth import synth_ref


def _longread_bam(ref, n_exons=120, n_reads=8):
    """Reads with n_exons aligned blocks each (a full-length transcript
    alignment, nanopore/pacbio style): 100M + N-gap ladders.  The FIRST gap
    of each read lands exactly on an annotated intron (SpliceExact hit);
    the rest are novel junctions."""
    recs = []
    for r in range(n_reads):
        k = r * 3
        istart, iend = int(ref.intron_start[k]), int(ref.intron_end[k])
        chrom = int(ref.intron_chrom[k])
        base = istart - 100
        cig = [(100, "M"), (iend - istart, "N")]
        for _ in range(n_exons - 1):
            cig.append((100, "M"))
            cig.append((500, "N"))
        cig.append((100, "M"))
        cigar = "".join(f"{ln}{op}" for ln, op in cig)
        recs.append(bamwrite.make_single(f"lr{r}", chrom, base, cigar, mapq=60))
    buf = io.BytesIO()
    bamwrite.write_bam(buf, ref.chroms, [2_000_000_000] * len(ref.chroms), recs)
    return buf.getvalue()


def test_longread_through_engine():
    ref = synth_ref(n_genes=400)
    bam = _longread_bam(ref)
    ci = {c: i for i, c in enumerate(ref.chroms)}

    _, batches, stats = decode_bam(io.BytesIO(bam), ci, cap_frags=64)
    batches = list(batches)
    assert stats.reads_total == 8
    n_blocks = sum(b.n_blocks for b in batches)
    n_gaps = sum(b.n_gaps for b in batches)
    assert n_blocks > 8 * 50, "long reads should decode to many blocks"
    assert n_gaps > 8 * 50

    orc = OracleCounters.create(ref)
    for b in batches:
        orc.add_batch(b)

    eng = Engine(ref, cap_frags=64)
    eng._device_stats = False
    eng.reset(n_refids=len(ref.chroms))
    _, batches2, _ = decode_bam(io.BytesIO(bam), ci, cap_frags=64)
    eng.run_stream(batches2)
    fc = eng.counters_host()
    np.testing.assert_array_equal(np.asarray(fc["depth"]), orc.depth)
    np.testing.assert_array_equal(fc["exact_cnt"], orc.exact_cnt)
    np.testing.assert_array_equal(fc["span_hits"], orc.span_hits)
    # each read's first gap lands exactly on its annotated intron
    assert orc.exact_cnt.sum() == 8


def test_longread_native_parity(tmp_path):
    ref = synth_ref(n_genes=400)
    bam = _longread_bam(ref)
    path = str(tmp_path / "lr.bam")
    open(path, "wb").write(bam)
    ci = {c: i for i, c in enumerate(ref.chroms)}
    _, pb, _ = decode_bam(io.BytesIO(bam), ci, cap_frags=64)
    py = list(pb)
    try:
        from irfinder_tpu.native.bamdecode import decode_bam_native
    except Exception:
        pytest.skip("native decoder unavailable")
    _, nb, _ = decode_bam_native(path, ci, cap_frags=64)
    nat = list(nb)
    assert len(py) == len(nat)
    for a, b in zip(py, nat):
        for k in ("blk_chrom", "blk_start", "blk_end", "gap_start", "gap_end"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_longread_surface_cli_geometry(tmp_path):
    """--long-reads (RunConfig.long_reads) on an ONT/PacBio-shaped BAM
    (io/bamgen.write_longread_bam: 16-96 exon blocks, 10-100kb spans):
    geometry-rebalanced batches through the NATIVE decoder (bd_open_ex2),
    tables byte-identical to the default-geometry run."""
    import filecmp
    import os

    from irfinder_tpu.config import RunConfig
    from irfinder_tpu.engine import open_decoder, run_bam
    from irfinder_tpu.io.bamgen import write_longread_bam
    from irfinder_tpu.io.batch import LONGREAD_BLOCKS_PER_FRAG

    ref = synth_ref(n_genes=300, n_chroms=3, chrom_len=50_000_000, seed=2)
    bam = str(tmp_path / "ont.bam")
    st = write_longread_bam(bam, ref, n_reads=2500, seed=4)
    assert st.n_records == 2500

    # geometry assertion on the decoder surface (native path)
    _, batches, _ = open_decoder(ref, bam, cap_frags=256, long_reads=True)
    first = next(iter(batches))
    assert first.cap_blocks >= 256 * LONGREAD_BLOCKS_PER_FRAG
    assert first.n_blocks > first.n_frags * 10, "many blocks per fragment"

    out0 = str(tmp_path / "default")
    out1 = str(tmp_path / "longreads")
    m0 = run_bam(ref, bam, out0, cap_frags=2048)
    m1 = run_bam(ref, bam, out1, config=RunConfig(cap_frags=2048, long_reads=True))
    assert m1.fragments == m0.fragments == 2500
    assert m1.batches < m0.batches, "wider blocks columns -> fewer batches"
    for t in (
        "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt",
        "IRFinder-JuncCount.txt", "IRFinder-SpansPoint.txt",
        "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    ):
        assert filecmp.cmp(
            os.path.join(out0, t), os.path.join(out1, t), shallow=False
        ), t
