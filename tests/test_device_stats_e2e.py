"""End-to-end parity of the device-side finalize path.

On the GPU the engine computes per-intron depth statistics on device
(ops/finalize_stats.py) instead of pulling the O(mbs) depth array.  Forcing
that same XLA program on the CPU backend (IRTPU_DEVICE_STATS=1) must produce
byte-identical output tables to the host finalize — the reference path the
CPU keeps by default.  The device computes only int32 counts, so the tables
must match byte for byte: no tolerance applies."""

import pytest

from irfinder_tpu.engine import run_bam
from irfinder_tpu.refio.compile import compile_reference

from test_oracle import CHROMS, ROIS, random_bam_bytes, toy_exons

TABLES = [
    "IRFinder-IR-nondir.txt",
    "IRFinder-IR-dir.txt",
    "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt",
    "IRFinder-ROI.txt",
    "IRFinder-ChrCoverage.txt",
]


def _assert_same_tables(a_dir, b_dir):
    for t in TABLES:
        a = (a_dir / t).read_text()
        b = (b_dir / t).read_text()
        assert a == b, f"{t} differs between host and device finalize"


def test_device_stats_path_matches_host(tmp_path, monkeypatch):
    ref = compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)
    bam = tmp_path / "in.bam"
    bam.write_bytes(random_bam_bytes(seed=23, n_frags=300))

    run_bam(ref, str(bam), str(tmp_path / "host"), use_native=False)
    # the flag is read at Engine construction
    monkeypatch.setenv("IRTPU_DEVICE_STATS", "1")
    run_bam(ref, str(bam), str(tmp_path / "dev"), use_native=False)
    _assert_same_tables(tmp_path / "host", tmp_path / "dev")


@pytest.mark.parametrize("stranded", [False, True], ids=["unstranded", "stranded"])
def test_device_stats_realistic_library(tmp_path, monkeypatch, stranded):
    """Realistic-mix BAMs of both library kinds: the stranded one takes the
    directional-table path through its own annotation-strand subsets."""
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=40)
    bam = str(tmp_path / "r.bam")
    write_realistic_bam(bam, ref, n_pairs=6000, seed=21, stranded=stranded)
    m_host = run_bam(ref, bam, str(tmp_path / "host"))
    monkeypatch.setenv("IRTPU_DEVICE_STATS", "1")
    m_dev = run_bam(ref, bam, str(tmp_path / "dev"))
    assert m_host.is_stranded == m_dev.is_stranded == stranded
    _assert_same_tables(tmp_path / "host", tmp_path / "dev")
