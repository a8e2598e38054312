"""Multi-sample batch mode (engine.run_multi_bam + CLI Batch): concurrent
streams must reproduce single-sample runs byte-for-byte, and the pooled
differential path must run end-to-end (BASELINE config D; SURVEY.md §2 row 19).
"""

import io
import os

import pytest

from irfinder_tpu.engine import run_bam, run_multi_bam
from irfinder_tpu.refio.compile import compile_reference

from test_oracle import CHROMS, CHROM_INDEX, ROIS, random_bam_bytes, toy_exons

TABLES = (
    "IRFinder-IR-nondir.txt",
    "IRFinder-IR-dir.txt",
    "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt",
    "IRFinder-ROI.txt",
    "IRFinder-ChrCoverage.txt",
)


@pytest.fixture(scope="module")
def ref():
    return compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)


def test_multi_bam_matches_single_runs(tmp_path, ref):
    paths = []
    for i in range(4):
        p = tmp_path / f"s{i}.bam"
        p.write_bytes(random_bam_bytes(seed=100 + i, n_frags=150 + 30 * i))
        paths.append(str(p))

    multi_dirs = [str(tmp_path / "multi" / f"s{i}") for i in range(4)]
    metrics = run_multi_bam(ref, paths, multi_dirs)
    assert len(metrics) == 4
    assert all(m.fragments > 0 for m in metrics)

    for i, p in enumerate(paths):
        solo = str(tmp_path / "solo" / f"s{i}")
        run_bam(ref, p, solo)
        for t in TABLES:
            a = open(os.path.join(multi_dirs[i], t)).read()
            b = open(os.path.join(solo, t)).read()
            assert a == b, f"sample {i} table {t} differs between batch and solo"


def test_cli_batch_with_differential(tmp_path, ref):
    refdir = tmp_path / "REF"
    ref.save(str(refdir))
    paths = []
    for i in range(4):
        p = tmp_path / f"c{i}.bam"
        p.write_bytes(random_bam_bytes(seed=7 + i, n_frags=120))
        paths.append(str(p))

    from irfinder_tpu.cli import main

    out = tmp_path / "BATCH"
    rc = main(
        [
            "Batch",
            "-r",
            str(refdir),
            "-d",
            str(out),
            *paths,
            "--a",
            "0,1",
            "--b",
            "2,3",
        ]
    )
    assert rc == 0
    for i in range(4):
        assert (out / f"c{i}" / "IRFinder-IR-nondir.txt").exists()
    diff_table = (out / "IRFinder-Diff.txt").read_text()
    assert diff_table.startswith("Chr\t") or "\t" in diff_table.splitlines()[0]


def test_multi_bam_batched_device_stats_matches_single(tmp_path, ref, monkeypatch):
    """The BATCHED finalize path (results_multi_async: one lax.map stats
    program + one concatenated small-counter pull) must reproduce solo runs
    byte-for-byte.  IRTPU_DEVICE_STATS=1 engages it on the CPU (the same
    XLA program the GPU runs by default)."""
    monkeypatch.setenv("IRTPU_DEVICE_STATS", "1")
    paths = []
    for i in range(3):
        p = tmp_path / f"b{i}.bam"
        p.write_bytes(random_bam_bytes(seed=300 + i, n_frags=140 + 20 * i))
        paths.append(str(p))
    multi_dirs = [str(tmp_path / "bmulti" / f"s{i}") for i in range(3)]
    run_multi_bam(ref, paths, multi_dirs)
    for i, p in enumerate(paths):
        solo = str(tmp_path / "bsolo" / f"s{i}")
        run_bam(ref, p, solo)
        for t in TABLES:
            a = open(os.path.join(multi_dirs[i], t)).read()
            b = open(os.path.join(solo, t)).read()
            assert a == b, f"sample {i} table {t}: batched finalize diverged"
