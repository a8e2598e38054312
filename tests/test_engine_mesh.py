"""The mesh-wired end-to-end pipeline (engine_mesh.run_bam_mesh) must write
the FULL output table set byte-identical to the unsharded engine.run_bam on
the same BAM — the round-2 verdict's top directive: config E as a runnable
pipeline, not a parts bin (SURVEY.md §5.7-5.8, BASELINE.json:11)."""

import filecmp
import io
import os

import pytest

from irfinder_tpu.engine import run_bam
from irfinder_tpu.engine_mesh import MeshSpec, run_bam_mesh
from irfinder_tpu.refio.compile import compile_reference

from test_oracle import CHROMS, ROIS, random_bam_bytes, toy_exons

TABLES = [
    "IRFinder-IR-nondir.txt",
    "IRFinder-IR-dir.txt",
    "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt",
    "IRFinder-ROI.txt",
    "IRFinder-ChrCoverage.txt",
    "WARNINGS",
]


@pytest.fixture(scope="module")
def ref():
    return compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)


@pytest.fixture(scope="module")
def bam_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("meshbam") / "in.bam"
    p.write_bytes(random_bam_bytes(seed=31, n_frags=400))
    return str(p)


@pytest.fixture(scope="module")
def unsharded_out(ref, bam_path, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("unsharded"))
    run_bam(ref, bam_path, out, use_native=False)
    return out


def assert_tables_equal(got_dir: str, want_dir: str):
    for t in TABLES:
        got, want = os.path.join(got_dir, t), os.path.join(want_dir, t)
        assert os.path.exists(got), f"missing {t}"
        assert filecmp.cmp(got, want, shallow=False), f"table {t} differs"


@pytest.mark.parametrize(
    "spec",
    [
        MeshSpec(dp=8, genome=1),
        MeshSpec(dp=2, genome=4),
        MeshSpec(dp=2, genome=4, routed=True),
        MeshSpec(dp=4, genome=2, routed=True),
    ],
    ids=["dp8", "dp2xg4", "dp2xg4-routed", "dp4xg2-routed"],
)
def test_mesh_pipeline_tables_byte_identical(ref, bam_path, unsharded_out, tmp_path, spec):
    out = str(tmp_path / "mesh")
    m = run_bam_mesh(ref, bam_path, out, spec, use_native=False)
    assert m.fragments > 0
    assert_tables_equal(out, unsharded_out)


def test_binned_single_device_tables_byte_identical(ref, bam_path, unsharded_out, tmp_path):
    """genome=G with one device: the lax.map binned form."""
    import jax

    out = str(tmp_path / "binned")
    spec = MeshSpec(dp=1, genome=4)
    m = run_bam_mesh(
        ref, bam_path, out, spec, devices=jax.devices()[:1], use_native=False
    )
    assert m.fragments > 0
    assert_tables_equal(out, unsharded_out)


@pytest.mark.slow
def test_mesh_pipeline_realistic_scale(tmp_path):
    """Scale-realistic correctness (round-2 verdict next-round #5): a
    realistic-mix BAM (spliced/soft-clipped/MAPQ-spectrum/secondary/dup
    records, io/bamgen.py) at chr21-like table scale, streamed in multiple
    batches through the composed ROUTED dp x genome mesh on the virtual
    8-device fleet — tables must come out byte-identical to the unsharded
    engine.  Exercises routing-cell cap growth, pad rows, and mate carry
    across batch boundaries at non-toy shapes."""
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=1200, n_chroms=8, chrom_len=40_000_000, seed=5)
    bam = str(tmp_path / "realistic.bam")
    write_realistic_bam(bam, ref, n_pairs=120_000, seed=11)

    out0 = str(tmp_path / "unsharded")
    m0 = run_bam(ref, bam, out0, cap_frags=1 << 14)
    assert m0.batches > 3, "want a multi-batch stream for this test"

    out1 = str(tmp_path / "routed")
    spec = MeshSpec(dp=2, genome=4, routed=True)
    m1 = run_bam_mesh(ref, bam, out1, spec, cap_frags=1 << 14)
    assert m1.fragments == m0.fragments
    assert_tables_equal(out1, out0)


def test_mesh_spec_parse():
    assert MeshSpec.parse("dp=2,genome=4,routed") == MeshSpec(2, 4, True)
    assert MeshSpec.parse("dp=8") == MeshSpec(8, 1, False)
    assert MeshSpec.parse("genome=8") == MeshSpec(1, 8, False)
    with pytest.raises(ValueError):
        MeshSpec.parse("tp=2")


def test_binned_wire_deferred_equality(tmp_path):
    """The explicit single-device binned form (genome=4 on one device) on a
    realistic-mix BAM with the native decoder must match the unsharded
    run_bam byte for byte."""
    from irfinder_tpu import engine as E
    from irfinder_tpu.engine_mesh import MeshSpec, run_bam_mesh
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=30)
    bam = str(tmp_path / "bw.bam")
    write_realistic_bam(bam, ref, n_pairs=6000, seed=11)
    import jax

    E.run_bam(ref, bam, str(tmp_path / "eager"))
    run_bam_mesh(
        ref, bam, str(tmp_path / "binned"), MeshSpec(dp=1, genome=4),
        devices=jax.devices()[:1],
    )
    for t in (
        "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt",
        "IRFinder-JuncCount.txt", "IRFinder-SpansPoint.txt",
        "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    ):
        assert (tmp_path / "eager" / t).read_bytes() == (
            tmp_path / "binned" / t
        ).read_bytes(), t


def test_binned_wire_deferred_checkpoint_resume(tmp_path, monkeypatch):
    """Checkpointed binned runs with a barrier after every batch (tiny
    in-flight bound): a run interrupted after its first snapshot resumes
    from it and completes byte-identically."""
    from irfinder_tpu import engine as E
    from irfinder_tpu.checkpoint import load_checkpoint
    from irfinder_tpu.engine_mesh import MeshSpec, run_bam_mesh
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=30)
    bam = str(tmp_path / "ck.bam")
    write_realistic_bam(bam, ref, n_pairs=20000, seed=17)
    E.run_bam(ref, bam, str(tmp_path / "plain"))

    import jax

    import irfinder_tpu.engine_mesh as EM

    monkeypatch.setattr(EM, "INFLIGHT_BYTES", 1)
    spec = MeshSpec(dp=1, genome=4)
    ck = str(tmp_path / "mesh.snap")

    # interrupt the first run mid-stream via the snapshot hook, then resume
    class Stop(Exception):
        pass

    import irfinder_tpu.checkpoint as CK

    real_save = CK.save_checkpoint
    calls = {"n": 0}

    def save_and_stop(path, st, engine=None):
        real_save(path, st)
        calls["n"] += 1
        if calls["n"] == 1:
            raise Stop()

    monkeypatch.setattr(CK, "save_checkpoint", save_and_stop)
    # engine_mesh imports save_checkpoint inside run_bam_mesh from .checkpoint
    with pytest.raises(Stop):
        run_bam_mesh(
            ref, bam, str(tmp_path / "part"), spec, cap_frags=512,
            checkpoint=ck, checkpoint_every=2, devices=jax.devices()[:1],
        )
    assert load_checkpoint(ck) is not None
    monkeypatch.setattr(CK, "save_checkpoint", real_save)
    run_bam_mesh(
        ref, bam, str(tmp_path / "resumed"), spec, cap_frags=512,
        checkpoint=ck, checkpoint_every=10**9, devices=jax.devices()[:1],
    )
    for t in (
        "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt",
        "IRFinder-JuncCount.txt", "IRFinder-SpansPoint.txt",
        "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    ):
        assert (tmp_path / "plain" / t).read_bytes() == (
            tmp_path / "resumed" / t
        ).read_bytes(), t
