"""GPU lane: the device programs re-verified on the card.

Run on a machine with a card (JAX_PLATFORMS unset, so JAX picks the GPU):

    python -m pytest tests/test_gpu_hw.py -m gpu -q

Each test re-checks on the GPU what the CPU suite checks on the CPU backend:
XLA-compiled results must be integer-exact against the independent
reference path.  Every compared value is an int32 count or a table built
from them, so every comparison is exact equality.  The tests skip (inside
the `gpu` fixture, never at import) when the backend is not the GPU.
chip_smoke.py covers the same ground at whole-genome width.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt",
    "IRFinder-JuncCount.txt", "IRFinder-SpansPoint.txt",
    "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
)


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: run `python -m pytest tests/test_gpu_hw.py -m gpu` "
            "on a machine with a card"
        )


def test_scatter_and_histogram_match_numpy_on_gpu(gpu):
    import jax
    import jax.numpy as jnp

    from irfinder_tpu.ops.scatter import histogram, scatter_add

    rng = np.random.default_rng(0)
    m = 1 << 20
    idx = rng.integers(0, m, 400_000).astype(np.int32)
    idx[:50_000] = 7  # same-address atomics
    val = rng.choice(np.array([-1, 1], np.int32), size=idx.size)
    got = jax.jit(scatter_add)(jnp.zeros(m, jnp.int32), jnp.asarray(idx), jnp.asarray(val))
    want = np.zeros(m, np.int64)
    np.add.at(want, idx, val)
    assert np.array_equal(np.asarray(got), want)
    h = jax.jit(histogram, static_argnums=0)(m, jnp.asarray(idx))
    assert np.array_equal(np.asarray(h), np.bincount(idx, minlength=m))


def test_count_step_matches_oracle_on_gpu(gpu, tmp_path):
    """Full compiled engine on the card vs the scalar NumPy oracle on an
    identical realistic BAM — every counter integer-exact."""
    from irfinder_tpu.engine import Engine, open_decoder
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.oracle import OracleCounters
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=60)
    bam = os.path.join(str(tmp_path), "t.bam")
    write_realistic_bam(bam, ref, n_pairs=8_000, seed=13)
    _, batches, _ = open_decoder(ref, bam, 2048, True, 2)
    batches = list(batches)
    orc = OracleCounters.create(ref)
    for b in batches:
        orc.add_batch(b)
    eng = Engine(ref, cap_frags=2048)
    eng._device_stats = False  # pull the raw depth for the comparison
    eng.reset(n_refids=len(ref.chroms))
    eng.run_stream(batches)
    fc = eng.counters_host()
    for k in ("depth", "start_cnt", "end_cnt", "exact_cnt", "span_hits", "roi_cnt"):
        np.testing.assert_array_equal(np.asarray(fc[k]), getattr(orc, k), err_msg=k)


def test_device_stats_finalize_matches_host_on_gpu(gpu, tmp_path):
    """Device-stats finalize (the GPU default) vs the host stats path on the
    same BAM: byte-identical tables."""
    from irfinder_tpu.engine import Engine, open_decoder, run_bam, write_outputs
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=60)
    bam = os.path.join(str(tmp_path), "t.bam")
    write_realistic_bam(bam, ref, n_pairs=20_000, seed=4, stranded=True)
    out_dev = os.path.join(str(tmp_path), "dev")
    run_bam(ref, bam, out_dev)
    eng = Engine(ref)
    eng._device_stats = False
    header, batches, _ = open_decoder(ref, bam)
    eng.reset(n_refids=len(header.ref_names))
    eng.run_stream(batches)
    out_host = os.path.join(str(tmp_path), "host")
    write_outputs(out_host, ref, header, eng, eng.results())
    for t in TABLES:
        a = open(os.path.join(out_dev, t)).read()
        b = open(os.path.join(out_host, t)).read()
        assert a == b, f"{t}: device-stats finalize != host stats on the GPU"


def test_multi_bam_batched_finalize_matches_solo_on_gpu(gpu, tmp_path):
    """Batch mode on the card (batched lax.map stats program + concatenated
    small-counter pull) vs solo runs: byte-identical tables."""
    from irfinder_tpu.engine import run_bam, run_multi_bam
    from irfinder_tpu.io.bamgen import write_realistic_bam
    from irfinder_tpu.synth import synth_ref

    ref = synth_ref(n_genes=60)
    paths = []
    for i in range(2):
        p = os.path.join(str(tmp_path), f"s{i}.bam")
        write_realistic_bam(p, ref, n_pairs=6_000 + 2_000 * i, seed=40 + i)
        paths.append(p)
    multi = [os.path.join(str(tmp_path), f"multi{i}") for i in range(2)]
    run_multi_bam(ref, paths, multi)
    for i, p in enumerate(paths):
        solo = os.path.join(str(tmp_path), f"solo{i}")
        run_bam(ref, p, solo)
        for t in TABLES:
            a = open(os.path.join(multi[i], t)).read()
            b = open(os.path.join(solo, t)).read()
            assert a == b, f"sample {i} {t}: batch mode diverged on the GPU"
