"""Device-side finalize statistics vs the host path, bit-for-bit.

ops/finalize_stats.py computes per-intron coverage / mean / percentiles /
edge windows on device (prefix-table gathers + a depth histogram); these
tests pin the XLA program, run on the CPU, against
finalize._depth_stats_vectorized on the toy reference, including the
saturated-histogram exact fallback (CAP monkeypatched small).  The device
computes only int32 counts and the host divides them exactly as the host
path does, so every comparison is exact equality: no tolerance applies.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import irfinder_tpu.ops.finalize_stats as FS
from irfinder_tpu.finalize import _depth_stats_vectorized
from irfinder_tpu.refio.compile import compile_reference

from test_oracle import CHROMS, ROIS, toy_exons


@pytest.fixture(scope="module")
def ref():
    return compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)


def _rand_depth(ref, seed, hot=0):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 7, size=ref.mbs_size).astype(np.int32)
    d[rng.random(ref.mbs_size) < 0.3] = 0  # coverage gaps
    if hot:
        d[: ref.mbs_size // 2] += hot  # saturate the capped histogram
    return d


def _check(ref, finref, d, subset_key, introns):
    want = _depth_stats_vectorized(ref, d.astype(np.int64))
    got = FS.device_depth_stats(ref, finref, jnp.asarray(d), subset_key)
    names = ["cov", "mean", "p25", "p50", "p75", "firstw", "lastw"]
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(
            np.asarray(g)[introns], np.asarray(w)[introns], err_msg=f"{subset_key}:{name}"
        )


def test_matches_host_all_introns(ref):
    finref = FS.build_finalize_ref(ref)
    for seed in (0, 1):
        _check(ref, finref, _rand_depth(ref, seed), "both", np.arange(ref.n_introns))


def test_matches_host_strand_subsets(ref):
    finref = FS.build_finalize_ref(ref)
    d = _rand_depth(ref, 3)
    ist = ref.intron_strand.astype(int)
    _check(ref, finref, d, "A", np.nonzero(ist == 0)[0])
    _check(ref, finref, d, "B", np.nonzero(ist == 1)[0])


def test_saturated_fallback(ref, monkeypatch):
    # tiny CAP forces the exact host-sort fallback for most introns
    monkeypatch.setattr(FS, "CAP", 4)
    finref = FS.build_finalize_ref(ref)
    d = _rand_depth(ref, 5, hot=20)
    _check(ref, finref, d, "both", np.arange(ref.n_introns))


def test_trailing_zero_run_intron():
    """Regression: an intron with zero included bases at the END of the CSR
    (intron_run_off[i] == R) must not crash build_finalize_ref."""
    import dataclasses

    import numpy as np

    base = compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)
    # append a synthetic fully-excluded intron owning no runs
    ref2 = dataclasses.replace(
        base,
        intron_chrom=np.concatenate([base.intron_chrom, [0]]).astype(base.intron_chrom.dtype),
        intron_start=np.concatenate([base.intron_start, [1]]).astype(base.intron_start.dtype),
        intron_end=np.concatenate([base.intron_end, [2]]).astype(base.intron_end.dtype),
        intron_strand=np.concatenate([base.intron_strand, [0]]).astype(base.intron_strand.dtype),
        intron_names=list(base.intron_names) + ["G/x/clean"],
        intron_run_off=np.concatenate(
            [base.intron_run_off, [base.intron_run_off[-1]]]
        ).astype(base.intron_run_off.dtype),
        intron_bstart_idx=np.concatenate([base.intron_bstart_idx, [0]]).astype(base.intron_bstart_idx.dtype),
        intron_bend_idx=np.concatenate([base.intron_bend_idx, [0]]).astype(base.intron_bend_idx.dtype),
        intron_pair_idx=np.concatenate([base.intron_pair_idx, [0]]).astype(base.intron_pair_idx.dtype),
        intron_pstart_idx=np.concatenate([base.intron_pstart_idx, [0]]).astype(base.intron_pstart_idx.dtype),
        intron_pend_idx=np.concatenate([base.intron_pend_idx, [0]]).astype(base.intron_pend_idx.dtype),
    )
    finref = FS.build_finalize_ref(ref2)
    d = _rand_depth(ref2, 1)
    got = FS.device_depth_stats(ref2, finref, jnp.asarray(d), "both")
    want = _depth_stats_vectorized(ref2, d.astype(np.int64))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
