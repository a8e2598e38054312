"""The counting step's rank lookups vs NumPy ground truth.

ops/step.py ranks every aligned block twice: the MBS rank of both edges
(ops/device_ref.mbs_rank over the uspan BucketTable) and the boundary-point
rank range (BucketTable.rank on the point table).  These tests pin both to
brute-force NumPy definitions on adversarial inputs: queries exactly at span
starts and ends, inside and between spans, chromosome edges, absent chromosomes
and pad lanes (chrom -1), duplicate point keys, and sentinel-padded tables.

Every value compared is an int32 rank, so every comparison is exact
equality: no tolerance applies.
"""

import types

import numpy as np
import pytest

import jax.numpy as jnp

from irfinder_tpu.ops.bucket import BucketTable
from irfinder_tpu.ops.device_ref import PAD_CHROM, mbs_rank

OH = 5
N_CHROMS = 3


def _make_spans(rng, n_chroms=N_CHROMS, n_spans=300):
    """Random disjoint sorted spans across chromosomes + global MBS offsets."""
    chroms, starts, lens = [], [], []
    for c in range(n_chroms):
        pos = 0
        for _ in range(rng.integers(n_spans // 2, n_spans)):
            pos += int(rng.integers(1, 50))
            ln = int(rng.integers(1, 40))
            chroms.append(c)
            starts.append(pos)
            lens.append(ln)
            pos += ln
    chrom = np.array(chroms, np.int32)
    start = np.array(starts, np.int32)
    ln = np.array(lens, np.int32)
    off = np.concatenate([[0], np.cumsum(ln)]).astype(np.int32)
    return chrom, start, ln, off[:-1]


def _mbs_truth(chrom, start, ln, off, qc, qp):
    """Included bases on chrom qc strictly before qp, as a global MBS offset
    (the per-chrom base plus the clipped overlap with every span); pad
    lanes (qc < 0) get the trash rank mbs."""
    mbs = int(off[-1] + ln[-1])
    out = np.empty(qc.size, np.int64)
    for k, (c, p) in enumerate(zip(qc, qp)):
        if c < 0:
            out[k] = mbs
            continue
        m = chrom == c
        first = np.searchsorted(chrom, c, side="left")
        base = off[first] if first < chrom.size else mbs
        out[k] = base + np.clip(p - start[m], 0, ln[m]).sum()
    return out


def _device_mbs_rank(chrom, start, ln, off, qc, qp, pad_rows=0):
    """ops/device_ref.mbs_rank over a BucketTable built from these spans
    (optionally padded with `pad_rows` lex-+inf sentinel rows, as genome-
    sharded refs are)."""
    mbs = int(off[-1] + ln[-1])
    cols = [chrom, start, ln, off]
    if pad_rows:
        cols = [np.concatenate([chrom, np.full(pad_rows, PAD_CHROM, np.int32)])] + [
            np.concatenate([c, np.zeros(pad_rows, np.int32)]) for c in cols[1:]
        ]
    bt = BucketTable.build((cols[0], cols[1]), payload_cols=tuple(cols), bucket=128)
    chrom_base = np.array(
        [off[np.searchsorted(chrom, c)] if (chrom == c).any() else mbs for c in range(N_CHROMS + 1)],
        np.int32,
    )
    dref = types.SimpleNamespace(
        uspan_bt=bt,
        uspan_off=jnp.asarray(np.concatenate([off, [mbs]]).astype(np.int32)),
        chrom_base=jnp.asarray(chrom_base),
    )
    return np.asarray(mbs_rank(dref, jnp.asarray(qc), jnp.asarray(qp)))


def _points(rng):
    pts_c, pts_v = [], []
    for c in range(N_CHROMS):
        vs = np.sort(rng.integers(0, 4000, size=200))
        vs[10] = vs[11]  # force a duplicate key
        pts_c.append(np.full(len(vs), c, np.int32))
        pts_v.append(vs.astype(np.int32))
    return np.concatenate(pts_c), np.concatenate(pts_v)


def _point_truth(pts_c, pts_v, qc, qv, side):
    key = pts_c.astype(np.int64) * (1 << 31) + pts_v
    q = qc.astype(np.int64) * (1 << 31) + qv
    return np.searchsorted(key, q, side=side)


def _queries(rng, chrom, start, ln, nq=600):
    qc = rng.integers(-1, N_CHROMS + 1, size=nq).astype(np.int32)  # pad & absent chrom
    qs = rng.integers(0, 4200, size=nq).astype(np.int32)
    qe = qs + rng.integers(2 * OH, 200, size=nq).astype(np.int32)
    # adversarial: many queries exactly at span starts / ends (bucket-boundary
    # partial spans)
    k = min(nq // 3, len(start))
    qc[:k] = chrom[:k]
    qs[:k] = start[:k]
    qe[:k] = start[:k] + ln[:k]
    return qc, qs, qe


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranks_match_numpy(seed):
    # exact: int32 ranks
    rng = np.random.default_rng(seed)
    chrom, start, ln, off = _make_spans(rng)
    pts_c, pts_v = _points(rng)
    qc, qs, qe = _queries(rng, chrom, start, ln)

    for q in (qs, qe):
        np.testing.assert_array_equal(
            _device_mbs_rank(chrom, start, ln, off, qc, q),
            _mbs_truth(chrom, start, ln, off, qc, q),
        )
    pbt = BucketTable.build((pts_c, pts_v), bucket=128)
    for qv, side in ((qs + OH, "left"), (qe - OH, "right")):
        got = np.asarray(pbt.rank((jnp.asarray(qc), jnp.asarray(qv)), side=side))
        np.testing.assert_array_equal(got, _point_truth(pts_c, pts_v, qc, qv, side))


def test_shard_padded_tables(seed=7):
    """Genome-sharded refs pad tables with lex-+inf (PAD_CHROM, 0) rows to a
    uniform size (device_ref._pad_rows); padded rows must act as +inf
    sentinels for both rank kinds."""
    # exact: int32 ranks
    rng = np.random.default_rng(seed)
    chrom, start, ln, off = _make_spans(rng)
    pts_c, pts_v = _points(rng)
    qc, qs, qe = _queries(rng, chrom, start, ln, nq=300)
    for q in (qs, qe):
        np.testing.assert_array_equal(
            _device_mbs_rank(chrom, start, ln, off, qc, q, pad_rows=77),
            _mbs_truth(chrom, start, ln, off, qc, q),
        )
    xc = np.concatenate([pts_c, np.full(33, PAD_CHROM, np.int32)])
    xv = np.concatenate([pts_v, np.zeros(33, np.int32)])
    pbt = BucketTable.build((xc, xv), bucket=128)
    for qv, side in ((qs + OH, "left"), (qe - OH, "right")):
        got = np.asarray(pbt.rank((jnp.asarray(qc), jnp.asarray(qv)), side=side))
        np.testing.assert_array_equal(got, _point_truth(pts_c, pts_v, qc, qv, side))


def test_mbs_rank_at_and_past_last_span():
    """Queries at/after the last bucket's first key (reads mapping to the
    reference's final region) on a table whose last bucket mixes real and
    sentinel keys."""
    # exact: int32 ranks
    n = 16300
    chrom = np.zeros(n, np.int32)
    start = (np.arange(n, dtype=np.int32) * 10).astype(np.int32)
    ln = np.full(n, 4, np.int32)
    off = (np.arange(n, dtype=np.int64) * 4).astype(np.int32)
    qs = np.array([start[-1], start[-1] + 2, start[-1] + 1000], np.int32)
    qc = np.zeros_like(qs)
    total = int(off[-1] + ln[-1])
    np.testing.assert_array_equal(
        _device_mbs_rank(chrom, start, ln, off, qc, qs),
        [int(off[-1]), int(off[-1]) + 2, total],
    )
    np.testing.assert_array_equal(
        _device_mbs_rank(chrom, start, ln, off, qc, qs + 100), [total, total, total]
    )
