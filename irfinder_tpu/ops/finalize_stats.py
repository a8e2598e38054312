"""Device-side per-intron depth statistics — the finalize join without the
depth pull.

The host finalize (finalize._depth_stats_vectorized) needs the full per-base
depth array — (2, mbs) int32, ~2.4 GB at whole-genome scale — pulled to the
host and walked in NumPy.  This module computes every per-intron statistic
ON the device and pulls only O(#introns):

* coverage / mean / edge windows: one prefix table over MBS + gathers at the
  (static) run and edge-piece boundaries — per-intron sums are differences
  of prefix sums, aggregated host-side over the tiny run table.
* exact nearest-rank percentiles: a per-intron depth histogram (one integer
  scatter-add, ops/scatter.histogram) over the flattened per-base MBS index
  list, then a (n, CAP) cumsum + threshold count.  Introns whose percentile
  saturates the CAP-bin histogram fall back to an exact host sort over just
  their bases (pulled in one batched gather).

The flattened base lists (O(MBS) — ~300M entries per subset at whole-genome
scale) are expanded ON DEVICE inside the jitted program from the tiny
per-run tables (expand_runs); the host builds only O(#runs) structure.

All remaining index structure (run boundaries, edge pieces) depends only on
the compiled reference, so it is built once per Engine (FinalizeRef) and
reused across samples/variants.

Statistics are bit-identical to the host path (tests/test_finalize_device.py
pins them against finalize._depth_stats_vectorized): every device quantity is
an int32 count, so the comparison is exact equality.  Reference parity: this
is the per-intron depth-statistics half of CoverageBlocksIRFinder::Output
(SURVEY.md §3.4 [R]).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import semantics as S
from ..refio.compile import CompiledRef
from .scatter import histogram

#: histogram depth cap (bins per intron); deeper bases land in the last bin
#: and their introns take the exact host-sort fallback
CAP = 2048


@dataclasses.dataclass
class _Subset:
    """Per-run structure for one intron subset; the per-base flat lists are
    expanded on device inside _hist_jit (expand_runs, intron-major run
    order)."""

    introns: np.ndarray  # (n_sub,) intron ids
    n_bases: np.ndarray  # (n_sub,) int64 included bases per intron
    runs_start: jnp.ndarray  # (R_sub,) int32 MBS start of each subset run
    runs_len: jnp.ndarray  # (R_sub,) int32 run length in bases
    runs_base: jnp.ndarray  # (R_sub,) int32 = local_intron * CAP per run
    F: int  # total flattened bases (static shape of the device expansion)
    ridx: jnp.ndarray  # (3, n_sub) nearest-rank target indices


@dataclasses.dataclass
class FinalizeRef:
    """Device-resident static finalize structure for one CompiledRef."""

    run_lo: jnp.ndarray  # (R,) int32 cumsum gather positions (run start)
    run_hi: jnp.ndarray  # (R,) int32 (run start + len)
    run_intron: np.ndarray  # (R,) host int64
    fw_lo: jnp.ndarray  # edge-window pieces, same layout
    fw_hi: jnp.ndarray
    fw_intron: np.ndarray
    lw_lo: jnp.ndarray
    lw_hi: jnp.ndarray
    lw_intron: np.ndarray
    n_bases: np.ndarray  # (N,) int64
    subsets: dict  # key in {"both","A","B"} -> _Subset


def _edge_pieces(ref: CompiledRef, n_bases: np.ndarray, run_intron: np.ndarray):
    """Per-intron MBS piece lists covering the first and last
    min(EDGE_DEPTH_WINDOW, n) included bases, in genomic order.  Fully
    vectorized: each run's piece is its overlap with the intron-local base
    window [0, w) (first) / [n-w, n) (last)."""
    W = S.EDGE_DEPTH_WINDOW
    lens = ref.run_len.astype(np.int64)
    starts = ref.run_mbs_start.astype(np.int64)
    # intron-local base offset of each run (cumsum reset per intron)
    cl = np.cumsum(lens) - lens
    # introns with zero included bases can sit at the tail with
    # intron_run_off[i] == R; clip (their seg0 entry is never referenced
    # because they own no runs)
    first_run = np.minimum(
        ref.intron_run_off[:-1].astype(np.int64), max(len(lens) - 1, 0)
    )
    seg0 = cl[first_run] if lens.size else np.zeros(0, np.int64)
    b0 = cl - (seg0[run_intron] if lens.size else 0)
    n = n_bases[run_intron]
    w = np.minimum(W, n)

    def pieces(win_lo, win_hi):
        p_lo = np.maximum(b0, win_lo)
        p_hi = np.minimum(b0 + lens, win_hi)
        m = p_hi > p_lo
        lo = (starts + (p_lo - b0))[m].astype(np.int32)
        hi = (starts + (p_hi - b0))[m].astype(np.int32)
        return jnp.asarray(lo), jnp.asarray(hi), run_intron[m]

    f = pieces(np.zeros_like(w), w)
    l = pieces(n - w, n)
    return (*f, *l)


def _subset_runs(ref: CompiledRef, introns: np.ndarray):
    """Run ids of the subset's introns, intron-major order (O(#runs) host
    work).  Returns (runs, local_intron_per_run)."""
    off = ref.intron_run_off.astype(np.int64)
    counts = off[introns + 1] - off[introns]
    tot_runs = int(counts.sum())
    rep = np.repeat(np.cumsum(counts) - counts, counts)
    runs = np.repeat(off[introns], counts) + (np.arange(tot_runs, dtype=np.int64) - rep)
    local = np.repeat(np.arange(introns.size, dtype=np.int64), counts)
    return runs, local


def _build_subset(ref: CompiledRef, introns: np.ndarray, n_bases: np.ndarray) -> _Subset:
    """Per-run tables for the subset (intron-major run order).  The
    per-base flat lists are expanded on device in _hist_jit — the host never
    materializes O(MBS) arrays here."""
    runs, local = _subset_runs(ref, introns)
    lens = ref.run_len[runs].astype(np.int64)
    starts = ref.run_mbs_start[runs].astype(np.int64)
    total = int(lens.sum())
    nb = n_bases[introns].astype(np.int64)
    return _Subset(
        introns=introns,
        n_bases=nb,
        runs_start=jnp.asarray(starts.astype(np.int32)),
        runs_len=jnp.asarray(lens.astype(np.int32)),
        runs_base=jnp.asarray((local * CAP).astype(np.int32)),
        F=total,
        ridx=jnp.asarray(_ridx(nb)),
    )


def _host_flat_src(ref: CompiledRef, global_introns: np.ndarray) -> np.ndarray:
    """Host expansion of a FEW introns' included-base MBS indices (the exact
    percentile fallback for cap-saturated introns) — same intron-major run
    order as the device expansion."""
    runs, _ = _subset_runs(ref, global_introns)
    lens = ref.run_len[runs].astype(np.int64)
    starts = ref.run_mbs_start[runs].astype(np.int64)
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.int32)
    rep_off = np.repeat(np.cumsum(lens) - lens, lens)
    pos = np.arange(total, dtype=np.int64) - rep_off
    return (np.repeat(starts, lens) + pos).astype(np.int32)


#: maximum bases per device-sum piece: caps any single prefix-difference at
#: RUN_SPLIT * max_depth, keeping the int32 wraparound subtraction exact for
#: depths up to ~500k even on 100 kb intron runs
RUN_SPLIT = 4096


def _split_runs(starts: np.ndarray, lens: np.ndarray, introns: np.ndarray):
    """Split runs longer than RUN_SPLIT into consecutive pieces (same intron),
    so per-piece depth sums stay far inside int31."""
    n_pieces = -(-lens // RUN_SPLIT)
    n_pieces = np.maximum(n_pieces, 1)
    total = int(n_pieces.sum())
    rep = np.repeat(np.cumsum(n_pieces) - n_pieces, n_pieces)
    k = np.arange(total, dtype=np.int64) - rep  # piece index within its run
    base = np.repeat(starts, n_pieces)
    ln = np.repeat(lens, n_pieces)
    lo = base + k * RUN_SPLIT
    hi = np.minimum(base + (k + 1) * RUN_SPLIT, base + ln)
    return lo, hi, np.repeat(introns, n_pieces)


def build_finalize_ref(ref: CompiledRef) -> FinalizeRef:
    cached = getattr(ref, "_finalize_ref_cache", None)
    if cached is not None:
        return cached
    n_bases = np.zeros(ref.n_introns, np.int64)
    run_intron = np.repeat(
        np.arange(ref.n_introns), np.diff(ref.intron_run_off).astype(np.int64)
    )
    np.add.at(n_bases, run_intron, ref.run_len.astype(np.int64))
    fw = _edge_pieces(ref, n_bases, run_intron)
    istrand = ref.intron_strand.astype(np.int64)
    subsets = {
        "both": _build_subset(ref, np.arange(ref.n_introns), n_bases),
        "A": _build_subset(ref, np.nonzero(istrand == 0)[0], n_bases),
        "B": _build_subset(ref, np.nonzero(istrand == 1)[0], n_bases),
    }
    r_lo, r_hi, r_intron = _split_runs(
        ref.run_mbs_start.astype(np.int64), ref.run_len.astype(np.int64), run_intron
    )
    j = jnp.asarray
    out = FinalizeRef(
        run_lo=j(r_lo.astype(np.int32)),
        run_hi=j(r_hi.astype(np.int32)),
        run_intron=r_intron,
        fw_lo=fw[0], fw_hi=fw[1], fw_intron=fw[2],
        lw_lo=fw[3], lw_hi=fw[4], lw_intron=fw[5],
        n_bases=n_bases,
        subsets=subsets,
    )
    try:
        object.__setattr__(ref, "_finalize_ref_cache", out)
    except Exception:
        pass
    return out


from .prefix import PFX_K, cumsum_1d


def _prefix_tables(x):
    """x (n,) int32 -> (rp_flat (n_pad,), tp (T,)): inclusive within-row
    prefix (flattened) and exclusive per-row offsets.  One trailing zero row
    guarantees position n is addressable."""
    n = x.shape[0]
    pad = (-n) % PFX_K + PFX_K
    x2 = jnp.pad(x, (0, pad)).reshape(-1, PFX_K)
    rp = jnp.cumsum(x2, axis=1, dtype=jnp.int32)
    tile = rp[:, -1]
    tp = jnp.cumsum(tile, dtype=jnp.int32) - tile
    return rp.reshape(-1), tp


def _prefix_at(rp_flat, tp, p):
    """Exclusive prefix sum at position p (cs[p] of the flat formulation),
    identical mod 2^32."""
    c = p % PFX_K
    intra = jnp.where(c > 0, jnp.take(rp_flat, jnp.maximum(p - 1, 0)), 0)
    return jnp.take(tp, p // PFX_K) + intra


@jax.jit
def _device_sums(dsum, run_lo, run_hi, fw_lo, fw_hi, lw_lo, lw_hi):
    """Two-level prefix tables over MBS, then every per-run / per-piece sum
    is a prefix difference.

    The prefix itself may exceed 2^31 on deep whole-genome runs, but int32
    wraparound subtraction still yields the exact per-run sum as long as each
    individual run's depth sum fits in int31 (two's-complement modular
    arithmetic) — the same bound the counters themselves already assume."""
    rp, tp = _prefix_tables(dsum)
    rpz, tpz = _prefix_tables((dsum != 0).astype(jnp.int32))

    def cs(p):
        return _prefix_at(rp, tp, p)

    def csnz(p):
        return _prefix_at(rpz, tpz, p)

    return (
        cs(run_hi) - cs(run_lo),
        csnz(run_hi) - csnz(run_lo),
        cs(fw_hi) - cs(fw_lo),
        cs(lw_hi) - cs(lw_lo),
    )


import functools


def expand_runs(runs_start, runs_len, runs_base, F: int):
    """Device expansion of a subset's per-run tables into its per-base flat
    lists (the np.repeat of the host path, tests/test_gather.py):

      src[k]      = MBS index of flat base k
      base_exp[k] = runs_base of the run that owns base k

    Per-run values become per-base without a large gather: one small delta
    scatter at the run starts plus a prefix sum.  Zero-length runs put their
    delta at the same offset as the next run, so the deltas telescope to the
    owning run's value; trailing zero-length runs scatter at slot F and are
    dropped.  F (static) is the total base count."""
    off = jnp.cumsum(runs_len) - runs_len

    def per_base(a):
        d = jnp.concatenate([a[:1], a[1:] - a[:-1]])
        return cumsum_1d(jnp.zeros(F, jnp.int32).at[off].add(d, mode="drop"))

    src = jnp.arange(F, dtype=jnp.int32) + per_base(runs_start - off)
    return src, per_base(runs_base)


@functools.partial(jax.jit, static_argnames=("n_sub", "cap", "F"))
def _hist_jit(dsum, runs_start, runs_len, runs_base, ridx, n_sub, cap, F):
    """Per-intron clamped depth histogram -> nearest-rank percentile bins:
    pk (3, n_sub), pk[k, i] = smallest bin v with at least ridx[k, i] + 1 of
    intron i's bases at clamped depth <= v."""
    if F:
        src, base_exp = expand_runs(runs_start, runs_len, runs_base, F)
        hidx = base_exp + jnp.clip(jnp.take(dsum, src), 0, cap - 1)
    else:
        hidx = jnp.zeros(0, jnp.int32)
    hist = histogram(n_sub * cap, hidx)
    hcs = jnp.cumsum(hist.reshape(n_sub, cap), axis=1, dtype=jnp.int32)
    return jnp.stack(
        [
            jnp.sum(hcs < (ridx[k][:, None] + 1), axis=1, dtype=jnp.int32)
            for k in range(3)
        ]
    )


def _device_hist(dsum, sub: _Subset, ridx):
    """_hist_jit over one subset's tables.  Returns pk (3, n_sub)."""
    return _hist_jit(
        dsum, sub.runs_start, sub.runs_len, sub.runs_base, ridx,
        n_sub=sub.introns.size, cap=CAP, F=sub.F,
    )


def _ridx(n_bases: np.ndarray) -> np.ndarray:
    qs = (0.25, 0.50, 0.75)
    n = n_bases.astype(np.int64)
    out = np.zeros((3, n.size), np.int64)
    for k, q in enumerate(qs):
        out[k] = np.minimum(np.maximum(n - 1, 0), np.maximum(0, np.ceil(q * n).astype(np.int64) - 1))
    return out


def _host_finish(ref, finref, sub, run_sum, run_nz, fw_sum, lw_sum, pk, sat_vals_fn):
    """Per-run device sums + per-intron percentile bins -> the 7-tuple,
    matching finalize._depth_stats_vectorized bit-for-bit.  sat_vals_fn(sat)
    pulls the (rare) cap-saturated introns' per-base depths for the exact
    host-sort fallback."""
    N = ref.n_introns
    sums = np.zeros(N, np.int64)
    nzs = np.zeros(N, np.int64)
    np.add.at(sums, finref.run_intron, run_sum.astype(np.int64))
    np.add.at(nzs, finref.run_intron, run_nz.astype(np.int64))
    fws = np.zeros(N, np.int64)
    lws = np.zeros(N, np.int64)
    np.add.at(fws, finref.fw_intron, fw_sum.astype(np.int64))
    np.add.at(lws, finref.lw_intron, lw_sum.astype(np.int64))

    nb = finref.n_bases
    nz_mask = nb > 0
    cov = np.zeros(N)
    mean = np.zeros(N)
    firstw = np.zeros(N)
    lastw = np.zeros(N)
    cov[nz_mask] = nzs[nz_mask] / nb[nz_mask]
    mean[nz_mask] = sums[nz_mask] / nb[nz_mask]
    w = np.minimum(S.EDGE_DEPTH_WINDOW, nb)
    firstw[nz_mask] = fws[nz_mask] / w[nz_mask]
    lastw[nz_mask] = lws[nz_mask] / w[nz_mask]

    p = np.zeros((3, N), np.int64)
    if sub.introns.size:
        pk = pk.astype(np.int64)
        # saturated percentiles: exact host sort over just those bases
        sat = np.nonzero(((pk >= CAP - 1).any(axis=0)) & (sub.n_bases > 0))[0]
        if sat.size:
            pulled = sat_vals_fn(sat)
            off = np.concatenate([[0], np.cumsum(sub.n_bases[sat])])
            for j_, i_loc in enumerate(sat):
                d = np.sort(pulled[off[j_] : off[j_ + 1]])
                for k, q in enumerate((0.25, 0.50, 0.75)):
                    r = min(d.size - 1, max(0, int(np.ceil(q * d.size)) - 1))
                    pk[k, i_loc] = d[r]
        for k in range(3):
            p[k, sub.introns] = np.where(sub.n_bases > 0, pk[k], 0)
    return cov, mean, p[0], p[1], p[2], firstw, lastw


def device_depth_stats(
    ref: CompiledRef,
    finref: FinalizeRef,
    dsum_dev,
    subset_key: str,
):
    """Full 7-tuple of per-intron stats for one depth plane, matching
    finalize._depth_stats_vectorized bit-for-bit.  dsum_dev: device (mbs,)
    int32.  Stats are n_introns-sized with entries outside the subset zero."""
    sub = finref.subsets[subset_key]
    run_sum, run_nz, fw_sum, lw_sum = (
        np.asarray(v)
        for v in _device_sums(
            dsum_dev, finref.run_lo, finref.run_hi,
            finref.fw_lo, finref.fw_hi, finref.lw_lo, finref.lw_hi,
        )
    )
    if sub.introns.size:
        pk = np.asarray(_device_hist(dsum_dev, sub, sub.ridx))
    else:
        pk = np.zeros((3, 0), np.int32)

    def sat_vals(sat):
        # rare exact-fallback path: expand just the saturated introns' base
        # lists on host and gather their depths from the device plane
        idx = _host_flat_src(ref, sub.introns[sat])
        return np.asarray(jnp.take(dsum_dev, jnp.asarray(idx)))

    return _host_finish(ref, finref, sub, run_sum, run_nz, fw_sum, lw_sum, pk, sat_vals)


#: order of the packed per-subset sections in device_all_stats
_SUBSET_ORDER = ("both", "A", "B")

_dsum_both_jit = jax.jit(lambda d: d[0] + d[1])


def _fn_cache_of(finref: FinalizeRef) -> dict:
    cache = getattr(finref, "_fn_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(finref, "_fn_cache", cache)
    return cache


def _all_stats_fn(finref: FinalizeRef):
    """One jitted program computing every variant's sums + percentile bins,
    packed into a single int32 vector (ONE dispatch + ONE D2H per sample)."""
    key = "_all_stats"
    cache = _fn_cache_of(finref)
    if key in cache:
        return cache[key]

    sizes = {k_: finref.subsets[k_].introns.size for k_ in _SUBSET_ORDER}
    Fs = {k_: finref.subsets[k_].F for k_ in _SUBSET_ORDER}

    def go(depth, plane_a, tables):
        # plane_a: 0/1 traced scalar — which depth plane feeds subset A
        # (library-polarity flip); subset B gets the other plane.  All index
        # structure arrives via `tables` (jit ARGUMENTS — closure capture
        # would bake ~100s of MB of constants into the HLO).
        parts = []
        for k_ in _SUBSET_ORDER:
            if k_ == "both":
                dsum = depth[0] + depth[1]
            else:
                sel = plane_a if k_ == "A" else 1 - plane_a
                dsum = jnp.where(sel == 0, depth[0], depth[1])
            rs, rn, fw, lw = _device_sums(
                dsum, tables["run_lo"], tables["run_hi"],
                tables["fw_lo"], tables["fw_hi"], tables["lw_lo"], tables["lw_hi"],
            )
            parts += [rs, rn, fw, lw]
            if sizes[k_]:
                t = tables[k_]
                pk = _hist_jit(
                    dsum, t["runs_start"], t["runs_len"], t["runs_base"],
                    t["ridx"], n_sub=sizes[k_], cap=CAP, F=Fs[k_],
                )
                parts.append(pk.reshape(-1))
        return jnp.concatenate([p.reshape(-1).astype(jnp.int32) for p in parts])

    cache["_all_stats_go"] = go
    fn = jax.jit(go)
    cache[key] = fn
    return fn


def _all_stats_multi_fn(finref: FinalizeRef, n: int):
    """Batched variant: ONE program computing the packed stats vector for N
    stacked depth planes via lax.map (each iteration is the single-sample
    body) — one dispatch + one D2H for the whole batch instead of N."""
    cache = _fn_cache_of(finref)
    key = ("_all_stats_multi", n)
    if key in cache:
        return cache[key]
    _all_stats_fn(finref)  # ensures the raw body is cached
    go = cache["_all_stats_go"]

    def gom(depth_stack, plane_vec, tables):
        return jax.lax.map(
            lambda a: go(a[0], a[1], tables), (depth_stack, plane_vec)
        )

    fn = jax.jit(gom)
    cache[key] = fn
    return fn


def device_all_stats_multi_async(
    ref: CompiledRef,
    finref: FinalizeRef,
    depth_devs: list,
    plane_as: "list[int]",
):
    """Dispatch the batched stats program over N samples' depth planes
    without blocking; returns a zero-arg callable yielding the per-sample
    stats-cache dicts (each exactly what device_all_stats returns)."""
    n = len(depth_devs)
    fn = _all_stats_multi_fn(finref, n)
    stack = jnp.stack([jnp.asarray(d) for d in depth_devs])
    planes = jnp.asarray(np.asarray(plane_as, np.int32))
    packed_dev = fn(stack, planes, _stats_tables_dev(finref))

    def finish() -> list:
        p = np.asarray(packed_dev)
        return [
            _unpack_all_stats(ref, finref, depth_devs[i], int(plane_as[i]), p[i])
            for i in range(n)
        ]

    return finish


def _stats_tables(finref: FinalizeRef) -> dict:
    t = {
        "run_lo": finref.run_lo, "run_hi": finref.run_hi,
        "fw_lo": finref.fw_lo, "fw_hi": finref.fw_hi,
        "lw_lo": finref.lw_lo, "lw_hi": finref.lw_hi,
    }
    for k_ in _SUBSET_ORDER:
        sub = finref.subsets[k_]
        t[k_] = {
            "runs_start": sub.runs_start, "runs_len": sub.runs_len,
            "runs_base": sub.runs_base, "ridx": sub.ridx,
        }
    return t


def _stats_tables_dev(finref: FinalizeRef):
    """Device-resident copy of the index tables, transferred ONCE per finref.
    The tables are jit arguments (see _all_stats_fn), and passing host NumPy
    arrays would re-run the H2D transfer on every finalize call — batch mode
    finalizes N samples against the same reference, and the tables are the
    largest per-call payload by far."""
    cache = getattr(finref, "_fn_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(finref, "_fn_cache", cache)
    t = cache.get("_tables_dev")
    if t is None:
        t = jax.device_put(_stats_tables(finref))
        cache["_tables_dev"] = t
    return t


def device_all_stats_async(
    ref: CompiledRef,
    finref: FinalizeRef,
    depth_dev,
    flip: bool,
):
    """Dispatch the fused stats program without blocking; returns a zero-arg
    callable that blocks on the single packed D2H and unpacks the result.
    JAX dispatch is asynchronous, so host work between dispatch and finish
    (counter pulls, junction joins, row-column prep) overlaps the device
    compute."""
    fn = _all_stats_fn(finref)
    plane_a = 1 if flip else 0
    packed_dev = fn(depth_dev, jnp.int32(plane_a), _stats_tables_dev(finref))
    return lambda: _unpack_all_stats(
        ref, finref, depth_dev, plane_a, np.asarray(packed_dev)
    )


def device_all_stats(
    ref: CompiledRef,
    finref: FinalizeRef,
    depth_dev,
    flip: bool,
) -> dict:
    """All three stats variants (strand-summed + each plane's annotation
    subset) in one device program: returns {2: stats, plane_a: stats,
    1-plane_a: stats} keyed exactly as intron_rows' stats_cache expects."""
    return device_all_stats_async(ref, finref, depth_dev, flip)()


def _unpack_all_stats(
    ref: CompiledRef,
    finref: FinalizeRef,
    depth_dev,
    plane_a: int,
    packed: np.ndarray,
) -> dict:
    R = int(finref.run_lo.shape[0])
    F = int(finref.fw_lo.shape[0])
    L = int(finref.lw_lo.shape[0])
    out = {}
    pos = 0
    for k_ in _SUBSET_ORDER:
        sub = finref.subsets[k_]
        rs = packed[pos : pos + R]; pos += R
        rn = packed[pos : pos + R]; pos += R
        fw = packed[pos : pos + F]; pos += F
        lw = packed[pos : pos + L]; pos += L
        if sub.introns.size:
            pk = packed[pos : pos + 3 * sub.introns.size].reshape(3, -1)
            pos += 3 * sub.introns.size
        else:
            pk = np.zeros((3, 0), np.int32)

        def sat_vals(sat, k_=k_, sub=sub):
            # rare exact-fallback path: recompute the variant's dsum, expand
            # just the saturated introns' base lists on host, and pull them
            if k_ == "both":
                dsum = _dsum_both_jit(depth_dev)
            else:
                pl_ = plane_a if k_ == "A" else 1 - plane_a
                dsum = depth_dev[pl_]
            idx = _host_flat_src(ref, sub.introns[sat])
            return np.asarray(jnp.take(dsum, jnp.asarray(idx)))

        variant = 2 if k_ == "both" else (plane_a if k_ == "A" else 1 - plane_a)
        out[variant] = _host_finish(
            ref, finref, sub, rs, rn, fw, lw, pk, sat_vals
        )
    return out
