"""Genome-axis map sharding (SURVEY.md §5.7, §2 row 21; BASELINE configs
C/E): the reference map — not just the read stream — is partitioned across
devices, so whole-genome MBS counters (≈1.3e9 slots for human) never have to
fit one chip.

Design (no read routing needed — the key trick):

* Shards are CONTIGUOUS chromosome ranges, balanced by measured-base count.
  Every CompiledRef table is sorted by (chrom, ...) with per-chrom segment
  offsets, so a shard is literally a slice of every array; global chrom ids
  are kept, with zero-width segments for non-owned chromosomes.
* Each device runs the SAME counting program (ops/step.py) over the full
  (replicated or dp-sharded) batch against its own table slice.  Queries for
  chromosomes a shard does not own are self-neutralizing by construction:
  - depth / spans diff regions: lo == hi for absent chromosomes, so the
    +1/-1 pair cancels;
  - ROI overlap tests simply never match
  (junction counting is host-side per batch — ops/step.py docstring — so it
  never touches the genome axis at all).
  The per-refid fragment tally is computed identically on every shard, so
  reassembly takes it from shard 0 instead of summing.
* Table shapes are padded to the max across shards (build_device_ref pads /
  BucketTable pad_to) so ONE shard_map program serves all shards; per-shard
  real sizes live host-side in the plan and drive reassembly.
* Reassembly is pure concatenation in chromosome order (shards are
  contiguous), producing exactly the counters an unsharded run yields —
  integer-exact, tested in tests/test_genome_shard.py.

Composes with data parallelism on one Mesh: axes ("dp", "genome") — batch
sharded over dp, map sharded over genome, counters summed over dp and
concatenated over genome.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.device_ref import DeviceRef, build_device_ref
from ..ops.step import CounterLayout, count_step
from ..refio.compile import CompiledRef


@dataclasses.dataclass
class ShardPlan:
    """Contiguous chrom ranges + per-shard real sizes + uniform pad sizes."""

    bounds: list  # (G+1,) chrom-range boundaries; shard i owns [b[i], b[i+1])
    pads: dict  # uniform table sizes {uspan,bstart,bend,pair,point,roi,mbs}
    real: list  # per-shard dict of real sizes incl. real mbs


def _seg_slice(seg: np.ndarray, lo_row: int, hi_row: int) -> np.ndarray:
    """Rebase a per-chrom segment-offset array onto a row slice [lo, hi)."""
    return (np.clip(seg.astype(np.int64), lo_row, hi_row) - lo_row).astype(np.int32)


def plan_shards(ref: CompiledRef, n_shards: int) -> ShardPlan:
    """Contiguous chrom partition balanced by measured-base count."""
    n_chroms = ref.n_chroms
    # per-chrom MBS sizes
    off = ref.uspan_mbs_off
    seg = ref.uspan_seg
    sizes = np.array(
        [int(off[seg[c + 1]] - off[seg[c]]) if seg[c + 1] > seg[c] else 0 for c in range(n_chroms)],
        dtype=np.int64,
    )
    total = max(1, int(sizes.sum()))
    bounds = [0]
    acc = 0
    for c in range(n_chroms):
        acc += int(sizes[c])
        b = len(bounds)  # bins closed so far
        # close bin b once it holds its fair share of measured bases
        if b < n_shards and acc * n_shards >= total * b:
            bounds.append(c + 1)
    while len(bounds) < n_shards + 1:
        bounds.append(n_chroms)
    bounds[-1] = n_chroms

    shards = [slice_ref(ref, bounds[i], bounds[i + 1]) for i in range(n_shards)]
    real = []
    for s in shards:
        real.append(
            {
                "uspan": int(s.uspan_start.size),
                "bstart": int(s.bstart_coord.size),
                "bend": int(s.bend_coord.size),
                "pair": int(s.upair_start.size),
                "point": int(s.point_coord.size),
                "roi": int(s.roi_start.size),
                "mbs": s.mbs_size,
            }
        )
    pads = {k: max(r[k] for r in real) for k in real[0]}
    return ShardPlan(bounds=bounds, pads=pads, real=real)


def slice_ref(ref: CompiledRef, c0: int, c1: int) -> CompiledRef:
    """The CompiledRef restricted to chromosomes [c0, c1), keeping GLOBAL
    chrom ids and full-length segment arrays (zero-width outside the range).
    Pure slicing: every table is sorted by chrom."""
    u0, u1 = int(ref.uspan_seg[c0]), int(ref.uspan_seg[c1])
    mbs0 = int(ref.uspan_mbs_off[u0])
    i_sel = (ref.intron_chrom >= c0) & (ref.intron_chrom < c1)
    i0 = int(np.argmax(i_sel)) if i_sel.any() else 0
    i1 = i0 + int(i_sel.sum())
    s0, s1 = int(ref.bstart_seg[c0]), int(ref.bstart_seg[c1])
    e0, e1 = int(ref.bend_seg[c0]), int(ref.bend_seg[c1])
    x0, x1 = int(ref.upair_seg[c0]), int(ref.upair_seg[c1])
    p0, p1 = int(ref.point_seg[c0]), int(ref.point_seg[c1])
    r0, r1 = int(ref.roi_seg[c0]), int(ref.roi_seg[c1])
    ro0 = int(ref.intron_run_off[i0])
    ro1 = int(ref.intron_run_off[i1])
    return CompiledRef(
        chroms=list(ref.chroms),
        intron_chrom=ref.intron_chrom[i0:i1],
        intron_start=ref.intron_start[i0:i1],
        intron_end=ref.intron_end[i0:i1],
        intron_strand=ref.intron_strand[i0:i1],
        intron_class=ref.intron_class[i0:i1],
        intron_names=list(ref.intron_names[i0:i1]),
        uspan_start=ref.uspan_start[u0:u1],
        uspan_end=ref.uspan_end[u0:u1],
        uspan_mbs_off=(ref.uspan_mbs_off[u0 : u1 + 1] - mbs0),
        uspan_seg=_seg_slice(ref.uspan_seg, u0, u1),
        intron_run_off=(ref.intron_run_off[i0 : i1 + 1] - ro0).astype(np.int32),
        run_mbs_start=(ref.run_mbs_start[ro0:ro1] - mbs0),
        run_len=ref.run_len[ro0:ro1],
        bstart_coord=ref.bstart_coord[s0:s1],
        bstart_seg=_seg_slice(ref.bstart_seg, s0, s1),
        bend_coord=ref.bend_coord[e0:e1],
        bend_seg=_seg_slice(ref.bend_seg, e0, e1),
        upair_start=ref.upair_start[x0:x1],
        upair_end=ref.upair_end[x0:x1],
        upair_seg=_seg_slice(ref.upair_seg, x0, x1),
        point_coord=ref.point_coord[p0:p1],
        point_seg=_seg_slice(ref.point_seg, p0, p1),
        intron_bstart_idx=(ref.intron_bstart_idx[i0:i1] - s0),
        intron_bend_idx=(ref.intron_bend_idx[i0:i1] - e0),
        intron_pair_idx=(ref.intron_pair_idx[i0:i1] - x0),
        intron_pstart_idx=(ref.intron_pstart_idx[i0:i1] - p0),
        intron_pend_idx=(ref.intron_pend_idx[i0:i1] - p0),
        roi_start=ref.roi_start[r0:r1],
        roi_end=ref.roi_end[r0:r1],
        roi_seg=_seg_slice(ref.roi_seg, r0, r1),
        roi_strand=ref.roi_strand[r0:r1],
        roi_names=list(ref.roi_names[r0:r1]),
    )


def build_stacked_dref(ref: CompiledRef, plan: ShardPlan) -> DeviceRef:
    """Per-shard DeviceRefs with uniform padded shapes, stacked leaf-wise
    into one pytree with a leading genome-shard axis."""
    drefs = [
        build_device_ref(slice_ref(ref, plan.bounds[i], plan.bounds[i + 1]), pads=plan.pads)
        for i in range(len(plan.bounds) - 1)
    ]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *drefs)


def make_genome_sharded_step(mesh: Mesh, axis: str = "genome"):
    """Jitted step over a genome-sharded stacked DeviceRef: batch replicated,
    dref + counters sharded on `axis`.  Counter semantics per shard are
    DISJOINT slices of the genome, so the merge is concatenation (host side),
    not a sum."""

    def local(dref, counters, batch):
        d = jax.tree_util.tree_map(lambda v: v[0], dref)
        c = {k: v[0] for k, v in counters.items()}
        c = count_step(d, c, batch)
        return {k: v[None] for k, v in c.items()}

    def step(dref, counters, batch):
        drspec = jax.tree_util.tree_map(lambda _: P(axis), dref)
        cspec = {k: P(axis) for k in counters}
        bspec = {k: P() for k in batch}
        fn = jax.shard_map(
            local, mesh=mesh, in_specs=(drspec, cspec, bspec), out_specs=cspec,
            # the body is purely per-shard (no collectives), so the
            # varying-axes check has nothing to verify
            check_vma=False,
        )
        return fn(dref, counters, batch)

    jitted = jax.jit(step, donate_argnums=(1,))

    def place(tree, spec_leading=True):
        sh = NamedSharding(mesh, P(axis))
        rep = NamedSharding(mesh, P())
        return jax.tree_util.tree_map(
            lambda v: jax.device_put(v, sh if spec_leading else rep), tree
        )

    return jitted, place


def make_dp_genome_step(
    mesh: Mesh, dp_axis: str = "dp", g_axis: str = "genome", routed: bool = False
):
    """The composed 2D sharding (SURVEY.md §2 row 21): read stream sharded
    over `dp_axis`, reference map sharded over `g_axis`, counters carried per
    (dp, genome) device and merged as sum-over-dp then concat-over-genome.
    This is the whole-genome multi-chip configuration (BASELINE config E).

    routed=False replicates each dp-shard batch to every genome shard
    (non-owned queries self-neutralize; simple, but compute scales xG
    redundantly).  routed=True expects a route_flat_batch() batch whose flat
    columns are sharded over BOTH axes — each genome shard only sees reads
    on its own chromosomes, removing the redundancy at the cost of a cheap
    host-side partition (reads are already chrom-tagged).  Pass
    routed=True to reassemble_counters as well (chr/frag tallies become
    per-shard partial sums instead of replicas)."""

    def local(dref, counters, batch):
        d = jax.tree_util.tree_map(lambda v: v[0], dref)
        c = {k: v[0, 0] for k, v in counters.items()}
        c = count_step(d, c, batch)
        return {k: v[None, None] for k, v in c.items()}

    bshard = P((dp_axis, g_axis)) if routed else P(dp_axis)

    def step(dref, counters, batch):
        drspec = jax.tree_util.tree_map(lambda _: P(g_axis), dref)
        cspec = {k: P(dp_axis, g_axis) for k in counters}
        bspec = {k: bshard for k in batch}
        fn = jax.shard_map(
            local, mesh=mesh, in_specs=(drspec, cspec, bspec), out_specs=cspec,
            # the body is purely per-shard (no collectives), so the
            # varying-axes check has nothing to verify
            check_vma=False,
        )
        return fn(dref, counters, batch)

    jitted = jax.jit(step, donate_argnums=(1,))

    def place_dref(sdref):
        sh = NamedSharding(mesh, P(g_axis))
        return jax.tree_util.tree_map(lambda v: jax.device_put(v, sh), sdref)

    def place_counters(counters):
        sh = NamedSharding(mesh, P(dp_axis, g_axis))
        return {k: jax.device_put(v, sh) for k, v in counters.items()}

    def place_batch(batch):
        sh = NamedSharding(mesh, bshard)
        return {k: jax.device_put(v, sh) for k, v in batch.items()}

    return jitted, place_dref, place_counters, place_batch


def _round_cap(x: int) -> int:
    """Next quarter-power-of-two >= x (power of two with 2 mantissa bits):
    shape-rounding padding stays <= 25% (plain pow2 rounding wasted up to
    ~100% on skewed cells — round-3 verdict #6) while caps still take O(log)
    distinct values, so the monotonic min_caps floor keeps the number of
    jitted-step re-specializations small."""
    if x <= 1:
        return 1
    base = 1 << (int(x).bit_length() - 1)  # largest pow2 <= x
    if base == x:
        return x
    step = max(1, base // 4)
    return base + -(-(x - base) // step) * step


def route_flat_batch(
    plan: ShardPlan,
    batch: dict,
    n_dp: int,
    n_g: int,
    lane: int = 128,
    min_caps: tuple = (0, 0),
) -> tuple[dict, np.ndarray]:
    """Partition a device-batch column dict by (dp chunk, owning genome
    shard) into flat columns shardable with P((dp, genome)).

    Rows are assigned to dp chunks contiguously (matching P(dp) slicing of
    the replicated path) and to genome shards by chromosome ownership
    (plan.bounds); pad rows (chrom < 0) are dropped.  Every (dp, g) cell is
    padded to the max cell population rounded UP TO A POWER OF TWO (floored
    by `lane` and min_caps), so a streaming pipeline sees only O(log) distinct
    shapes — each new shape re-specializes the jitted sharded step, and
    per-batch max-cell rounding caused one compile per batch.  min_caps:
    (block_cap, frag_cap) floors a caller carries between batches to pin the
    shapes monotonically.  Returns (batch dict, (n_dp, n_g) fragment counts
    per cell)."""
    bounds = np.asarray(plan.bounds)
    blk_cols = ("blk_chrom", "blk_start", "blk_end", "blk_strand")
    frag_cols = (
        "frag_chrom", "frag_refid", "frag_start", "frag_end", "frag_strand",
        "frag_nblk",
    )
    out: dict = {}
    counts = None
    for (cols, chrom_col), min_cap in zip(
        ((blk_cols, "blk_chrom"), (frag_cols, "frag_chrom")), min_caps
    ):
        chrom = np.asarray(batch[chrom_col])
        B = chrom.shape[0]
        if B % n_dp:
            raise ValueError(f"column length {B} not divisible by n_dp={n_dp}")
        sub = B // n_dp
        dp_of = np.arange(B) // sub
        valid = chrom >= 0
        g_of = np.searchsorted(bounds, chrom, side="right") - 1
        g_of = np.clip(g_of, 0, n_g - 1)
        cell = dp_of * n_g + g_of
        n_cells = n_dp * n_g
        if n_dp == 1 and n_g <= 16:
            # fast path (the binned single-device form routes EVERY batch
            # through here — measured 42.7 s of host argsort across a 50M-read
            # config C run): G flatnonzero passes replace the stable sort,
            # preserving in-cell order by construction
            parts = [np.flatnonzero(valid & (g_of == g)) for g in range(n_g)]
            cellcnt = np.array([p.size for p in parts], dtype=np.int64)
            src = (
                np.concatenate(parts)
                if parts
                else np.zeros(0, np.int64)
            )
            cell_sorted = np.repeat(np.arange(n_cells), cellcnt)
        else:
            # stable order within each cell preserves read order per shard
            order = np.argsort(np.where(valid, cell, n_cells), kind="stable")
            cellcnt = np.bincount(cell[valid], minlength=n_cells)
            n_valid = int(valid.sum())
            src = order[:n_valid]  # valid rows, grouped by cell
            cell_sorted = cell[src]
        cap = max(lane, int(min_cap), _round_cap(int(cellcnt.max())))
        cap = int(-(-cap // lane) * lane)
        within = np.arange(len(src)) - np.repeat(
            np.concatenate([[0], np.cumsum(cellcnt)[:-1]]), cellcnt
        )
        dst = cell_sorted * cap + within
        for nm in cols:
            col = np.asarray(batch[nm])
            fill = -1 if nm in ("blk_chrom", "frag_chrom", "frag_refid") else 0
            o = np.full(n_dp * n_g * cap, fill, dtype=col.dtype)
            o[dst] = col[src]
            out[nm] = o
        if chrom_col == "frag_chrom":
            counts = cellcnt.reshape(n_dp, n_g)
    return out, counts


@jax.jit
def merge_dp(counters: dict) -> dict:
    """Deterministic integer sum over the dp axis -> (G, L) per-genome-shard
    counters ready for reassemble_counters()."""
    return {k: v.sum(axis=0) for k, v in counters.items()}


def init_dp_genome_counters(
    sdref: DeviceRef, n_refids: int, n_dp: int, n_shards: int
) -> dict:
    base = init_stacked_counters(sdref, n_refids, n_shards)
    return {k: jnp.zeros((n_dp,) + v.shape, v.dtype) for k, v in base.items()}


def init_stacked_counters(sdref: DeviceRef, n_refids: int, n_shards: int) -> dict:
    """Counters per genome shard: (G, L) — L from the PADDED layout, equal
    across shards."""
    d0 = jax.tree_util.tree_map(lambda v: v[0], sdref)
    lay = CounterLayout.build(d0)
    return {
        "cnt": jnp.zeros((n_shards, lay.total), dtype=jnp.int32),
        "chr": jnp.zeros((n_shards, n_refids + 1), dtype=jnp.int32),
    }


def reassemble_counters(
    ref: CompiledRef, plan: ShardPlan, per_shard, n_refids: int,
    routed: bool = False, with_depth: bool = True,
) -> dict:
    """Host-side merge: slice each shard's flat cnt with the (uniform padded)
    layout, drop per-shard padding using the plan's real sizes, concatenate in
    chromosome order.  Produces exactly the finalize_device() output an
    unsharded run yields (tests assert integer equality).

    per_shard: the merged (G, ...) counters dict ({"cnt", "chr"}).  Leaves may
    still live on device: every section is sliced BEFORE np.asarray, so only
    the needed bytes cross D2H.  with_depth=False skips the depth section
    entirely (out["depth"] = None) — the device-stats finalize reassembles
    depth on device instead (reassemble_depth_device) and the depth pull is
    ~2.4 GB at whole-genome scale."""
    if not isinstance(per_shard, dict):
        raise TypeError("reassemble_counters now takes the counters dict")
    stacked_cnt = per_shard["cnt"]
    stacked_chr = np.asarray(per_shard["chr"])
    pads = plan.pads
    lay = CounterLayout(mbs=pads["mbs"], P=pads["point"], R=pads["roi"])

    def sect2(i, off, w, keep):
        return np.asarray(stacked_cnt[i, off : off + 2 * w]).reshape(2, w)[:, :keep]

    parts = {k: [] for k in ("depth", "span_hits", "roi_cnt")}
    for i in range(len(plan.real)):
        r = plan.real[i]
        if with_depth:
            dd = sect2(i, lay.off_dd, lay.mbs + 1, r["mbs"] + 1)
            parts["depth"].append(np.cumsum(dd, axis=1)[:, :-1])
        sp = sect2(i, lay.off_p, lay.P + 1, r["point"] + 1)
        parts["span_hits"].append(np.cumsum(sp, axis=1)[:, :-1])
        parts["roi_cnt"].append(sect2(i, lay.off_roi, lay.R + 1, r["roi"]))
    if not with_depth:
        parts.pop("depth")
    out = {k: np.concatenate(v, axis=1).astype(np.int32) for k, v in parts.items()}
    if not with_depth:
        out["depth"] = None
    nf = np.asarray(stacked_cnt[:, lay.off_nf])
    if routed:
        # routed batches: each genome shard counted only its own chroms'
        # fragments — the global tallies are the per-shard sums
        out["chr_frag"] = stacked_chr.sum(axis=0)[:n_refids].astype(np.int32)
        out["n_frags"] = nf.sum().astype(np.int32)
    else:
        # replicated batches: every genome shard sees the full fragment
        # stream, so shard 0's dense per-refid tally is already global
        out["chr_frag"] = stacked_chr[0][:n_refids]
        out["n_frags"] = nf[0]
    return out


def make_depth_reassemble(plan: ShardPlan):
    """Jitted device-side depth reassembly: merged (G, L) flat counters ->
    the global (2, mbs_total) depth plane, staying ON device so the
    device-stats finalize (ops/finalize_stats.py) never pulls it.  Bit-equal
    to the host path in reassemble_counters (cumsum per shard over the real
    slice, concatenated in chromosome order)."""
    pads = plan.pads
    lay = CounterLayout(mbs=pads["mbs"], P=pads["point"], R=pads["roi"])
    reals = [r["mbs"] for r in plan.real]

    def go(cnt):
        from ..ops.prefix import cumsum_last

        parts = []
        for i, rm in enumerate(reals):
            dd = jax.lax.dynamic_slice_in_dim(
                cnt[i], lay.off_dd, 2 * (lay.mbs + 1)
            ).reshape(2, lay.mbs + 1)[:, : rm + 1]
            parts.append(cumsum_last(dd)[:, :-1])
        return jnp.concatenate(parts, axis=1).astype(jnp.int32)

    return jax.jit(go)
