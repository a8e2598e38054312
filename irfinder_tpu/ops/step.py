"""The jitted per-batch counting step — the engine's "processor chain".

The reference invoked four virtual processors serially per fragment
(SURVEY.md §2 row 9, historical ReadBlockProcessor::ProcessBlocks [R]); here
all of them are one XLA program over a whole PackedBatch:

* CoverageBlocks  -> two +1/-1 updates per block into a depth *diff* region
  over measured-base space (exclusion masking is pure rank arithmetic, see
  refio/compile.py); depth itself is recovered by one cumsum at finalize.
* SpansPoint      -> bucketed rank-range of each block against the boundary
  point table, as another diff region (+1 first spanned point, -1 past last).
* FragmentsInROI  -> dense broadcast interval overlap (ROI tables are tiny).
* FragmentsInChr  -> dense per-refid count.
* JunctionCount   is NOT on the device: splice gaps are a small sparse subset
  of the read stream, and the host already tallies unique (chrom,start,end)
  junctions per batch for IRFinder-JuncCount.txt (engine._tally_junctions);
  per-intron SpliceLeft/Right/Exact are derived from that tally at finalize
  (finalize.junction_counters).  Moving them off-device deletes 3 bucketed
  match passes + 3 gap scatter updates per gap from the hot step AND the gap
  columns from every H2D transfer (measured ~30%% of step time).

Design:

1. All searches are BucketTable ranks (ops/bucket.py).
2. All counters live in ONE flat int32 array ("cnt") and every processor's
   updates are concatenated into a SINGLE scatter-add per batch.  Sections
   of cnt are laid out by `CounterLayout`; each section carries a trailing
   trash slot that miss/pad lanes are routed to and finalize drops.
3. The step donates cnt, so XLA updates it in place.

Everything is integer and add-associative, so counters are invariant under
batch order, batch size, and shard count (the determinism contract of
SURVEY.md §5.8).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import semantics as S
from .device_ref import DeviceRef, mbs_rank
from .scatter import scatter_add


@dataclasses.dataclass(frozen=True)
class CounterLayout:
    """Static offsets of each counter section inside the flat cnt array.

    Sections (all int32):
      dd   (2, mbs+1)      depth diff over MBS, per strand     [cumsum later]
      p    (2, P+1)        spans diff over boundary points     [cumsum later]
      roi  (2, R+1)        fragments per ROI, per strand
      nf   (1,)            admitted fragments

    Per-refid fragment tallies live in a separate small dense array
    (counters["chr"], updated by broadcast-compare, never scattered into) so
    the flat layout is derivable from the DeviceRef alone.  Junction counters
    live host-side — see the module docstring.
    """

    mbs: int
    P: int
    R: int

    @staticmethod
    def build(dref: DeviceRef) -> "CounterLayout":
        sz = dref.sizes()
        return CounterLayout(mbs=dref.mbs_size, P=sz["P"], R=sz["R"])

    # widths of one strand row per section
    @property
    def w_dd(self):
        return self.mbs + 1

    @property
    def w_p(self):
        return self.P + 1

    @property
    def off_dd(self):
        return 0

    @property
    def off_p(self):
        return self.off_dd + 2 * (self.mbs + 1)

    @property
    def off_roi(self):
        return self.off_p + 2 * (self.P + 1)

    @property
    def off_nf(self):
        return self.off_roi + 2 * (self.R + 1)

    @property
    def total(self):
        return self.off_nf + 1


def layout_from_counters(dref: DeviceRef, counters: dict = None) -> CounterLayout:
    """The layout is a pure function of the DeviceRef (kept under the old
    name for callers; the counters arg is vestigial)."""
    return CounterLayout.build(dref)


def init_counters(dref: DeviceRef, n_refids: int) -> dict:
    lay = CounterLayout.build(dref)
    return {
        "cnt": jnp.zeros(lay.total, dtype=jnp.int32),
        "chr": jnp.zeros(n_refids + 1, dtype=jnp.int32),
    }


def count_step(dref: DeviceRef, counters: dict, batch: dict) -> dict:
    """One PackedBatch through every counter: bucketed searches, then ONE
    fused scatter-add into the flat counter array.  Pure function; jit with
    donate_argnums=(1,) via make_count_step()."""
    lay = layout_from_counters(dref, counters)
    cnt = counters["cnt"]

    blk_c, blk_s, blk_e = batch["blk_chrom"], batch["blk_start"], batch["blk_end"]
    blk_st = batch["blk_strand"]
    B = blk_c.shape[0]

    # --- CoverageBlocks: MBS rank of both edges in one bucketed pass --------
    r2 = mbs_rank(
        dref,
        jnp.concatenate([blk_c, blk_c]),
        jnp.concatenate([blk_s, blk_e]),
    )
    lo, hi = r2[:B], r2[B:]
    # --- SpansPoint: rank-range diff over boundary points -------------------
    OH = jnp.int32(S.SPANS_OVERHANG)
    plo = dref.point_bt.rank((blk_c, blk_s + OH), side="left")
    phi = dref.point_bt.rank((blk_c, blk_e - OH), side="right")
    ok = (blk_c >= 0) & (blk_e - blk_s >= 2 * OH)
    plo = jnp.where(ok, plo, lay.P)
    phi = jnp.where(ok, phi, lay.P)
    p_base = lay.off_p + blk_st * lay.w_p
    idx_sp = jnp.concatenate([p_base + plo, p_base + phi])

    dd_base = lay.off_dd + blk_st * lay.w_dd
    idx_cov = jnp.concatenate([dd_base + lo, dd_base + hi])
    # both sections take the same (+1 x B, -1 x B) update pattern
    val_cov = jnp.concatenate([jnp.ones(B, jnp.int32), jnp.full(B, -1, jnp.int32)])

    # --- FragmentsInChr: dense per-refid count (refid count is tiny, so a
    # broadcast compare-sum beats adding F more scatter updates) -------------
    f_rid = batch["frag_refid"]
    n_refids = counters["chr"].shape[-1] - 1
    rid = jnp.where((f_rid >= 0) & (f_rid < n_refids), f_rid, n_refids)
    chr_counts = jnp.sum(
        rid[:, None]
        == jax.lax.broadcasted_iota(jnp.int32, (1, n_refids + 1), 1),
        axis=0,
        dtype=jnp.int32,
    )

    # --- ONE fused scatter over all processors ----------------------------
    cnt = scatter_add(
        cnt,
        jnp.concatenate([idx_cov, idx_sp]),
        jnp.concatenate([val_cov, val_cov]),
    )
    chrn = counters["chr"] + chr_counts

    # --- FragmentsInROI: dense broadcast overlap (tiny table) ---------------
    f_c, f_s, f_e = batch["frag_chrom"], batch["frag_start"], batch["frag_end"]
    f_st = batch["frag_strand"]
    overlap = (
        (f_c[:, None] == dref.roi_chrom[None, :-1])
        & (dref.roi_start[None, :-1] < f_e[:, None])
        & (f_s[:, None] < dref.roi_end[None, :-1])
    )
    hits0 = jnp.sum(overlap & (f_st == 0)[:, None], axis=0, dtype=jnp.int32)
    hits1 = jnp.sum(overlap & (f_st == 1)[:, None], axis=0, dtype=jnp.int32)
    cnt = cnt.at[lay.off_roi : lay.off_roi + lay.R].add(hits0)
    cnt = cnt.at[lay.off_roi + lay.R + 1 : lay.off_roi + 2 * lay.R + 1].add(hits1)

    # --- fragment total -----------------------------------------------------
    cnt = cnt.at[lay.off_nf].add(jnp.sum(f_rid >= 0, dtype=jnp.int32))

    return {"cnt": cnt, "chr": chrn}


_JIT_CACHE: dict = {}


def make_count_step():
    """Jitted step with in-place counter donation.  Process-global: every
    Engine shares ONE jit instance, so a second engine in the same process
    (bench warm/main runs, batch mode) never re-traces or re-compiles."""
    step = _JIT_CACHE.get("step")
    if step is None:
        step = _JIT_CACHE["step"] = jax.jit(count_step, donate_argnums=(1,))
    return step


def make_fused_step(cap_blocks: int, cap_frags: int):
    """Jitted step taking ONE fused int32 H2D buffer (io/batch.py fused_h2d /
    unpack_fused): a single device_put per batch instead of nine.  Also
    process-global per capacity signature."""
    key = ("fused", cap_blocks, cap_frags)
    step = _JIT_CACHE.get(key)
    if step is None:
        from ..io.batch import unpack_fused

        def fstep(dref, counters, flat):
            return count_step(
                dref, counters, unpack_fused(flat, cap_blocks, cap_frags)
            )

        step = _JIT_CACHE[key] = jax.jit(fstep, donate_argnums=(1,))
    return step


def make_finalize():
    fin = _JIT_CACHE.get("finalize")
    if fin is None:
        fin = _JIT_CACHE["finalize"] = jax.jit(finalize_device)
    return fin


def finalize_device(dref: DeviceRef, counters: dict) -> dict:
    """Flat cnt -> named dense counters (diff regions cumsummed, trash slots
    dropped).  Jittable; runs once at end-of-stream."""
    lay = layout_from_counters(dref)
    cnt = counters["cnt"]

    def sect2(off, w):
        return cnt[off : off + 2 * w].reshape(2, w)

    from .prefix import cumsum_last

    # two-level prefix (ops/prefix.py): a flat cumsum over whole-genome MBS
    # is ~28 full-array XLA passes; this is bit-identical and memory-bound
    depth = cumsum_last(sect2(lay.off_dd, lay.mbs + 1))[:, :-1]
    span_hits = cumsum_last(sect2(lay.off_p, lay.P + 1))[:, :-1]
    return {
        "depth": depth,
        "span_hits": span_hits,
        "roi_cnt": sect2(lay.off_roi, lay.R + 1)[:, :-1],
        "chr_frag": counters["chr"][:-1],
        "n_frags": cnt[lay.off_nf],
    }
