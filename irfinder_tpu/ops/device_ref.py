"""Device-resident reference tensors.

The reference loaded its REF directory into per-chromosome std::map /
sorted-vector processor state (SURVEY.md §2 rows 9-12, historical
src/irfinder/main.cpp + ReadBlockProcessor*.cpp [R]); the engine instead
keeps ONE globally sorted (chrom, coord) table per lookup kind in device
memory, padded
with a single sentinel row so that

* lexicographic binary search never needs per-chromosome branching,
* the sentinel row doubles as the scatter "trash slot": query lanes that miss
  (including batch padding with chrom == -1) are routed to index ``n`` and the
  counter arrays carry one extra trailing slot that is dropped at finalize.

All columns are int32: every genomic coordinate and MBS offset fits (human
MBS ≈ 1.3e9 < 2^31), and every device counter is an int32 too.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..refio.compile import CompiledRef
from .bucket import BucketTable

#: Sentinel chromosome id for pad rows: larger than any real chrom id, so no
#: query (real chrom or -1 padding) ever compares equal or greater.
PAD_CHROM = np.int32(2**31 - 1)


def _chrom_col(seg: np.ndarray) -> np.ndarray:
    """Expand per-chrom segment offsets into a per-row chrom id column."""
    return np.repeat(
        np.arange(len(seg) - 1, dtype=np.int32), np.diff(seg).astype(np.int64)
    )


def _pad_sentinel(*cols: np.ndarray) -> list:
    """Append one sentinel row (first col = PAD_CHROM, rest = 0)."""
    out = [np.concatenate([cols[0], [PAD_CHROM]]).astype(np.int32)]
    for c in cols[1:]:
        out.append(np.concatenate([c, [0]]).astype(np.int32))
    return out


@dataclasses.dataclass(frozen=True)
class DeviceRef:
    """Pytree of device arrays + static sizes.  Built once per run; all jitted
    steps take it as an argument so shardings can be attached externally."""

    # measured-base-space spans (rank lookup): sentinel row has len 0, off=mbs
    uspan_chrom: jnp.ndarray  # (U+1,)
    uspan_start: jnp.ndarray
    uspan_len: jnp.ndarray
    uspan_off: jnp.ndarray  # int32 MBS offsets
    chrom_base: jnp.ndarray  # (n_chroms,) MBS offset of each chrom's first span
    # boundary point table (sentinel-padded).  Junction (start/end/pair)
    # tables have no device columns at all: junction counting is host-side
    # (ops/step.py docstring) and the finalize join reads CompiledRef.
    point_chrom: jnp.ndarray
    point_coord: jnp.ndarray
    # ROI intervals (sentinel-padded)
    roi_chrom: jnp.ndarray
    roi_start: jnp.ndarray
    roi_end: jnp.ndarray
    # bucketed rank tables (ops/bucket.py)
    uspan_bt: BucketTable  # keys (chrom,start); payload (chrom,start,len,off)
    point_bt: BucketTable  # keys (chrom,coord); rank-only
    # static (non-pytree-leaf) metadata — usable inside jit traces
    mbs_size_static: int = 0

    @property
    def mbs_size(self) -> int:
        return self.mbs_size_static

    def sizes(self) -> dict:
        """Real (unpadded) table sizes; counter arrays add 1 trash slot."""
        return {
            "P": int(self.point_coord.shape[0]) - 1,
            "R": int(self.roi_start.shape[0]) - 1,
        }


_STATIC_FIELDS = ("mbs_size_static",)


def _tree_flatten(d: DeviceRef):
    names = [f.name for f in dataclasses.fields(DeviceRef) if f.name not in _STATIC_FIELDS]
    leaves = [getattr(d, n) for n in names]
    aux = tuple(getattr(d, n) for n in _STATIC_FIELDS)
    return leaves, aux


def _tree_unflatten(aux, leaves):
    return DeviceRef(*leaves, *aux)


import jax.tree_util  # noqa: E402

jax.tree_util.register_pytree_node(DeviceRef, _tree_flatten, _tree_unflatten)


def _pad_rows(cols, target):
    """Pad raw table columns to `target` rows with sentinel rows
    (PAD_CHROM, 0, ...).  Sentinel rows sort last and never match queries."""
    n = int(cols[0].shape[0])
    extra = target - n
    if extra < 0:
        raise ValueError("pad target smaller than table")
    if extra == 0:
        return list(cols)
    out = [np.concatenate([cols[0], np.full(extra, PAD_CHROM, np.int32)])]
    for c in cols[1:]:
        out.append(np.concatenate([c, np.zeros(extra, np.int32)]).astype(np.int32))
    return out


def build_device_ref(ref: CompiledRef, pads: dict | None = None, bucket: int = 128) -> DeviceRef:
    """Host CompiledRef -> device tensors (one H2D put per table).

    pads: optional uniform table sizes {uspan,point,roi,mbs}
    so refs of different real sizes share one static shape — required for
    stacking genome shards under one shard_map program (parallel/genome.py).
    Extra rows are lex-+inf sentinels; ranks/matches over real keys are
    unaffected, and dref.uspan_off[-1] still holds the REAL mbs (the trash
    rank), while mbs_size_static (and thus the counter layout) uses the
    padded value."""
    u_chrom = _chrom_col(ref.uspan_seg)
    u_len = (ref.uspan_end - ref.uspan_start).astype(np.int32)
    u_off = ref.uspan_mbs_off[:-1].astype(np.int32) if ref.uspan_start.size else np.zeros(0, np.int32)
    mbs = int(ref.uspan_mbs_off[-1]) if ref.uspan_mbs_off.size else 0
    chrom_base = ref.uspan_mbs_off[ref.uspan_seg[:-1]].astype(np.int32)

    u_start = ref.uspan_start
    pt_c, pt_v = _chrom_col(ref.point_seg), ref.point_coord
    ro_c, ro_s, ro_e = _chrom_col(ref.roi_seg), ref.roi_start, ref.roi_end
    mbs_static = mbs
    if pads:
        u_chrom, u_start, u_len, u_off = _pad_rows(
            (u_chrom, u_start, u_len, u_off), pads["uspan"]
        )
        pt_c, pt_v = _pad_rows((pt_c, pt_v), pads["point"])
        ro_c, ro_s, ro_e = _pad_rows((ro_c, ro_s, ro_e), pads["roi"])
        mbs_static = pads["mbs"]

    uc, us, ul, uo = _pad_sentinel(u_chrom, u_start, u_len, u_off)
    uo[-1] = mbs  # sentinel offset = REAL MBS size (also the trash rank)
    pt = _pad_sentinel(pt_c, pt_v)
    ro = _pad_sentinel(ro_c, ro_s, ro_e)

    uspan_bt = BucketTable.build(
        (u_chrom, u_start),
        payload_cols=(u_chrom, u_start, u_len, u_off),
        bucket=bucket,
    )
    point_bt = BucketTable.build((pt_c, pt_v), bucket=bucket)

    j = jnp.asarray
    return DeviceRef(
        uspan_chrom=j(uc),
        uspan_start=j(us),
        uspan_len=j(ul),
        uspan_off=j(uo),
        chrom_base=j(chrom_base if chrom_base.size else np.zeros(1, np.int32)),
        point_chrom=j(pt[0]),
        point_coord=j(pt[1]),
        roi_chrom=j(ro[0]),
        roi_start=j(ro[1]),
        roi_end=j(ro[2]),
        uspan_bt=uspan_bt,
        point_bt=point_bt,
        mbs_size_static=mbs_static,
    )


def mbs_rank(dref: DeviceRef, chrom: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Vectorized measured-base-space rank (device analog of
    oracle.mbs_rank): number of included bases on `chrom` strictly before
    `pos`.  Pad lanes (chrom < 0) return mbs_size (the trash rank), so a
    padded block contributes +1/-1 at the same diff slot and provably cancels.

    Bucketed rank + one payload row gather + one-hot in-row select
    (ops/bucket.py).
    """
    mbs = dref.uspan_off[-1]  # sentinel slot == total size (trace-safe)
    j = dref.uspan_bt.rank((chrom, pos), side="right") - 1
    pc, ps, pl, po = dref.uspan_bt.entry(j)
    same = (j >= 0) & (pc == chrom)
    within = jnp.clip(pos - ps, 0, pl)
    # chrom -> MBS base offset, via dense one-hot select over the tiny
    # per-chrom table
    n_chroms = dref.chrom_base.shape[0]
    sel = chrom[:, None] == jax.lax.broadcasted_iota(
        jnp.int32, (1, n_chroms), 1
    )
    base = jnp.sum(
        jnp.where(sel, dref.chrom_base[None, :], 0), axis=1, dtype=jnp.int32
    )
    rank = jnp.where(same, po + within, base)
    return jnp.where(chrom >= 0, rank, mbs).astype(jnp.int32)
