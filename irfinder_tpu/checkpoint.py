"""Checkpoint / resume for long counting runs (SURVEY.md §5.3-5.4).

The reference has no restartability: a killed run is redone from scratch [R].
Here the whole accumulation state is tiny and additive — one flat int32
counter vector (O(#introns + MBS)) plus the host-side sparse junction tally —
so a snapshot every N batches makes 50M-read runs (BASELINE config C) cheaply
recoverable.

Resume strategy: the snapshot records the decoder's RESUME TOKEN (logical
BGZF-stream offset + mate-pairing carry state, io/bampy.py format, shared
bit-for-bit by the native and Python decoders).  Resume re-opens the BAM with
the token: the decoder seeks to the offset by per-block header arithmetic
(no inflation of the skipped prefix), so resume cost is independent of
position in the BAM.  Snapshots from before the token existed still resume
via the legacy re-decode-and-skip path (engine.run_bam).

Snapshots are written atomically (tmp + rename) as one UNCOMPRESSED .npz:
whole-genome counters are ~2.4 GB and savez_compressed stalls the stream for
tens of seconds per snapshot; raw writes are disk-bandwidth-bound.

A snapshot pulls the whole counter vector off the device.  Counter values
are small ints, so the device packs the flat counter vector to int8 plus an
EXACT overflow escape list (positions with |v| > 127, typically a vanishing
fraction) — a 4x smaller pull and file, losslessly reconstructed on load.
Whether the pack pays on a PCIe-attached card is not measured yet.
IRTPU_CKPT_PACK=0 disables.
"""

from __future__ import annotations

import os

import numpy as np

#: overflow index list padding quantum (each distinct padded size compiles
#: one extraction program)
_OVER_QUANTUM = 1 << 16
_PACK_CACHE: dict = {}


def _pack_host(a: np.ndarray) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """Host-side pack (same layout as the device path: little-endian
    int8 lanes in uint32 words).  Used for numpy inputs and MESH-SHARDED
    counters — pulling the output of a jitted nonzero over a sharded input
    deadlocks on the multi-device CPU backend (jax bug, reproduced
    2026-08-21), and on real multi-chip hosts the D2H is local PCIe anyway
    so the pull-reduction matters less than the disk reduction."""
    flat = np.asarray(a).reshape(-1)
    v8 = np.clip(flat, -128, 127).astype(np.int8)
    over = np.nonzero((flat > 127) | (flat < -128))[0]
    pad = (-v8.size) % 4
    if pad:
        v8 = np.concatenate([v8, np.zeros(pad, np.int8)])
    words = np.frombuffer(v8.tobytes(), np.uint32).copy()
    return words, over.astype(np.int64), flat[over].astype(np.int32)


def _pull_packed_i8(cnt) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """Device-side int8 pack of a counter array, bit-packed 4 lanes per
    uint32 word.  Returns host-side (words uint32 of
    ceil(size/4), over_idx int64 flat positions, over_vals int32).
    cnt must be an int32 array (jax or numpy)."""
    import jax
    import jax.numpy as jnp

    dev_set = getattr(getattr(cnt, "sharding", None), "device_set", None)
    if isinstance(cnt, np.ndarray) or (dev_set is not None and len(dev_set) > 1):
        return _pack_host(np.asarray(cnt))
    arr = jnp.asarray(cnt)
    shape = arr.shape
    key = ("pack8", shape)
    fns = _PACK_CACHE.get(key)
    if fns is None:

        def _pack(c):
            # 1D strided-slice packing: byte lanes as int32 arithmetic keep
            # everything 1D (no (N, 4) intermediate) and let XLA fuse the
            # clip into the four strided reads.
            flat = c.reshape(-1)
            pad = (-flat.size) % 4
            flat = jnp.pad(flat, (0, pad))
            v = jnp.clip(flat, -128, 127).astype(jnp.uint32) & 0xFF
            words = (
                v[0::4] | (v[1::4] << 8) | (v[2::4] << 16) | (v[3::4] << 24)
            )
            return words, (jnp.abs(c.reshape(-1)) > 127).sum()

        _PACK_CACHE[key] = fns = {"pack": jax.jit(_pack)}
    words, n_over = fns["pack"](arr)
    n_over = int(n_over)
    if n_over == 0:
        return np.asarray(words), np.zeros(0, np.int64), np.zeros(0, np.int32)
    K = -(-n_over // _OVER_QUANTUM) * _OVER_QUANTUM
    ex = fns.get(("extract", K))
    if ex is None:
        def _extract(c):
            flat = c.reshape(-1)
            (idx,) = jnp.nonzero(jnp.abs(flat) > 127, size=K, fill_value=0)
            return idx, flat[idx]

        fns[("extract", K)] = ex = jax.jit(_extract)
    idx, vals = ex(arr)
    return (
        np.asarray(words),
        np.asarray(idx[:n_over]).astype(np.int64),
        np.asarray(vals[:n_over]).astype(np.int32),
    )


def _unpack_words(words: np.ndarray, shape, over_idx, over_vals) -> np.ndarray:
    """Host inverse of _pull_packed_i8: uint32 words -> int32 counters."""
    size = int(np.prod(shape))
    flat = (
        np.frombuffer(np.ascontiguousarray(words).tobytes(), np.int8)[:size]
        .astype(np.int32)
    )
    if len(over_idx):
        flat[np.asarray(over_idx)] = np.asarray(over_vals)
    return flat.reshape(shape)


def save_checkpoint(path: str, st, engine=None) -> None:
    """Snapshot a SampleState: counters (packed D2H), junction tally,
    progress, decoder resume token."""
    from .junctions import coerce_tally

    keys, vals = coerce_tally(st.junc_tally).merged()  # (n,3)/(n,2) int64
    tmp = path + ".tmp"
    token = np.frombuffer(st.resume_token, dtype=np.uint8) if st.resume_token else np.zeros(0, np.uint8)
    fields = {}
    if os.environ.get("IRTPU_CKPT_PACK", "1") != "0":
        cnt_arr = st.counters["cnt"]
        words, oidx, ovals = _pull_packed_i8(cnt_arr)
        fields.update(
            cnt_words=words, over_idx=oidx, over_vals=ovals,
            cnt_shape=np.asarray(cnt_arr.shape, np.int64),
        )
    else:
        fields.update(cnt=np.asarray(st.counters["cnt"]))
    np.savez(
        tmp,
        chrn=np.asarray(st.counters["chr"]),
        junc_keys=keys,
        junc_vals=vals,
        batches_done=np.int64(st.metrics.batches),
        n_refids=np.int64(st.n_refids),
        resume_token=token,
        **fields,
    )
    # np.savez appends .npz when missing
    actual_tmp = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(actual_tmp, path)


def load_checkpoint(path: str):
    """Returns ((cnt, chr) ndarrays, JuncTally, batches_done, n_refids,
    resume_token-or-None) or None when no checkpoint exists."""
    from .junctions import JuncTally

    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "cnt_words" in z:
            cnt = _unpack_words(
                z["cnt_words"], tuple(z["cnt_shape"]),
                z["over_idx"], z["over_vals"],
            )
        else:
            cnt = z["cnt"]
        if "chrn" not in z:
            raise ValueError(
                f"checkpoint {path} uses the old single-array counter layout "
                "(before the per-refid tally split); it cannot be resumed — "
                "delete it and rerun"
            )
        chrn = z["chrn"]
        tally = JuncTally()
        tally.add_rows(z["junc_keys"], z["junc_vals"])
        token = bytes(z["resume_token"].tobytes()) if "resume_token" in z else b""
        return (
            (cnt, chrn),
            tally,
            int(z["batches_done"]),
            int(z["n_refids"]),
            token or None,
        )


def restore_state(engine, ckpt) -> "SampleState":
    """Build a SampleState out of a loaded checkpoint tuple."""
    import jax.numpy as jnp

    (cnt, chrn), tally, batches_done, n_refids = ckpt[:4]
    token = ckpt[4] if len(ckpt) > 4 else None
    st = engine.new_state(n_refids=n_refids)
    if (
        st.counters["cnt"].shape != cnt.shape
        or st.counters["chr"].shape != chrn.shape
    ):
        raise ValueError(
            "checkpoint counter shape mismatch: reference or refid count "
            f"changed ({st.counters['cnt'].shape} vs {cnt.shape})"
        )
    st.counters = {"cnt": jnp.asarray(cnt), "chr": jnp.asarray(chrn)}
    st.junc_tally = tally
    st.metrics.batches = batches_done
    st.resume_token = token
    return st
