"""Mesh-wired end-to-end counting — BASELINE config E as a runnable pipeline.

The round-2 machinery (parallel/shard.py, parallel/genome.py) proved the
shardings integer-exact but was reachable only from tests and hand-assembled
benches.  This module composes it into the same contract as engine.run_bam:

    decode -> [pad / route] -> jitted shard_map step on a Mesh("dp","genome")
           -> deterministic integer merge -> reassemble -> finalize
           -> the full byte-identical output table set.

Three execution shapes, all through one MeshEngine (SURVEY.md §5.7-5.8):

* dp=N              read stream sharded over N devices, map replicated.
* dp=N, genome=G    map sharded over G devices, batch replicated across
                    genome.
* ... routed        host partitions each batch by owning chromosome so every
                    genome shard only counts its own reads (removes the xG
                    redundant compute of the replicated form).
* genome=G on fewer than G devices: the "binned" degenerate mesh on ONE
  device — the same routed partition + per-shard tables, stepped by one
  jitted lax.map over the G bins.  It gives the same tables as the
  unsharded engine.run_bam, which is what a single device normally runs.

Counters are integers and the merge order is fixed, so results are
bit-identical at any (dp, genome) shape — tests/test_engine_mesh.py asserts
the full table set byte-equal sharded vs unsharded.

Reference parity: the reference had no distributed capability (SURVEY.md §2
rows 21-22 [R]); this scale-out design is new, not a port.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable

import jax
import numpy as np
from jax.sharding import Mesh

from . import backend
from .engine import (
    INFLIGHT_BYTES, RunMetrics, SampleState, open_decoder, tally_junctions,
    write_outputs,
)
from .finalize import detect_directionality, intron_table, junction_counters
from .io.batch import PackedBatch
from .ops.step import count_step, _JIT_CACHE
from .parallel.genome import (
    build_stacked_dref,
    init_dp_genome_counters,
    init_stacked_counters,
    make_depth_reassemble,
    make_dp_genome_step,
    merge_dp,
    plan_shards,
    reassemble_counters,
    route_flat_batch,
)
from .parallel.shard import pad_batch_to_multiple
from .refio.compile import CompiledRef


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Parsed --mesh flag: dp=N,genome=G[,routed]."""

    dp: int = 1
    genome: int = 1
    routed: bool = False

    @staticmethod
    def parse(s: str) -> "MeshSpec":
        dp, genome, routed = 1, 1, False
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if part == "routed":
                routed = True
            elif part.startswith("dp="):
                dp = int(part[3:])
            elif part.startswith("genome="):
                genome = int(part[7:])
            else:
                raise ValueError(
                    f"bad --mesh component {part!r} (want dp=N,genome=G[,routed])"
                )
        if dp < 1 or genome < 1:
            raise ValueError("--mesh axes must be >= 1")
        return MeshSpec(dp=dp, genome=genome, routed=routed)

    @property
    def n_devices(self) -> int:
        return self.dp * self.genome


def _make_binned_step(n_bins: int):
    """One jitted step over a stacked (G, ...) DeviceRef on a SINGLE device:
    lax.map over the genome bins, each iteration running the ordinary
    count_step.  Process-global per bin count, like make_count_step."""
    key = ("binned", n_bins)
    step = _JIT_CACHE.get(key)
    if step is None:

        def bstep(sdref, counters, batch):
            def one(args):
                d, c, b = args
                return count_step(d, c, b)

            return jax.lax.map(one, (sdref, counters, batch))

        step = _JIT_CACHE[key] = jax.jit(bstep, donate_argnums=(1,))
    return step


class MeshEngine:
    """One genome-sharded reference + one compiled sharded step; per-sample
    state in engine.SampleState (counters carry mesh shardings).

    Device selection: `devices` (default jax.devices()) must provide
    spec.n_devices devices for a real mesh.  The special case spec.dp == 1
    with fewer than spec.genome devices runs the binned single-device form
    instead (same routed partition, lax.map over bins)."""

    def __init__(
        self,
        ref: CompiledRef,
        spec: MeshSpec,
        devices=None,
        cap_frags: int = 1 << 15,
    ):
        self.ref = ref
        self.spec = spec
        self.cap_frags = cap_frags
        devices = list(devices if devices is not None else jax.devices())
        self.binned = spec.dp == 1 and spec.genome > 1 and len(devices) < spec.genome
        if self.binned and len(devices) >= 1:
            devices = devices[:1]
        elif len(devices) < spec.n_devices:
            raise ValueError(
                f"mesh {spec} needs {spec.n_devices} devices, have {len(devices)}"
            )
        else:
            devices = devices[: spec.n_devices]
        self.devices = devices
        # the binned form replicating the batch over bins on one device would
        # just multiply work xG; it is always routed
        self.routed = bool(spec.routed or self.binned)

        self.plan = plan_shards(ref, spec.genome)
        self.sdref = build_stacked_dref(ref, self.plan)
        if self.binned:
            self.mesh = None
            self._step = _make_binned_step(spec.genome)
            self._place_b = lambda arrays: arrays  # single device: plain put
        else:
            self.mesh = Mesh(
                np.array(devices).reshape(spec.dp, spec.genome), ("dp", "genome")
            )
            (
                self._step,
                place_dref,
                self._place_c,
                self._place_b,
            ) = make_dp_genome_step(self.mesh, routed=self.routed)
            self.sdref = place_dref(self.sdref)
        self._depth_fn = make_depth_reassemble(self.plan)
        # monotonic cell-cap floors: pin the routed batch shapes so the
        # sharded step compiles O(log) times, not once per batch.  The floor
        # starts at HALF the uniform per-cell share (a full-share floor
        # padded every batch ~25%); from here caps grow monotonically to the
        # observed max cell, quarter-pow2-rounded (route_flat_batch), so at
        # most a few extra shape specializations ever compile
        denom = max(1, spec.dp * spec.genome)
        from .io.batch import BLOCKS_PER_FRAG

        self._min_caps = [
            max(128, (cap_frags * BLOCKS_PER_FRAG) // (2 * denom)),
            max(128, cap_frags // (2 * denom)),
        ]
        # device-stats finalize (ops/finalize_stats.py) exactly as Engine
        self._device_stats = backend.device_stats_enabled()
        self._finref = None
        self._finref_thread = None
        if self._device_stats:
            # cached on the ref object exactly as Engine does — rebuilding
            # per MeshEngine steals decode CPU during the stream
            self._finref = getattr(ref, "_irtpu_finref", None)
            if self._finref is None:
                import threading

                def _bg():
                    from .ops.finalize_stats import build_finalize_ref

                    # 1) compile the depth-reassemble program; the zero
                    #    counters + depth transient is freed BEFORE the stats
                    #    prewarm allocates, so the two transients never
                    #    coexist in device memory
                    if os.environ.get("IRTPU_PREWARM") != "0":
                        try:
                            zc = init_stacked_counters(
                                self.sdref, 1, self.spec.genome
                            )
                            d = self._depth_fn(zc["cnt"])
                            jax.block_until_ready(d)
                            del zc, d
                        except Exception:
                            pass  # best-effort
                    # 2) finalize index tables (long host build), then the
                    #    stats program load (its own transient only)
                    try:
                        fr = build_finalize_ref(self.ref)
                        object.__setattr__(self.ref, "_irtpu_finref", fr)
                        self._finref = fr
                        self._prewarm_stats(fr)
                    except Exception:
                        pass

                self._finref_thread = threading.Thread(target=_bg, daemon=True)
                self._finref_thread.start()

    def _prewarm_stats(self, fr) -> None:
        """Compile the fused stats program and ship its device index tables
        DURING the stream (one zero-depth execution on the background finref
        thread), as Engine._prewarm_stats.  IRTPU_PREWARM=0 skips it."""
        import jax.numpy as jnp

        if os.environ.get("IRTPU_PREWARM") == "0":
            return
        try:
            from .ops.finalize_stats import device_all_stats_async

            z = jnp.zeros((2, int(self.ref.mbs_size)), jnp.int32)
            device_all_stats_async(self.ref, fr, z, False)()
        except Exception:
            pass  # prewarm is best-effort; the real finalize surfaces errors

    def _get_finref(self):
        if self._finref_thread is not None:
            self._finref_thread.join()
            self._finref_thread = None
        if self._finref is None:
            from .ops.finalize_stats import build_finalize_ref

            self._finref = build_finalize_ref(self.ref)
            object.__setattr__(self.ref, "_irtpu_finref", self._finref)
        return self._finref

    # -- lifecycle ------------------------------------------------------------
    def new_state(self, n_refids: int) -> SampleState:
        if self.binned:
            counters = init_stacked_counters(self.sdref, n_refids, self.spec.genome)
        else:
            counters = self._place_c(
                init_dp_genome_counters(
                    self.sdref, n_refids, self.spec.dp, self.spec.genome
                )
            )
        return SampleState(counters=counters, n_refids=n_refids)

    def restore_state(self, ckpt) -> SampleState:
        """checkpoint.load_checkpoint tuple -> SampleState with the stacked
        counters re-placed on this mesh (the mesh analog of
        checkpoint.restore_state; snapshots are host ndarrays either way, so
        a snapshot written under one MeshSpec resumes only under the same
        spec — the stacked shapes encode it)."""
        import jax.numpy as jnp

        (cnt, chrn), tally, batches_done, n_refids = ckpt[:4]
        token = ckpt[4] if len(ckpt) > 4 else None
        st = self.new_state(n_refids=n_refids)
        want = {k: tuple(v.shape) for k, v in st.counters.items()}
        got = {"cnt": tuple(cnt.shape), "chr": tuple(chrn.shape)}
        if want != got:
            raise ValueError(
                f"mesh checkpoint shape mismatch (snapshot written under a "
                f"different --mesh or reference?): {got} vs {want}"
            )
        counters = {"cnt": cnt, "chr": chrn}
        if self.binned:
            st.counters = {k: jnp.asarray(v) for k, v in counters.items()}
        else:
            st.counters = self._place_c(counters)
        st.junc_tally = tally
        st.metrics.batches = batches_done
        st.resume_token = token
        return st

    # -- accumulation ----------------------------------------------------------
    def prep_batch(self, b: PackedBatch, m: RunMetrics | None = None):
        """Host side of one batch: pad to the dp split, route by owning
        chromosome (routed modes), reshape for the binned form, and place on
        the mesh.  Runs on the feeder thread in run_stream.  `m` attributes
        routing vs H2D time and the routed padding inflation."""
        arrays = pad_batch_to_multiple(b.device_arrays(), self.spec.dp)
        if self.routed:
            t0 = time.perf_counter()
            arrays, _ = route_flat_batch(
                self.plan,
                arrays,
                self.spec.dp,
                self.spec.genome,
                min_caps=tuple(self._min_caps),
            )
            G = self.spec.dp * self.spec.genome
            self._min_caps[0] = max(self._min_caps[0], len(arrays["blk_chrom"]) // G)
            self._min_caps[1] = max(self._min_caps[1], len(arrays["frag_chrom"]) // G)
            if self.binned:
                arrays = {
                    k: v.reshape(self.spec.genome, -1) for k, v in arrays.items()
                }
            if m is not None:
                m.route_s += time.perf_counter() - t0
                m.route_rows_real += int(b.n_frags)
                m.route_rows_padded += int(arrays["frag_chrom"].size)
        t1 = time.perf_counter()
        placed = jax.device_put(arrays) if self.binned else self._place_b(arrays)
        if m is not None:
            m.h2d_s += time.perf_counter() - t1
        return placed

    def process_batch(self, b: PackedBatch, st: SampleState, placed=None) -> None:
        t0 = time.perf_counter()
        if placed is None:
            placed = self.prep_batch(b)
        st.counters = self._step(self.sdref, st.counters, placed)
        st.metrics.device_s += time.perf_counter() - t0
        st.metrics.batches += 1
        if b.resume_token is not None:
            st.resume_token = b.resume_token
        tally_junctions(st.junc_tally, b)

    def run_stream(
        self, batches: Iterable[PackedBatch], st: SampleState, on_batch=None
    ) -> None:
        """Same feeder/consumer overlap as Engine.run_stream: decode + host
        routing + sharded device_put on the feeder threads, step dispatch +
        junction tally on the consumer, the same in-flight byte bound.
        on_batch(done): consumer-side hook (checkpoint cadence of
        run_bam_mesh)."""
        import queue
        import threading

        from .engine import Engine, STREAM_END, q_get, q_put

        q1: "queue.Queue" = queue.Queue(maxsize=2)  # decode -> route/put
        q2: "queue.Queue" = queue.Queue(maxsize=2)  # route/put -> consumer
        stop = threading.Event()
        m = st.metrics

        def decode_feeder():
            try:
                it = iter(batches)
                while True:
                    t0 = time.perf_counter()
                    try:
                        b = next(it)
                    except StopIteration:
                        break
                    m.decode_s += time.perf_counter() - t0
                    if not q_put(q1, b, stop):
                        return
                q_put(q1, STREAM_END, stop)
            except BaseException as e:
                q_put(q1, e, stop)

        def prep_feeder():
            # host routing + sharded device_put, overlapped with decode
            try:
                while True:
                    item = q_get(q1, stop)
                    if item is STREAM_END or isinstance(item, BaseException):
                        q_put(q2, item, stop)
                        return
                    placed = self.prep_batch(item, m)
                    if not q_put(q2, (item, placed), stop):
                        return
            except BaseException as e:
                q_put(q2, e, stop)

        t_dec = threading.Thread(target=decode_feeder, daemon=True)
        t_prep = threading.Thread(target=prep_feeder, daemon=True)
        t_dec.start()
        t_prep.start()
        done = 0
        inflight = 0
        try:
            while True:
                item = q2.get()
                if item is STREAM_END:
                    break
                if isinstance(item, BaseException):
                    raise item
                b, placed = item
                tally_junctions(st.junc_tally, b)
                t0 = time.perf_counter()
                st.counters = self._step(self.sdref, st.counters, placed)
                m.device_s += time.perf_counter() - t0
                m.batches += 1
                if b.resume_token is not None:
                    st.resume_token = b.resume_token
                inflight += sum(
                    int(v.nbytes) for v in jax.tree_util.tree_leaves(placed)
                )
                if inflight >= INFLIGHT_BYTES:
                    Engine._barrier(st)
                    inflight = 0
                done += 1
                if on_batch is not None:
                    on_batch(done)
            Engine._barrier(st)
        finally:
            stop.set()
            t_dec.join()
            t_prep.join()

    # -- finalize ---------------------------------------------------------------
    def results_async(self, st: SampleState):
        """Dispatch every device program the finalize needs WITHOUT blocking
        and return a zero-arg finisher — Engine.results_async brought to the
        mesh path (round-3 verdict #7): the fused stats program is dispatched
        optimistically with flip=False BEFORE the host junction join, so the
        join (which drains the background tally compaction) overlaps the
        device compute instead of preceding the dispatch."""
        t0 = time.perf_counter()
        per_shard = st.counters if self.binned else merge_dp(st.counters)
        pending = None
        if self._device_stats:
            # depth stays on device: reassembled there and fed straight to
            # the fused stats program; only O(#introns) ever crosses D2H
            depth_dev = self._depth_fn(per_shard["cnt"])  # async dispatch
            from .ops.finalize_stats import device_all_stats_async

            pending = device_all_stats_async(
                self.ref, self._get_finref(), depth_dev, False
            )
        # host work below overlaps the reassemble + stats device programs
        sc, ec, xc = junction_counters(self.ref, st.junc_tally)
        stranded, flip, frac, n_inf = detect_directionality(self.ref, xc)
        st.metrics.is_stranded = bool(stranded)
        st.metrics.flip_strand = bool(flip)
        st.metrics.dir_concordance = float(frac)
        st.metrics.dir_informative = int(n_inf)
        if pending is not None and flip:
            from .ops.finalize_stats import device_all_stats_async

            pending = device_all_stats_async(
                self.ref, self._get_finref(), depth_dev, True
            )
        st.metrics.finalize_s += time.perf_counter() - t0

        def finish() -> dict:
            t1 = time.perf_counter()
            fin = reassemble_counters(
                self.ref,
                self.plan,
                per_shard,
                st.n_refids,
                routed=self.routed,
                with_depth=not self._device_stats,
            )
            cache: dict = {}
            if pending is not None:
                cache.update(pending())
            fc = dict(fin)
            fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"] = sc, ec, xc
            args = (self.ref, fc["depth"], sc, ec, xc, fc["span_hits"])
            out = {
                "counters": fc,
                "rows_nondir": intron_table(*args, mode="nondir", stats_cache=cache),
                "rows_dir": intron_table(
                    *args, mode="dir", flip_strand=flip, stats_cache=cache
                ),
                "stranded": stranded,
                "flip_strand": flip,
            }
            st.metrics.finalize_s += time.perf_counter() - t1
            return out

        return finish

    def results(self, st: SampleState) -> dict:
        """Merge over dp, reassemble over genome, join junctions, build rows
        — the MeshEngine analog of Engine.results()."""
        return self.results_async(st)()


def run_bam_mesh(
    ref: CompiledRef,
    bam,
    out_dir: str,
    spec: MeshSpec,
    devices=None,
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    n_threads: int = 4,
    checkpoint: str | None = None,
    checkpoint_every: int = 64,
    long_reads: bool = False,
    config=None,
) -> RunMetrics:
    """`-m BAM --mesh ...`: count one aligner-ordered BAM through a sharded
    mesh pipeline and write the full output table set (byte-identical to the
    unsharded run_bam; tests/test_engine_mesh.py).

    Checkpointing mirrors run_bam (token-based seek resume, adaptive
    snapshot cadence); a snapshot records the stacked mesh counters, so it
    resumes only under the same --mesh shape."""
    if config is not None:
        cap_frags = config.cap_frags
        use_native = config.use_native
        if config.decoder_threads is not None:
            n_threads = config.decoder_threads
        checkpoint = config.checkpoint
        checkpoint_every = config.checkpoint_every
        long_reads = config.long_reads
    eng = MeshEngine(ref, spec, devices=devices, cap_frags=cap_frags)
    on_batch = None
    if checkpoint:
        from .checkpoint import load_checkpoint, save_checkpoint

        ck = load_checkpoint(checkpoint)
        token = ck[4] if ck is not None else None
        if ck is not None and token is None:
            raise ValueError(
                "mesh runs resume only from token-carrying snapshots "
                "(legacy re-decode skip is an unsharded-engine path)"
            )
        header, batches, stats = open_decoder(
            ref, bam, cap_frags, use_native, n_threads, resume_token=token,
            long_reads=long_reads,
        )
        st = (
            eng.restore_state(ck)
            if ck is not None
            else eng.new_state(n_refids=len(header.ref_names))
        )
        _snap_cost = [0.1]
        last_snap = [time.perf_counter()]

        def on_batch(done: int) -> None:
            if done % checkpoint_every:
                return
            if time.perf_counter() - last_snap[0] < 4.0 * _snap_cost[0]:
                return
            t0s = time.perf_counter()
            save_checkpoint(checkpoint, st)
            dt = time.perf_counter() - t0s
            st.metrics.checkpoint_s += dt
            _snap_cost[0] = max(dt, 0.1)
            last_snap[0] = time.perf_counter()

    else:
        header, batches, stats = open_decoder(
            ref, bam, cap_frags, use_native, n_threads, long_reads=long_reads
        )
        st = eng.new_state(n_refids=len(header.ref_names))
    eng.run_stream(batches, st, on_batch=on_batch)
    # decode_s/route_s/h2d_s were measured directly on the feeder thread
    # dispatch the finalize/stats programs, then write the stats-independent
    # JuncCount table while they run (engine.run_bam does the same)
    finish = eng.results_async(st)
    os.makedirs(out_dir, exist_ok=True)
    from . import format as fmt_mod
    with open(os.path.join(out_dir, "IRFinder-JuncCount.txt"), "w") as fh:
        fmt_mod.write_junc_count(fh, ref.chroms, st.junc_tally)
    res = finish()
    st.metrics.reads_total = stats.reads_total
    st.metrics.reads_admitted = stats.reads_admitted
    st.metrics.fragments = stats.fragments
    write_outputs(out_dir, ref, header, None, res, st=st, skip_junc=True)
    if checkpoint and os.path.exists(checkpoint):
        os.remove(checkpoint)
    return st.metrics
