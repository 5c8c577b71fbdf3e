"""Directory batch processing: the proteome-throughput pipeline.

Pass `engine=BatchedSasaEngine(params, device=...)` to choose the device;
without one `process_directory` builds its engine on `options.device`
("cuda" by default: chunks dealt over every visible card).

Redesign of the reference's batch mode (reference:
src/main.rs:341-480, rayon par_iter over files with inner threads=1):

  host thread pool: parse + atom selection  (all files submitted
      upfront, consumed in completion order, backpressure-bounded)
      -> streaming chunker: dispatches an exactly-full device chunk the
         moment enough atom-slots have parsed (BatchedSasaEngine, one
         chip fed thousands of structures per dispatch; <= 2 chunks in
         flight)
      -> host thread pool: aggregation + serialization + writes

Per-file error isolation is preserved: one bad structure never aborts the
run; errors are collected and reported at the end (reference:
main.rs:360,447-477).
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .api import SASAOptions
from .io.read import read_structure
from .io.serialize import (
    fast_selection_json,
    fast_selection_xml,
    sasa_result_to_bfactors,
    sasa_result_to_json,
    sasa_result_to_xml,
)
from .levels import aggregate
from .native import NativeFallback, NativeSelection, native_process_file, pipe_library
from .ops.engine import BatchedSasaEngine, CountsView, SasaParams
from .utils import stagestats

__all__ = [
    "BatchReport",
    "BatchedSasaEngine",
    "SasaParams",
    "process_directory",
]


@dataclass
class BatchReport:
    n_files: int = 0
    n_ok: int = 0
    errors: list[str] = field(default_factory=list)
    elapsed_s: float = 0.0
    total_area: float = 0.0  # sum of atom SASA over all processed files


class _Progress:
    """Minimal stderr progress line (reference uses indicatif, main.rs:366)."""

    def __init__(self, total: int, enabled: bool):
        self.total = total
        self.done = 0
        self.enabled = enabled and total > 0
        self.start = time.time()

    def tick(self, n: int = 1) -> None:
        if not self.enabled:
            return
        self.done += n
        elapsed = time.time() - self.start
        rate = self.done / elapsed if elapsed > 0 else 0.0
        eta = (self.total - self.done) / rate if rate > 0 else 0.0
        width = 30
        filled = int(width * self.done / self.total)
        bar = "#" * filled + "-" * (width - filled)
        sys.stderr.write(
            f"\r[{elapsed:7.1f}s] [{bar}] {self.done}/{self.total} "
            f"(eta {eta:.0f}s)"
        )
        if self.done >= self.total:
            sys.stderr.write("\n")
        sys.stderr.flush()


def serialize_result(structure, result, fmt: str, selection=None) -> str:
    from .io.cif import write_cif
    from .io.pdb import write_pdb
    from .io.writeback import writeback_cif, writeback_pdb

    if fmt == "json":
        return sasa_result_to_json(result)
    if fmt == "xml":
        return sasa_result_to_xml(result)
    if fmt == "pdb":
        bf = sasa_result_to_bfactors(structure, result, selection)
        # Faithful splice into the source text (differs from the input
        # only in the B-factor column); from-scratch writer as fallback.
        spliced = writeback_pdb(structure, bf)
        return spliced if spliced is not None else write_pdb(structure, bf)
    if fmt == "cif":
        bf = sasa_result_to_bfactors(structure, result, selection)
        spliced = writeback_cif(structure, bf)
        return spliced if spliced is not None else write_cif(structure, bf)
    raise ValueError(f"unknown output format: {fmt}")


STRUCTURE_EXTS = (".pdb", ".ent", ".cif", ".mmcif", ".pdb1")

# Backpressure capacity: max parsed-but-unwritten files in flight.  4096
# files ~= 4-5 device chunks of lookahead at proteome file sizes.  The
# consume loop below detects loads parked on this bound and retires
# dispatched work to free permits, so the bound can never deadlock the
# pipeline (it used to: >4096 small files could hold every permit at
# exactly the dispatch threshold with nothing left to trigger a collect).
_BACKLOG_CAP = 4096

# Poll interval of the consume loop when no load has completed: only paid
# in stall windows (normal runs always have completions pending).
_STALL_POLL_S = 0.2


def _is_structure_file(name: str) -> bool:
    base = name[:-3] if name.endswith(".gz") else name
    return base.lower().endswith(STRUCTURE_EXTS) or "." not in os.path.basename(base)


def process_directory(
    input_dir: str,
    output_dir: str,
    options: SASAOptions,
    output_format: str,
    *,
    workers: int | None = None,
    progress: bool = True,
    engine: BatchedSasaEngine | None = None,
    file_filter: set[str] | None = None,
) -> BatchReport:
    """Process every structure file in input_dir -> output_dir.

    Returns a BatchReport; raises only for setup failures (bad output dir),
    never for individual file failures.
    """
    t0 = time.time()
    report = BatchReport()

    if os.path.exists(output_dir) and not os.path.isdir(output_dir):
        raise NotADirectoryError(
            f"Output path exists but is not a directory: {output_dir}"
        )
    os.makedirs(output_dir, exist_ok=True)

    try:
        entries = sorted(os.listdir(input_dir))
    except OSError as e:
        raise FileNotFoundError(f"Failed to read directory: {e}") from e
    files = [
        os.path.join(input_dir, f)
        for f in entries
        if os.path.isfile(os.path.join(input_dir, f))
        and (file_filter is None or f in file_filter)
    ]
    report.n_files = len(files)
    bar = _Progress(len(files), progress)

    workers = workers or min(32, (os.cpu_count() or 4) * 2)
    engine = engine or BatchedSasaEngine(
        SasaParams(probe_radius=options.probe_radius, n_points=options.n_points),
        device=options.device,
    )

    # The native C++ pipeline (parse + select + aggregate + emit, all
    # GIL-free) handles json/xml outputs with any radii table - custom
    # configs are overlaid onto ProtOr and loaded into the native radius
    # map up front, so a -r run keeps proteome throughput; any file the
    # native path declines routes through the Python pipeline.  Both
    # produce byte-identical outputs (tests/test_native_pipe.py).
    use_native = (
        output_format in ("json", "xml") and pipe_library() is not None
    )
    if use_native:
        from .native import set_pipe_radii

        set_pipe_radii(options.radii_config)
    level_str = options.level.value

    # Backpressure: loads park here until emits release permits, so the
    # parsed-but-unwritten backlog (one SoA selection per file) stays
    # bounded on corpora far larger than RAM would allow.  `stalled`
    # counts loader threads currently parked on the bound - the consume
    # loop uses it to decide when it must retire in-flight work itself.
    import threading

    backlog = threading.BoundedSemaphore(_BACKLOG_CAP)
    stall_lock = threading.Lock()
    stalled = [0]

    def _acquire_permit():
        if backlog.acquire(blocking=False):
            return
        with stall_lock:
            stalled[0] += 1
        try:
            backlog.acquire()
        finally:
            with stall_lock:
                stalled[0] -= 1

    # Parse + select on host worker threads (native parser releases the GIL).
    # Returns (path, handle, err): handle is a NativeSelection or a
    # (structure, selection) pair for the Python route.
    def load(path):
        _acquire_permit()
        if use_native:
            try:
                ns = native_process_file(
                    path,
                    level=level_str,
                    include_hydrogens=options.include_hydrogens,
                    include_hetatms=options.include_hetatms,
                    read_radii_from_occupancy=options.read_radii_from_occupancy,
                    allow_vdw_fallback=options.allow_vdw_fallback,
                )
                return (path, ns, None)
            except NativeFallback:
                pass
            except Exception as e:  # noqa: BLE001 - per-file isolation
                return (path, None, f"Error processing {os.path.basename(path)}: {e}")
        try:
            structure = read_structure(path)
            sel = options.build_selection(structure)
            return (path, (structure, sel), None)
        except Exception as e:  # noqa: BLE001 - per-file isolation
            return (path, None, f"Error processing {os.path.basename(path)}: {e}")

    def triple(handle):
        if isinstance(handle, NativeSelection):
            return (handle.coords, handle.radii, handle.gids)
        return (handle[1].coords, handle[1].radii, handle[1].group_ids)

    # Aggregate + serialize + write on host worker threads.  Returns
    # (error | None, emitted_atom_area): the area of a file counts toward
    # report.total_area only when its output was actually written.
    def emit(args):
        try:
            return _emit(args)
        finally:
            backlog.release()

    def _emit(args):
        (path, handle), atom_sasa = args
        base = os.path.basename(path)
        if base.endswith(".gz"):
            base = base[:-3]
        stem = os.path.splitext(base)[0]
        out_path = os.path.join(output_dir, f"{stem}.{output_format}")
        try:
            if isinstance(handle, NativeSelection) and isinstance(
                atom_sasa, CountsView
            ):
                # Fully-fused native sink: unpack + aggregate + format +
                # write in one C++ pass straight from the device's raw
                # counts readback (bit-identical output bytes).
                try:
                    area = handle.emit_counts(
                        atom_sasa.counts, atom_sasa.inv,
                        float(atom_sasa.area_const), atom_sasa.probe,
                        level_str, output_format, out_path,
                    )
                finally:
                    handle.close()
                return None, area
            if callable(atom_sasa):
                # Deferred unpack (engine.collect_views): slice + inverse
                # permutation + counts->SASA runs HERE on the worker
                # thread, off the pipeline's serial spine.
                atom_sasa = atom_sasa()
            area = float(atom_sasa.sum())
            if isinstance(handle, NativeSelection):
                try:
                    handle.emit(atom_sasa, level_str, output_format, out_path)
                finally:
                    handle.close()
                return None, area
            structure, sel = handle
            if output_format == "json":
                # Vectorized hot path - no per-residue Python objects.
                payload = fast_selection_json(sel, atom_sasa, options.level)
            elif output_format == "xml":
                payload = fast_selection_xml(sel, atom_sasa, options.level)
            else:
                result = aggregate(sel, atom_sasa, options.level)
                payload = serialize_result(
                    structure, result, output_format, selection=sel
                )
            with open(out_path, "w", encoding="utf-8") as f:
                f.write(payload)
            return None, area
        except Exception as e:  # noqa: BLE001 - per-file isolation
            return f"Error processing {os.path.basename(path)}: {e}", 0.0

    emit_futures: list = []

    def drain_emits(only_done: bool) -> None:
        """Fold finished emits into the report (and tick the bar LIVE,
        reference: indicatif progress during the run, main.rs:366-374).
        With only_done=True completed futures are consumed opportunistically
        between waves; the final call waits for the rest."""
        remaining = []
        for f in emit_futures:
            if only_done and not f.done():
                remaining.append(f)
                continue
            err, area = f.result()
            if err is None:
                report.n_ok += 1
                report.total_area += area
            else:
                report.errors.append(err)
            bar.tick()
        emit_futures[:] = remaining

    import queue as _queuemod
    from collections import deque

    from .ops.engine import CHUNK_SLOT_BUDGET

    done_q: _queuemod.Queue = _queuemod.Queue()
    inflight: deque = deque()  # (good_batch, enqueue-future)
    batch_good: list = []
    in_hand: list = [None]  # handle between done_q pop and batch append

    def _close_handle(h) -> None:
        if isinstance(h, NativeSelection):
            try:
                h.close()
            except Exception:  # noqa: BLE001 - abort-path best effort
                pass

    try:
      with ThreadPoolExecutor(max_workers=workers) as pool, \
            ThreadPoolExecutor(max_workers=workers) as load_pool:
        # ALL loads submitted upfront ON THEIR OWN POOL: parsing fills
        # every idle host cycle from t=0 (waves 2+ parse while the device
        # crunches waves 0-1) and never queues ahead of the pack/emit
        # tasks submitted to `pool` below.  Peak memory is one SoA
        # selection per file (~16B/atom), fine at proteome scale.
        load_futures = []
        for p in files:
            fut = load_pool.submit(load, p)
            fut.add_done_callback(done_q.put)
            load_futures.append(fut)

        # Streaming chunker: files are consumed in PARSE-COMPLETION order
        # (no wave barrier waiting on the slowest file) and dispatched the
        # moment a full device chunk's worth of atom-slots has
        # accumulated - every dispatch is an exactly-full chunk except
        # the last.  Pack+dispatch runs on a worker thread (the C++
        # packer releases the GIL); at most two dispatches stay in
        # flight, so the device queue keeps one chunk of lookahead while
        # results stream back.  This is the TPU analog of the reference's
        # rayon-over-files loop (main.rs:375): wall time is
        # max(device, host) rather than their sum.

        batch_slots = 0
        consumed_slots = 0
        received_ok = 0  # loads that produced work (errors consume no slots)
        # Ramped thresholds: the first two dispatches fill the 0.5M- and
        # 1M-slot chunk buckets exactly, so the device starts ~4x sooner
        # than waiting for a full 2M chunk and no padding is wasted.
        ramp = deque([524288, 1048576])
        threshold = min(ramp.popleft(), CHUNK_SLOT_BUDGET)

        def effective_threshold(received: int) -> int:
            # Down-ramp near the end of the corpus: once the estimated
            # remaining work is under ~2.5 full chunks, dispatch at the
            # 1M-slot bucket so the tail's device time overlaps the last
            # parses instead of serializing after them.  The per-file
            # slot average divides by successful loads only — errored
            # files contribute no slots, and counting them would make
            # the estimate undershoot on error-heavy corpora, triggering
            # the down-ramp (smaller, less efficient chunks) early.
            if ramp or received_ok == 0:
                return threshold
            est_rem = (len(files) - received) * (consumed_slots / received_ok)
            if est_rem < 0.8 * CHUNK_SLOT_BUDGET:
                return min(524288, threshold)
            if est_rem < 2.5 * CHUNK_SLOT_BUDGET:
                return min(1048576, threshold)
            return threshold

        def dispatch_batch():
            nonlocal batch_good, batch_slots, threshold
            if not batch_good:
                return
            triples = [triple(h) for (_, h) in batch_good]
            inflight.append(
                (batch_good, pool.submit(engine.enqueue, triples))
            )
            batch_good, batch_slots = [], 0
            threshold = (
                min(ramp.popleft(), CHUNK_SLOT_BUDGET)
                if ramp else CHUNK_SLOT_BUDGET
            )

        def collect_oldest():
            prev_good, fut = inflight.popleft()
            with stagestats.stage("collect"):
                sasas = fut.result().collect_views()
            emit_futures.extend(
                pool.submit(emit, args)
                for args in zip(prev_good, sasas)
            )

        try:
            received = 0
            while received < len(files):
                try:
                    with stagestats.stage("load_wait"):
                        f = done_q.get(timeout=_STALL_POLL_S)
                except _queuemod.Empty:
                    # No load completed: either parses are just slow, or
                    # loaders are parked on the backpressure bound while
                    # every permit is held by work only this loop can
                    # retire (batched/dispatched chunks whose emits would
                    # release permits).  Retire the oldest work so the
                    # pipeline can never wedge against its own bound.
                    with stall_lock:
                        n_stalled = stalled[0]
                    if n_stalled:
                        if inflight:
                            collect_oldest()
                        elif batch_good:
                            dispatch_batch()
                    drain_emits(only_done=True)
                    continue
                received += 1
                path, h, err = f.result()
                in_hand[0] = h  # abort-path cleanup owns it until batched
                if err is not None:
                    backlog.release()  # no emit will run for this file
                    report.errors.append(err)
                    bar.tick()
                    continue
                n = (
                    h.coords.shape[0]
                    if isinstance(h, NativeSelection)
                    else h[1].coords.shape[0]
                )
                slots = max(-(-max(n, 1) // 128) * 128, 128)
                received_ok += 1
                consumed_slots += slots
                if batch_good and batch_slots + slots > (
                    effective_threshold(received)
                ):
                    dispatch_batch()
                    # In-flight dispatch depth: with the round-5 host
                    # speedups the pipeline is DEVICE-bound in degraded
                    # link windows, and a 2-deep queue left the device
                    # idle between a collect and the next chunk's h2d.
                    # Measured same-window A/B (2M-slot chunks, proteome
                    # corpus): cap2 6.0-8.4 s, cap3 5.1-7.5, cap4
                    # 4.9-4.9, cap5 4.5 s.  Memory cost is ~13 MB wire
                    # per in-flight chunk.
                    while len(inflight) > 5:
                        collect_oldest()
                    drain_emits(only_done=True)
                batch_good.append((path, h))
                in_hand[0] = None
                batch_slots += slots
            dispatch_batch()
            while inflight:
                collect_oldest()
                drain_emits(only_done=True)
            with stagestats.stage("emit_wait"):
                drain_emits(only_done=False)
        except BaseException:
            # Unblock any loads parked on backpressure so the pool
            # shutdown can't hang behind this exception.
            for lf in load_futures:
                lf.cancel()
            for _ in range(2 * len(files) + 8):
                try:
                    backlog.release()
                except ValueError:
                    break
            raise
    except BaseException:
        # Reached only on abort, after the pools have shut down (the
        # with-block exited): every load has finished or been cancelled
        # and all queued emits ran.  Close native handles stranded in
        # the pipeline stages (parsed loads never consumed, batched but
        # undispatched files, dispatched chunks never collected) so an
        # aborted run inside a long-lived embedding process doesn't leak
        # their native allocations.
        while True:
            try:
                f = done_q.get_nowait()
            except _queuemod.Empty:
                break
            try:
                _, h, _ = f.result()
            except BaseException:  # noqa: BLE001 - cancelled/failed load
                continue
            _close_handle(h)
        _close_handle(in_hand[0])
        for _, h in batch_good:
            _close_handle(h)
        for prev_good, _ in inflight:
            for _, h in prev_good:
                _close_handle(h)
        raise

    report.elapsed_s = time.time() - t0
    return report
