"""Run orchestration of the square in-core sweep on one torch device.

The port of ``distance_tpu/engine.py``'s main path: one alignment,
square, in-core.  Its steps:

* parse and encode on the host (``fastaio``);
* drop invariant columns (``emit._prune_invariant_columns``);
* upload the padded codes once to the run's device;
* per strip of ``ti`` rows, one counter kernel launch per ``tj``-column
  block (``ops/counters.py``), concatenated on the device;
* copy each strip into pinned host memory, asynchronously, with at most
  ``STRIP_LOOKAHEAD`` strips in flight;
* finalize and emit the upper triangle in canonical order on the host.

The counters travel unpacked as int32.  Rectangle, stream, out-of-core,
multi-device and multi-host runs are not ported yet: a run that needs one
raises ``DistanceError`` naming it.  Output bytes are identical to the
JAX engine's for every tile size.
"""

from __future__ import annotations

import os as _os
import sys
from dataclasses import dataclass
from typing import BinaryIO, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distance_tpu_torch.emit import (
    _emit_pairs,
    _gather_emit,
    _prune_invariant_columns,
    _ScratchPool,
)
from distance_tpu_torch.fastaio import (
    Alignment,
    DistanceError,
    consensus as consensus_fn,
    load_fastas,
)
from distance_tpu_torch.ops import counters as kernels
from distance_tpu_torch.ops.features import get_plan
from distance_tpu_torch.ops.plan import plan_to_torch
from distance_tpu_torch.utils.timing import phase_timer
from distance_tpu_torch.writer import TsvWriter

# Pair-tile sizes: strips of TILE_I rows against blocks of TILE_J
# columns.  0 = auto (see _auto_tile).
TILE_I = 0
TILE_J = 0
# Strips dispatched ahead of the one currently being fetched/emitted.
STRIP_LOOKAHEAD = 6

BACKENDS = ("cuda", "torch")


def not_ported(what: str) -> DistanceError:
    return DistanceError(f"{what} is not yet ported to distance_tpu_torch")


@dataclass
class Setup:
    """Resolved run configuration (analog of lib.rs:133-160)."""

    loaded: List[Alignment]
    streamed: Optional[BinaryIO]
    writer: TsvWriter
    measure: str
    n_threads: int
    batchsize: int
    backend: str = "cuda"  # cuda | torch
    consensus: Optional[np.ndarray] = None
    tile_i: int = TILE_I
    tile_j: int = TILE_J
    # Sharding: (k, N) — this process handles the k-th of N balanced
    # contiguous row-strip ranges; concatenating the N outputs in k order
    # reproduces the unsharded file byte-for-byte.
    shard: Optional[Tuple[int, int]] = None
    # Checkpoint/resume sidecar (see progress.py); None disables.
    progress: Optional[object] = None
    # Input-file fingerprints recorded in the progress sidecar so --resume
    # refuses to continue against changed inputs.
    input_fp: Optional[List[dict]] = None
    # Output path (None for stdout).
    out_path: Optional[str] = None


def set_up(args) -> Setup:
    """Build a Setup from parsed CLI arguments (argparse namespace).

    Mirrors reference/src/lib.rs:162-267: input resolution
    (positional xor -i, stdin default), stream handling, measure
    precompute (consensus for ``n``, base counts for ``tn93``), writer and
    thread/batch settings.
    """
    pos_inputs = [p for p in (args.input_pos_1, args.input_pos_2) if p]
    flag_inputs = list(args.input or [])
    if pos_inputs and flag_inputs:
        raise DistanceError(
            "For loading input files, don't use both positional arguments"
            " and the -i/--input flag"
        )
    consolidated = flag_inputs + pos_inputs

    handles: List[BinaryIO] = []
    if not consolidated:
        handles.append(sys.stdin.buffer)
    for path in consolidated:
        handles.append(open(path, "rb"))

    streamed: Optional[BinaryIO] = None
    if args.stream is not None:
        if len(consolidated) != 1:
            raise DistanceError(
                "If you stream one file, you must also provide exactly one"
                " other file to be loaded"
            )
        streamed = sys.stdin.buffer if args.stream == "-" else open(args.stream, "rb")

    with phase_timer("load+encode"):
        loaded = load_fastas(handles)

    cons = None
    if args.measure == "n":
        # One-time host reduction (lib.rs:223-231), kept for the
        # streamed-mode contract and the sparse host path.
        with phase_timer("consensus"):
            cons = consensus_fn(loaded)
    elif args.measure == "tn93":
        with phase_timer("count_bases"):
            for aln in loaded:
                aln.count_bases()

    tracker = None
    input_fp = None
    resume = bool(getattr(args, "resume", False))
    if resume:
        if args.output is None:
            raise DistanceError("--resume requires -o/--output")
        from distance_tpu_torch.progress import ProgressTracker

        # Fingerprint the inputs so a resume against swapped/edited files
        # is refused instead of silently appending mismatched rows.
        fp_paths = list(consolidated)
        if args.stream not in (None, "-"):
            fp_paths.append(args.stream)
        input_fp = _input_fingerprint(fp_paths)
        tracker = ProgressTracker(args.output)
        if tracker.load() and _os.path.exists(args.output):
            out = open(args.output, "r+b")
            out.truncate(tracker.byte_offset)
            out.seek(tracker.byte_offset)
        else:
            tracker.units_done = 0
            tracker.byte_offset = 0
            out = open(args.output, "wb")
    else:
        out = (
            sys.stdout.buffer if args.output is None
            else open(args.output, "wb")
        )

    if args.threads is None:
        # omitting -t "spins up the number of available CPUs"
        # (reference/src/lib.rs:262)
        n_threads = _os.cpu_count() or 1
    else:
        n_threads = max(1, args.threads)

    shard = None
    shard_arg = getattr(args, "shard", None)
    if shard_arg:
        try:
            k_s, n_s = shard_arg.split("/")
            shard = (int(k_s), int(n_s))
        except ValueError:
            raise DistanceError(
                f"Invalid --shard '{shard_arg}': expected K/N"
            ) from None
        if shard[1] < 1 or not (0 <= shard[0] < shard[1]):
            raise DistanceError(
                f"Invalid --shard '{shard_arg}': need 0 <= K < N"
            )

    return Setup(
        loaded=loaded,
        streamed=streamed,
        writer=TsvWriter(
            out, on_broken_pipe=tracker.clear if tracker else None
        ),
        measure=args.measure,
        n_threads=n_threads,
        batchsize=max(1, args.batchsize),
        backend=getattr(args, "backend", "cuda") or "cuda",
        consensus=cons,
        shard=shard,
        progress=tracker,
        input_fp=input_fp,
        out_path=args.output,
    )


def _input_fingerprint(paths: Sequence[str]) -> List[dict]:
    """Cheap input identity for resume safety: per-file size plus a hash
    of the first and last 64 KiB (content-based; mtime alone is too
    brittle across copies)."""
    import hashlib

    fps: List[dict] = []
    for p in paths:
        st = _os.stat(p)
        h = hashlib.blake2b(digest_size=16)
        with open(p, "rb") as f:
            h.update(f.read(1 << 16))
            if st.st_size > (1 << 16):
                f.seek(max(1 << 16, st.st_size - (1 << 16)))
                h.update(f.read(1 << 16))
        fps.append(
            {
                "path": _os.path.abspath(p),
                "size": st.st_size,
                "hash": h.hexdigest(),
            }
        )
    return fps


def run(setup: Setup) -> None:
    """Run the square sweep of one loaded alignment (lib.rs:490-498)."""
    if setup.streamed is not None:
        raise not_ported("stream mode (-s/--stream)")
    if len(setup.loaded) != 1:
        raise not_ported("rectangle mode (two input files)")
    if setup.shard is not None and setup.shard[0] != 0:
        setup.writer.suppress_header()
    _resolve_auto_tiles(setup)
    if setup.progress is not None:
        cfg = {
            "measure": setup.measure,
            "tile_i": setup.tile_i,
            "tile_j": setup.tile_j,
            "shard": list(setup.shard) if setup.shard else None,
            "mode": "load",
            "batchsize": setup.batchsize,
            "inputs": setup.input_fp,
        }
        mismatch = setup.progress.check_config(cfg)
        if mismatch:
            raise DistanceError(f"Cannot resume: {mismatch}")
        if setup.progress.byte_offset > 0:
            setup.writer.suppress_header()
    try:
        with phase_timer("load-sweep"):
            _sweep_square(setup, setup.loaded[0])
        setup.writer.flush()
        if setup.progress is not None:
            setup.progress.clear()
    finally:
        try:
            setup.writer.flush()
        except Exception:
            pass
        from distance_tpu_torch.utils import timing

        if timing.enabled():
            for name, secs in sorted(timing.totals().items()):
                print(f"[distance-tpu] total {name}: {secs:.3f} s",
                      file=sys.stderr)


def _resume_skip(setup: Setup) -> int:
    """Number of already-completed emission units to skip."""
    if setup.progress is None:
        return 0
    return setup.progress.units_done


def _progress_mark(setup: Setup, units_done: int) -> None:
    """Checkpoint after one emission unit: flush, record byte offset."""
    if setup.progress is None:
        return
    setup.writer.flush()
    try:
        offset = setup.writer.tell()
    except (OSError, AttributeError):
        return
    setup.progress.record(units_done, offset)


def device_of(backend: str) -> torch.device:
    """The device a backend runs on: ``cuda`` the card (cuda:0), ``torch``
    the CPU.  ``cuda`` without a CUDA device is an error, not a CPU run."""
    if backend == "torch":
        return torch.device("cpu")
    if backend != "cuda":
        raise DistanceError(
            f"unknown backend {backend!r}: expected one of {BACKENDS}"
        )
    if not torch.cuda.is_available():
        raise DistanceError(
            "--backend cuda needs a CUDA device and none is available"
            " (--backend torch runs the plain version on the CPU)"
        )
    return torch.device("cuda", 0)


class _BlockEngine:
    """Counter blocks for (strip, block) tile pairs on one torch device."""

    def __init__(self, measure: str, device: torch.device, ti: int) -> None:
        self.plan = get_plan(measure)
        self.kplan = plan_to_torch(self.plan, device)
        self.device = device
        self.ti = ti

    def prepare(self, matrix: np.ndarray, max_block: int) -> torch.Tensor:
        """Pad and upload a sequence matrix once.

        Rows are padded so that every strip and block slice of up to
        ``max_block`` rows stays in bounds (torch slicing past the end
        returns a shorter tensor where the JAX engine's dynamic_slice
        clamps); padding rows and sites hold code 0, which adds nothing
        to any counter."""
        n, width = matrix.shape
        padded = np.zeros(
            _padded_shape(n, width, self.ti, max_block), dtype=np.uint8
        )
        padded[:n, :width] = matrix
        return torch.from_numpy(padded).to(self.device, copy=True)

    def block(self, m1: torch.Tensor, m2: torch.Tensor, i0: int, j0: int,
              ti: int, tj: int) -> torch.Tensor:
        """One (G, ti, tj) counter block on the device."""
        if i0 + ti > m1.shape[0] or j0 + tj > m2.shape[0]:
            raise ValueError(
                f"block ({i0}+{ti}, {j0}+{tj}) outside the prepared rows"
                f" ({m1.shape[0]}, {m2.shape[0]})"
            )
        return kernels.counters(
            m1[i0 : i0 + ti], m2[j0 : j0 + tj], self.kplan
        )

    def release(self, handle: torch.Tensor) -> None:
        """Free a prepared matrix's memory now rather than when its last
        reference goes; the handle is empty afterwards."""
        handle.untyped_storage().resize_(0)


def _dispatch_strip(eng: _BlockEngine, m1, m2, i0: int, col_starts, ti,
                    tj) -> torch.Tensor:
    """Launch every column block of one strip; concatenate them on the
    device into one (G, ti, span) strip."""
    handles = [eng.block(m1, m2, i0, j0, ti, tj) for j0 in col_starts]
    return torch.cat(handles, dim=-1) if len(handles) > 1 else handles[0]


class _AsyncFetch:
    """Device->host copy of one strip into pinned memory, started at
    construction; ``result()`` waits for it and returns a numpy view."""

    def __init__(self, handle: torch.Tensor) -> None:
        self._event = None
        if handle.device.type == "cpu":
            self._host = handle
            return
        self._host = torch.empty(
            handle.shape, dtype=handle.dtype, pin_memory=True
        )
        self._host.copy_(handle, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _fetch_strip(handle: _AsyncFetch, valid_rows: int,
                 valid_cols: int) -> np.ndarray:
    """Wait for a strip and crop it to the region that is emitted ->
    (G, rows, cols) int32 counters."""
    return handle.result()[:, :valid_rows, :valid_cols]


def _pipeline_strips(strip_iter, emit_fn):
    """Run dispatch ahead of fetch+emit (the bounded-channel analog)."""
    pending: List[tuple] = []
    for item in strip_iter:
        pending.append(item)
        while len(pending) > STRIP_LOOKAHEAD:
            emit_fn(pending.pop(0))
    while pending:
        emit_fn(pending.pop(0))


class _AsyncEmitter:
    """Ordered single-thread executor for the format+write tail.

    The reference dedicates a thread to its ordered writer
    (lib.rs:377-385); here the expensive emission tail (row formatting,
    file write, progress checkpoint) runs on one background thread in
    submission order, overlapping the next strip's fetch/unpack/finalize
    on the main thread.  Exceptions re-raise on the submitting side.
    """

    def __init__(self, depth: int = 2):
        import queue as _queue
        import threading

        self._q: "_queue.Queue" = _queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                self._done.set()
                return
            if self._err is None:
                try:
                    fn()
                except BaseException as e:
                    self._err = e

    def submit(self, fn) -> None:
        # A failed tail poisons the emitter permanently: every later
        # submit and finish() re-raise, and the worker runs nothing
        # more — work submitted after the first raise must not silently
        # execute (round-2 review finding).
        if self._err is not None:
            raise self._err
        self._q.put(fn)

    def finish(self) -> None:
        self._q.put(None)
        self._done.wait()
        self._thread.join()
        if self._err is not None:
            raise self._err


def _split_strips(weights: List[int], shard: Optional[Tuple[int, int]]):
    """Balanced contiguous split of strips by pair-count weight.

    Returns the [a, b) strip-index range for this shard (the whole range
    when unsharded).  Boundaries are where the cumulative weight crosses
    total*j/N, so every shard gets ~equal pairs even though square-mode
    strips shrink toward the bottom of the triangle.
    """
    if shard is None:
        return 0, len(weights)
    k, nshards = shard
    total = sum(weights) or 1
    cum = 0
    bounds = [0]
    target_idx = 1
    for idx, w in enumerate(weights):
        cum += w
        while target_idx < nshards and cum >= total * target_idx / nshards:
            bounds.append(idx + 1)
            target_idx += 1
    while len(bounds) < nshards:
        bounds.append(len(weights))
    bounds.append(len(weights))
    return bounds[k], bounds[k + 1]


def _auto_tile(n: int, device: torch.device) -> int:
    """Default square pair-tile edge for a sweep over ``n`` target rows:
    the largest power of two <= n/4 (the diagonal blocks' lower-triangle
    waste costs ~tile/n of the sweep), floored at 2048 and capped at
    8192.  CPU runs keep tiles of at most 512 so tests stay fast."""
    cap = 512 if device.type == "cpu" else 8192
    t = 2048 if cap >= 2048 else cap
    while t * 2 <= max(1, n // 4) and t < cap:
        t *= 2
    return min(t, cap)


def _strip_ram_budget(deterministic: bool = False) -> int:
    """Host-RAM allowance for one strip's emission lease (~3 in flight).

    The gather/key/index buffers for a strip cost ~(G+2) x ti x n
    int32s; unbounded ti at very large n would lease tens of GB.  Cap at
    a third of physical RAM (or 48 GB), DISTANCE_TPU_STRIP_RAM overrides.
    ``deterministic`` (sharded / multi-host runs) ignores local RAM —
    every shard host must resolve the SAME strip grid or the merged
    output would interleave wrongly.
    """
    env = int(_os.environ.get("DISTANCE_TPU_STRIP_RAM", 0))
    if env:
        return env
    if deterministic:
        return 48 << 30
    try:
        phys = _os.sysconf("SC_PHYS_PAGES") * _os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        phys = 16 << 30
    return min(48 << 30, phys // 3)


def _cap_tile_ram(ti: int, n2: int, measure: str, deterministic: bool) -> int:
    """Bound the emission lease: ~3 strips of (G+2) int32 buffers."""
    g = len(get_plan(measure).counters)
    budget = _strip_ram_budget(deterministic)
    while ti > 1024 and 3 * (g + 2) * ti * n2 * 4 > budget:
        ti //= 2
    return ti


def _resolve_auto_tiles(setup: Setup) -> None:
    """Pin auto (0) tiles to concrete values BEFORE the resume config is
    recorded: the strip grid defines resume units and shard boundaries,
    so the resolved numbers — not the auto marker — go into the sidecar.
    The sweep's own resolution then sees nonzero values and is a no-op.
    """
    if not setup.loaded:
        return
    n = setup.loaded[0].n
    device = device_of(setup.backend)
    deterministic = setup.shard is not None
    if setup.tile_i == 0:
        setup.tile_i = _cap_tile_ram(
            _auto_tile(n, device), n, setup.measure, deterministic
        )
    if setup.tile_j == 0:
        setup.tile_j = _auto_tile(n, device)


def _choose_tiles(n1: int, n2: int, setup: Setup,
                  device: torch.device) -> Tuple[int, int]:
    if setup.tile_i == 0:
        setup.tile_i = _cap_tile_ram(
            _auto_tile(n1, device), n2, setup.measure,
            setup.shard is not None,
        )
    if setup.tile_j == 0:
        setup.tile_j = _auto_tile(n2, device)
    ti = min(setup.tile_i, _pow2_at_least(n1))
    # _tri_indices builds int32 position arithmetic over one strip's
    # pairs; cap ti so ti * n2 stays below 2^31 (a wrap would corrupt
    # emission indices silently).  Power-of-two steps keep the tile
    # grid aligned.
    while ti > 8 and ti * max(n2, 1) >= (1 << 31):
        ti //= 2
    tj = min(setup.tile_j, _pow2_at_least(n2))
    return ti, tj


def _pow2_at_least(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


def _padded_shape(n: int, width: int, ti: int,
                  max_block: int) -> Tuple[int, int]:
    """(rows, sites) of a prepared matrix: strips of ``ti`` rows, the last
    padded to ``max_block`` (the JAX engine's n_pad formula), and sites
    padded to a multiple of 128."""
    n_strips = max(1, -(-n // ti))
    n_pad = max((n_strips - 1) * ti + max(max_block, ti), max_block)
    return n_pad, -(-max(width, 1) // 128) * 128


def _device_footprint(n: int, width: int, ti: int, max_block: int,
                      counters_per_pair: int) -> int:
    """Device bytes of the square sweep: the padded codes plus the int32
    strips that can be in flight."""
    n_pad, l_pad = _padded_shape(n, width, ti, max_block)
    strip = counters_per_pair * ti * n_pad * 4
    return n_pad * l_pad + (STRIP_LOOKAHEAD + 1) * strip


def _sweep_square(setup: Setup, aln: Alignment) -> None:
    n, width = aln.n, aln.width
    if setup.shard is None or setup.shard[0] == 0:
        setup.writer.header()
    if n < 2:
        return
    source = aln.matrix
    same_offset = 0
    pruned = _prune_invariant_columns([aln.matrix])
    if pruned is not None:
        (source,), same_offset, width = pruned
    device = device_of(setup.backend)
    ti, tj = _choose_tiles(n, n, setup, device)
    if device.type == "cuda":
        footprint = _device_footprint(
            n, width, ti, max(ti, tj), len(get_plan(setup.measure).counters)
        )
        budget = torch.cuda.get_device_properties(device).total_memory // 2
        if footprint > budget:
            raise not_ported(
                f"the out-of-core sweep (needs {footprint / 1e9:.2f} GB of"
                f" device memory, budget {budget / 1e9:.2f} GB)"
            )
    eng = _BlockEngine(setup.measure, device, ti)
    with phase_timer("prepare-upload"):
        mat = eng.prepare(source, max(ti, tj))
    plan = eng.plan

    strip_starts = list(range(0, n - 1, ti))
    weights = [
        sum(n - 1 - i for i in range(i0, min(i0 + ti, n)))
        for i0 in strip_starts
    ]
    a, b = _split_strips(weights, setup.shard)
    done = _resume_skip(setup)
    from distance_tpu_torch.utils.timing import ProgressMeter

    meter = ProgressMeter("sweep", weights[a + done : b])
    emitter = _AsyncEmitter()
    pool = _ScratchPool()

    def strips():
        for ordinal, i0 in enumerate(strip_starts[a:b]):
            if ordinal < done:
                continue
            col_starts = list(range(i0, n, tj))
            yield ordinal, i0, _AsyncFetch(
                _dispatch_strip(eng, mat, mat, i0, col_starts, ti, tj)
            )

    def emit(item):
        ordinal, i0, handle = item
        si = min(ti, n - i0)
        strip = _fetch_strip(handle, si, n - i0)
        # Rows i0..i0+si-1 in order: (i, j) for j in i+1..n.
        lease: List[np.ndarray] = []
        with phase_timer("gather"):
            gathered = _gather_emit(strip, si, i0, n, i0, pool, lease)
        if gathered is None:
            return
        rows_c, pair_i, col_idx = gathered
        counters = {
            name: rows_c[k] for k, name in enumerate(plan.counters)
        }
        _emit_pairs(
            setup, aln, aln, pair_i, col_idx, counters, same_offset,
            emitter=emitter,
            after=lambda ordinal=ordinal: (
                _progress_mark(setup, ordinal + 1), meter.tick()
            ),
            pool=pool, lease=lease,
        )

    try:
        _pipeline_strips(strips(), emit)
        emitter.finish()
    finally:
        eng.release(mat)
