"""Run orchestration of the sweeps on one torch device.

The port of ``distance_tpu/engine.py``'s single-device paths: the square
sweep of one alignment, the rectangle of two, and the stream of records
against one loaded alignment.  The loaded sweeps in core:

* parse and encode on the host (``fastaio``);
* drop invariant columns (``emit._prune_invariant_columns``);
* upload the padded codes once to the run's device: as (index, code)
  diffs against a reference row that the diff rebuild kernel
  (``ops/diffup.py``) expands there, or dense through pinned memory when
  the diffs do not win;
* per strip of ``ti`` rows, one counter kernel launch per ``tj``-column
  block (``ops/counters.py``), or for a measure of CACHED_MEASURES whose
  feature cache fits, the JAX engine's cached-feature path
  (``ops/cached.py``): the column side's g features built once, each
  strip's f features once, and each block one contraction of them; each
  block packed by the pack kernel
  (``ops/packing.py``): against K1 baselines of the reference row (rel4
  nibbles with an exception sidecar, or int8 rel), or below 2^16 sites
  into saturating 8-bit lanes (narrow) or 16-bit fields (wide), and
  concatenated on the device with one sidecar bundle per strip;
* copy each strip into pinned host memory, asynchronously, with at most
  ``STRIP_LOOKAHEAD`` strips in flight, and finish the counters on the
  host; a saturated strip is packed again at the next rung of the pack
  ladder (the JAX engine's: rel4 -> rel -> narrow/wide below 2^16 sites,
  rel4 -> rel -> int32 above) from the int32 counters it keeps on the
  device until it is finished (``_Strip``), with no second K1 launch;
* finalize and emit the upper triangle (square) or the full file1 x file2
  block in row-major order (rectangle) on the host.

The stream (``_run_stream``) keeps the loaded side's variant columns on
the device and sends the records in groups (diff-encoded, with the
reference retargeted when a group's lineage differs), one counter block
and one pack per group: on the cached-feature path (the JAX engine's
``counters_xla`` in ``_jit_stream_fn``) the loaded rows' f features built
once and each group's g features once, then one contraction; else one K1
launch (see there).  A run whose device footprint passes
the device budget (``_device_budget``) goes out of core: the loaded
sweeps stage row groups and super-rows through the device
(``_sweep_blocked``), and the stream sweeps a host-resident loaded side
in super-rows per group (the staged stream), diff-encoded (each
super-row encoded once a run) and packed as in core.  A sharded stream (``-s``
with ``--shard K/N``) runs every N-th group and indexes its units in a
``.units`` sidecar, which ``parallel/multihost.merge_parts`` interleaves
into the unsharded file.  The knobs of KNOB_ENV follow the JAX CLI's
environment variables.

On more than one device (``devices_of``: every card of the host for a
lone process) an engine splits the columns of every block, and the rows
of every stream group, over them, as the JAX engine's GSPMD mesh does:
each device holds the codes and the f features whole and its part of the
g cache, runs the kernels on its columns, and packs them; the row
baselines and the self-counter are made once, on the first device, the
parts' rel4 sidecars merge into the whole block's, and the strip reaches
the host from the first device in the one-device layout (``_BlockEngine``
``parts``).  Output bytes are identical to the JAX engine's for every
tile, group, budget, shard, pack rung and device count.
"""

from __future__ import annotations

import contextlib
import math
import os as _os
import sys
from dataclasses import dataclass
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distance_tpu_torch.emit import (
    PRUNE_MIN_FRACTION,
    _emit_pairs,
    _gather_emit,
    _prune_invariant_columns,
    _ScratchPool,
    _tn93_value_keys,
    _value_keys,
)
from distance_tpu_torch.fastaio import (
    Alignment,
    DistanceError,
    consensus as consensus_fn,
    load_fastas,
    stream_fasta,
)
from distance_tpu_torch.finalize import finalize_block
from distance_tpu_torch.ops import basecount
from distance_tpu_torch.ops import cached as cached_ops
from distance_tpu_torch.ops import counters as kernels
from distance_tpu_torch.ops import packing
from distance_tpu_torch.ops.diffup import (
    DiffUploader,
    mode_row,
    sampled_mode_row,
    to_device,
)
from distance_tpu_torch.ops.features import CounterPlan, get_plan
from distance_tpu_torch.ops.plan import cached_plan_to_torch, plan_to_torch
from distance_tpu_torch.parallel.multihost import CARD_SHARE_ENV, UnitIndex
from distance_tpu_torch.utils.timing import phase_timer
from distance_tpu_torch.writer import TsvWriter

# Pair-tile sizes: strips of TILE_I rows against blocks of TILE_J
# columns.  0 = auto (see _auto_tile).
TILE_I = 0
TILE_J = 0
# Strips dispatched ahead of the one currently being fetched/emitted.
STRIP_LOOKAHEAD = 6
# Streamed records per device group.  0 = auto (see _stream_group_size);
# a group never holds more than STREAM_GROUP_CAP records.
STREAM_GROUP = 0
STREAM_GROUP_CAP = 8192
# Stream groups computed ahead of the one being fetched/emitted.
STREAM_PENDING = 3
# Device bytes a sweep may hold.  0 = auto: half the memory the card can
# hand out when the sweep starts (half its total where a size must not
# change between runs), divided among the workers of a --launch, and no
# budget on the CPU.  A nonzero value applies on every device, the CPU
# included.
DEVICE_BUDGET = 0
# Host bytes for the counter buffers of out-of-core groups (the JAX
# package's default): an X group's buffer, or the staged stream's groups
# in flight, take at most half of it.
HOST_BUF_BUDGET = 4 << 30
# Fewest streamed records in a staged group: below this the loaded side's
# re-staging per group dominates.
STAGED_ROWS_FLOOR = 256
# After this many consecutive saturated fetches at a rung of the pack
# ladder (rel4, then rel), dispatch at the next rung.
NARROW_STICKY_LIMIT = 2
# Consecutive failed stream-reference retargets before the engine stops
# probing new references (see _BlockEngine.dispatch_stream).
RETARGET_FAIL_LIMIT = 3
# Device bytes the feature cache of one prepared matrix may take (R x
# rows x padded sites int8; an X group's f cache half of it), the JAX
# CLI's.  0 turns the cached-feature path off.
FEATCACHE_BUDGET = 8 << 30
# The measures whose square and rectangle blocks take the cached-feature
# path (K5 features once per matrix or strip, K6 a block) when their cache
# is engaged; the others, and any matrix whose cache does not fit, take K1.
# The JAX engine sends every device run through its cached path
# (_resolve_backend); on the card a measure is here where phase 5 of
# chip_smoke.py measured K6's block plus its share of K5 faster than K1's
# block at 2048 x 2048 x 29952.
CACHED_MEASURES = frozenset({"n", "n_high", "raw", "jc69", "k80", "tn93"})
# Count a tn93 run's base tallies on the device (K7, ``ops/basecount.py``)
# for loaded matrices of at least this many bytes; the JAX CLI's default,
# off: the host count is one native pass over the matrix, and the
# device's needs a dense upload of its own beside the sweep's.
BASE_COUNT_DEVICE_MIN_BYTES = 1 << 62
# Bytes of codes a device base count uploads at once (the JAX engine's
# H2D_CHUNK_BYTES), so that its device memory stays bounded.
H2D_CHUNK_BYTES = 32 << 20

# The JAX CLI's environment variables of the knobs above.  Each is read
# when a run starts (``_env_knobs``), so that the workers of a --launch or
# --num-hosts run inherit it; unset, the module constant stands.
KNOB_ENV = {
    "DEVICE_BUDGET": "DISTANCE_TPU_HBM_BUDGET",
    "HOST_BUF_BUDGET": "DISTANCE_TPU_HOST_BUF_BUDGET",
    "STREAM_GROUP": "DISTANCE_TPU_STREAM_GROUP",
    "STRIP_LOOKAHEAD": "DISTANCE_TPU_LOOKAHEAD",
    "STREAM_PENDING": "DISTANCE_TPU_STREAM_PENDING",
    "NARROW_STICKY_LIMIT": "DISTANCE_TPU_NARROW_STICKY",
    "RETARGET_FAIL_LIMIT": "DISTANCE_TPU_RETARGET_LIMIT",
    "FEATCACHE_BUDGET": "DISTANCE_TPU_FEATCACHE_BUDGET",
    "BASE_COUNT_DEVICE_MIN_BYTES": "DISTANCE_TPU_BASECOUNT_DEVICE_MIN",
}

BACKENDS = ("cuda", "torch")


@contextlib.contextmanager
def _env_knobs():
    """The knobs of KNOB_ENV set from the environment for one run, and
    restored after it."""
    saved = {name: globals()[name] for name in KNOB_ENV}
    try:
        for name, var in KNOB_ENV.items():
            value = _os.environ.get(var)
            if value:
                try:
                    globals()[name] = int(value)
                except ValueError:
                    raise DistanceError(
                        f"{var}={value!r}: expected an integer") from None
        yield
    finally:
        globals().update(saved)


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
        backend = getattr(args, "backend", "cuda") or "cuda"
        with phase_timer("count_bases"), _env_knobs():
            for aln in loaded:
                _count_bases_maybe_device(aln, backend)

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
        tile_i=TILE_I,
        tile_j=TILE_J,
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


def _count_bases_maybe_device(aln: Alignment, backend: str) -> None:
    """The alignment's tn93 base tallies: on the backend's device (K7 on a
    card, the plain version on the CPU) for a matrix of at least
    BASE_COUNT_DEVICE_MIN_BYTES, else by the host's native pass."""
    if aln.matrix.nbytes >= BASE_COUNT_DEVICE_MIN_BYTES:
        aln.base_counts = _count_bases_device(aln.matrix, device_of(backend))
        return
    aln.count_bases()


def _count_bases_device(matrix: np.ndarray,
                        device: torch.device) -> np.ndarray:
    """(n, 4) int32 tallies of A, T, G and C of each row of ``matrix``,
    counted on ``device`` in uploads of H2D_CHUNK_BYTES rows."""
    rows_per = max(1, H2D_CHUNK_BYTES // max(1, matrix.shape[1]))
    outs = [np.zeros((0, 4), np.int32)]
    for r0 in range(0, matrix.shape[0], rows_per):
        dev = to_device(np.ascontiguousarray(matrix[r0 : r0 + rows_per]),
                        device)
        outs.append(basecount.base_counts(dev).cpu().numpy())
    return np.concatenate(outs)


def run(setup: Setup) -> None:
    """Dispatch to the loaded or streamed sweep (lib.rs:490-498), with the
    knobs the environment sets and the run's card as the current one."""
    device = device_of(setup.backend)
    with _env_knobs(), (torch.cuda.device(device) if device.type == "cuda"
                        else contextlib.nullcontext()):
        _run(setup)


def _run(setup: Setup) -> None:
    if setup.shard is not None and setup.shard[0] != 0:
        setup.writer.suppress_header()
    _resolve_auto_tiles(setup)
    split = layout = None
    if setup.streamed is not None:
        aln = setup.loaded[0]
        if not _os.environ.get("DISTANCE_TPU_NO_STREAM_SPLIT"):
            split = _StreamSplit(aln.matrix, get_plan(setup.measure))
            if split.frac < PRUNE_MIN_FRACTION:
                split = None
        layout = _stream_layout(
            aln.n, int(split.keep.sum()) if split is not None else aln.width,
            setup.measure, device_of(setup.backend),
            min(setup.tile_i, _pow2_at_least(aln.n)),
            sharded=setup.shard is not None,
        )
    if setup.progress is not None:
        cfg = {
            "measure": setup.measure,
            "tile_i": setup.tile_i,
            "tile_j": setup.tile_j,
            "shard": list(setup.shard) if setup.shard else None,
            "mode": "stream" if setup.streamed is not None else "load",
            # stream groups are the resume units, and their bounds follow
            # the batch size and the group size
            "batchsize": setup.batchsize,
            "stream_group": layout.group if layout is not None else None,
            "inputs": setup.input_fp,
        }
        mismatch = setup.progress.check_config(cfg)
        if mismatch:
            raise DistanceError(f"Cannot resume: {mismatch}")
        if setup.progress.byte_offset > 0:
            setup.writer.suppress_header()
    try:
        if setup.streamed is not None:
            with phase_timer("stream-sweep"):
                _run_stream(setup, split, layout)
        else:
            with phase_timer("load-sweep"):
                _sweep_load(setup)
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


def devices_of(backend: str) -> List[torch.device]:
    """The devices a backend runs on: ``torch`` the CPU; ``cuda`` every
    card of the host for a lone process (the JAX engine's
    ``jax.devices()``), one card for a rank that torchrun started
    (cuda:(LOCAL_RANK mod the card count)) or for worker k of a ``--launch
    N`` (cuda:(k mod the card count)).  An engine splits its blocks over
    them (``_BlockEngine``).  ``cuda`` without a CUDA device is an error,
    not a CPU run."""
    if backend == "torch":
        return [torch.device("cpu")]
    if backend != "cuda":
        raise DistanceError(
            f"unknown backend {backend!r}: expected one of {BACKENDS}"
        )
    if not torch.cuda.is_available():
        raise DistanceError(
            "--backend cuda needs a CUDA device and none is available"
            " (--backend torch runs the plain version on the CPU)"
        )
    cards = torch.cuda.device_count()
    if _os.environ.get("LOCAL_RANK") is not None:
        return [torch.device("cuda", _local_rank() % cards)]
    worker = _launch_worker()
    if worker is not None:
        return [torch.device("cuda", worker[0] % cards)]
    return [torch.device("cuda", k) for k in range(cards)]


def device_of(backend: str) -> torch.device:
    """The first of ``devices_of(backend)``: the device whose memory sizes
    a run, and where its baselines are made and its strips leave for the
    host."""
    return devices_of(backend)[0]


def _local_rank() -> int:
    """This process's rank among torchrun's ranks on its host (0 when
    torchrun did not start it)."""
    return int(_os.environ.get("LOCAL_RANK") or 0)


def _launch_worker() -> Optional[Tuple[int, int]]:
    """(k, N) for worker k of a ``--launch N`` (the launcher sets
    CARD_SHARE_ENV to "k/N"), else None."""
    value = _os.environ.get(CARD_SHARE_ENV)
    if not value:
        return None
    k, n = value.split("/")
    return int(k), int(n)


def _card_share() -> int:
    """How many processes of this run share this process's card: the
    ranks torchrun started on this host whose LOCAL_RANK maps to the same
    card (LOCAL_WORLD_SIZE of them, spread over the cards round-robin),
    times the workers of a ``--launch N`` under such a rank; else the
    workers of a ``--launch N`` whose index maps to this worker's card."""
    cards = max(1, torch.cuda.device_count())
    worker = _launch_worker()
    if _os.environ.get("LOCAL_RANK") is None:
        return (1 if worker is None
                else len(range(worker[0] % cards, worker[1], cards)))
    share = 1 if worker is None else worker[1]
    local_world = int(_os.environ.get("LOCAL_WORLD_SIZE") or 1)
    if local_world > 1:
        card = _local_rank() % cards
        share *= len(range(card, local_world, cards))
    return share


def _card_memory(device: torch.device) -> Optional[Tuple[int, int]]:
    """(bytes the card can hand out now, its total bytes): the free
    memory plus what torch's caching allocator holds unused, so that an
    earlier run in this process does not shrink the next one's budget.
    None on the CPU."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return free + cached, total


def _device_budget(device: torch.device,
                   of_total: bool = False) -> Optional[int]:
    """Bytes a sweep may hold on its device: DEVICE_BUDGET when it is
    set, else half the memory the card can hand out now (the rest is
    headroom for the allocator and the plain version's temporaries), or
    with ``of_total`` half the card's total, which other processes cannot
    move (sizes recorded for a resume come from it).  A process that
    shares its card with others of the run (``_card_share``: a worker of
    a ``--launch N``, or torchrun ranks on one card) takes its share of
    that: they start together, and each sees the whole card free.  None
    on the CPU unless DEVICE_BUDGET is set: there the plain version keeps
    everything in core."""
    if DEVICE_BUDGET:
        return DEVICE_BUDGET
    memory = _card_memory(device)
    if memory is None:
        return None
    return memory[1 if of_total else 0] // 2 // _card_share()


# Contractions against the reference row (the rel baselines rb, cb and cc)
# made by engines in this process (by K1, or by K6 on the cached-feature
# path), the K1 launches of counter blocks (a block's first dispatch: a
# refetch packs the counters kept on the device), and the counter blocks
# packed at each rung of the pack ladder (first dispatches and refetches
# alike).
BASELINES = 0
K1_BLOCKS = 0
RUNG_BLOCKS = {"rel4": 0, "rel": 0, "narrow": 0, "wide": 0, "none": 0}
# On the cached-feature path: the baselines among BASELINES that K6 made,
# K6's counter blocks (first dispatches), and the K5 feature builds by
# kind: a prepared matrix's g cache, an f cache (an X group's, or the
# stream's loaded rows' or super-row's), a strip's f features, the
# reference row's f and g features, and a stream group's g features.
K6_BASELINES = 0
K6_BLOCKS = 0
FEATURE_BUILDS = {"g": 0, "f": 0, "strip": 0, "ref": 0, "group": 0}


def _cached_plan_for(measure: str) -> Optional[CounterPlan]:
    """The measure's plan when its blocks take the cached-feature path
    (CACHED_MEASURES, with FEATCACHE_BUDGET on), else None."""
    if measure in CACHED_MEASURES and FEATCACHE_BUDGET > 0:
        return get_plan(measure)
    return None


def _split_devices(devices: Sequence[torch.device],
                   tj: int) -> List[torch.device]:
    """The devices an engine of column tile ``tj`` splits its blocks over:
    all of them when there are more than one and they divide ``tj`` (the
    JAX engine's ``_device_mesh``), else the first alone."""
    if len(devices) > 1 and tj > 0 and tj % len(devices) == 0:
        return list(devices)
    return list(devices[:1])


def _g_rows(n_pad: int, tj: int, split: bool) -> int:
    """Rows of the g cache of a prepared matrix of ``n_pad`` rows: on a
    split engine whole blocks of ``tj`` (the JAX engine's blocked cache
    pads its rows with zero features)."""
    return -(-n_pad // tj) * tj if split else n_pad


class _Part:
    """One device of an engine (``_BlockEngine.parts``): its device, and
    the stream its work is queued on, the device's current stream, or for
    a device already in the engine's list (logical devices on one card) a
    stream of its own, so that the parts' launches overlap.  Every tensor
    of a part is made on its stream (``ctx``)."""

    def __init__(self, device: torch.device, own_stream: bool) -> None:
        self.device = device
        self.stream = (torch.cuda.Stream(device)
                       if own_stream and device.type == "cuda" else None)

    def ctx(self):
        """The part's stream as the current one."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def current(self):
        """The stream the part's work is queued on."""
        return (self.stream if self.stream is not None
                else torch.cuda.current_stream(self.device))


class _BlockEngine:
    """Counter blocks for (strip, block) tile pairs on one torch device, or
    split over several.

    Blocks leave the device packed, on the JAX engine's ladder
    (``pack_mode``): with ``rel`` ``prepare`` picks a reference row, and
    blocks go rel4 -> (saturations) -> rel, each residual pack against K1
    baselines computed once per prepared matrix; then, at a ``width`` of
    fewer than 2^16 sites (``packed``), narrow -> (saturations) -> wide,
    else int32 counters ("none").  ``prepare(diff_ref=...)`` sends codes
    diff-encoded.

    Given several ``devices`` and a column tile ``tj`` that they divide,
    the engine splits the columns of every block over them (the JAX
    engine's pair-data parallelism over its "dp" mesh): ``parts`` holds a
    ``_Part`` a device, part d takes columns d tj/k .. (d + 1) tj/k of
    each block (``bounds``; a stream group's columns likewise, those
    past its records taking none).  Every part holds the prepared
    matrices whole (``reps``: the same diffs rebuilt on each, or one
    pinned buffer copied to each), their f features and the strip's, and
    of a g cache its own columns of every block; it launches its blocks'
    counters and packs on its stream (``to_part`` passes a tensor from
    one part to another).  The baselines against the
    reference row are made on the first part (a split g cache's column
    baseline by each part from its columns), and each strip's parts reach
    the first part, where they join in the one-device layout, the rel4
    sidecars merged into the whole blocks' (the parts pack windows of
    their blocks).  rel4 needs tj / 2 to divide over the parts too (the
    JAX engine's ``_rel4_shard_ok``).
    """

    def __init__(self, measure: str, devices: Sequence[torch.device],
                 ti: int, width: int = 0, rel: bool = False, *,
                 tj: int) -> None:
        devices = _split_devices(devices, tj)
        self.measure = measure
        self.plan = get_plan(measure)
        seen: set = set()
        self.parts: List[_Part] = []
        for dev in devices:
            self.parts.append(_Part(dev, dev in seen))
            seen.add(dev)
        self.k = len(self.parts)
        self.tj = tj
        self.part_w = tj // self.k
        self.device = devices[0]
        self.ti = ti
        self.width = width
        self.rel = rel
        self.packed = 0 < width < packing.PACK_LIMIT
        self._rel4_ok = (tj // 2) % self.k == 0
        # the plans' tables on each device
        self._kplans = {dev: plan_to_torch(self.plan, dev) for dev in seen}
        self.kplan = self._kplans[self.device]
        # Diff-encoded uploads: one uploader a part, all against one
        # reference row; set by prepare(diff_ref=), swapped by a stream
        # retarget; the identity of the diff_ref array they were built
        # from, so that prepares sharing one reuse them
        self._ups: Optional[List[DiffUploader]] = None
        self._diff_ref_src = None
        # The reference row of the rel baselines, on the first device
        self.rel_ref: Optional[torch.Tensor] = None
        # Consecutive saturated fetches at the narrow, rel4 and rel rungs
        self._overflow_streak = 0
        self._rel_overflow_streak = 0
        self._rel4_overflow_streak = 0
        # Retargeting of the stream diff reference (see dispatch_stream)
        import threading

        self._retarget_fail_streak = 0
        self._retarget_lock = threading.Lock()
        # Prepared matrices (id -> handle) and their baselines ((id, side)
        # -> (matrix, reference row, baseline)); a stream group's codes
        # are not prepared, and their baselines are not kept
        self._prepared: Dict[int, torch.Tensor] = {}
        self._bases: Dict[tuple, tuple] = {}
        # On a split engine, the parts' copies of each device matrix the
        # engine hands out (id of the first part's -> (it, copies))
        self._reps: Dict[int, tuple] = {}
        # The cached-feature path (the JAX engine's feat_cache_on): its
        # unfolded plan (its tables on each device), the feature caches
        # of the parts' matrices (id -> (matrix, features[, blocked]))
        # and the reference row's (row, f, g) features
        self._cplans = ({dev: cached_plan_to_torch(self.plan, dev)
                         for dev in seen}
                        if _cached_plan_for(measure) is not None else None)
        self.cplan = (self._cplans[self.device] if self._cplans is not None
                      else None)
        self._gcache: Dict[int, tuple] = {}
        self._fcache: Dict[int, tuple] = {}
        self._ref_feats: Optional[tuple] = None

    @property
    def diff_up(self) -> Optional[DiffUploader]:
        """The first part's diff uploader (the one that encodes)."""
        return self._ups[0] if self._ups else None

    @diff_up.setter
    def diff_up(self, up: Optional[DiffUploader]) -> None:
        self._ups = self._uploaders(up) if up is not None else None

    def _uploaders(self, up: DiffUploader) -> List[DiffUploader]:
        """``up`` and an uploader of its reference row for every other
        part."""
        return [up] + [DiffUploader(up.ref, p.device) for p in self.parts[1:]]

    def bounds(self, span: int) -> List[Tuple[int, int, int]]:
        """(part, first column, end column) of each part that takes columns
        of a block ``span`` columns wide."""
        if self.k == 1:
            return [(0, 0, span)]
        w = self.part_w
        return [(d, d * w, min((d + 1) * w, span)) for d in range(self.k)
                if d * w < span]

    def reps(self, handle: torch.Tensor) -> List[torch.Tensor]:
        """The parts' copies of a device matrix the engine handed out."""
        if self.k == 1:
            return [handle]
        entry = self._reps.get(id(handle))
        if entry is None or entry[0] is not handle:
            raise ValueError("a matrix that the split engine did not place")
        return entry[1]

    def _register(self, reps: List[torch.Tensor]) -> torch.Tensor:
        """The handle (the first part's copy) of a matrix placed on every
        part, as ``reps`` lists them."""
        if self.k > 1:
            self._reps[id(reps[0])] = (reps[0], reps)
        return reps[0]

    def _dense(self, host: np.ndarray) -> List[torch.Tensor]:
        """``host`` on every part: through one pinned buffer, copied to
        each."""
        if self.k == 1 or self.device.type != "cuda":
            return [to_device(host, p.device) for p in self.parts]
        staged = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
        staged.copy_(torch.from_numpy(host))
        out = []
        for part in self.parts:
            with part.ctx():
                out.append(staged.to(part.device, non_blocking=True))
        return out

    def _upload(self, ups: List[DiffUploader], enc,
                rows: int) -> List[torch.Tensor]:
        """An encoding rebuilt on every part by its uploader (K3 on
        each)."""
        out = []
        for part, up in zip(self.parts, ups):
            with part.ctx():
                out.append(up.upload_encoded(enc, rows))
        return out

    def to_part(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """``t``, made by part ``src``'s work, for part ``dst``'s: its
        stream waits for what ``src`` queued so far; on one card ``t``
        itself, kept from reuse until that stream is past it, else a copy
        to ``dst``'s card."""
        src_part, dst_part = self.parts[src], self.parts[dst]
        if src == dst or t.device.type != "cuda":
            return t
        done = torch.cuda.Event()
        done.record(src_part.current())
        with dst_part.ctx():
            stream = dst_part.current()
            stream.wait_event(done)
            if t.device == dst_part.device:
                t.record_stream(stream)
                return t
            # the copy runs on the current stream of t's card, after dst's
            t.record_stream(torch.cuda.current_stream(t.device))
            return t.to(dst_part.device, non_blocking=True)

    def prepare(self, matrix: np.ndarray, max_block: int,
                diff_ref: Optional[np.ndarray] = None,
                h2d_memo: Optional[dict] = None, cache_g: bool = False,
                cache_f: bool = False) -> torch.Tensor:
        """Pad and upload a sequence matrix once (to every part).

        Rows are padded so that every strip and block slice of up to
        ``max_block`` rows stays in bounds (torch slicing past the end
        returns a shorter tensor where the JAX engine's dynamic_slice
        clamps); padding sites hold code 0, which adds nothing to any
        counter, and so do padding rows of a dense upload.  ``diff_ref``
        (a width-length code row) enables diff-encoded uploads against it
        for this matrix and later ones (stream groups too): a padding row
        of a diff upload holds the reference row, and the rel4 pack masks
        it.  A dense upload goes through pinned memory.  An engine with
        ``rel`` also sets the reference row of its baselines: the diff
        reference, else a row sample's per-column mode; none under
        DISTANCE_TPU_NO_REL_PACK.

        ``h2d_memo``: a dict the out-of-core sweeps keep for one staged
        super-row across X groups (the JAX engine's): the first prepare
        stores the diff encoding (or its refusal), and a later one with
        the same uploader (a stream retarget swaps it) and the same padded
        rows skips the pad, compare and extract passes on the host.

        ``cache_g`` / ``cache_f`` (the JAX engine's): on the cached-feature
        path, build the matrix's g features (the column side of its
        blocks; on a split engine each part its columns of every block)
        or f features (an out-of-core X group, whose strips run against
        every super-row; the stream's loaded rows or super-row, whose one
        block takes every group; on every part) once, when they fit
        FEATCACHE_BUDGET (the f cache half of it).  The sweep passes them
        only when the cache fits its device budget beside everything else
        (``_cache_bytes``), as the JAX engine's predicates do; a matrix
        without a cache takes K1."""
        n, width = matrix.shape
        n_pad, l_pad = _padded_shape(n, width, self.ti, max_block)
        padded = None

        def _padded() -> np.ndarray:
            nonlocal padded
            if padded is None:
                padded = np.zeros((n_pad, l_pad), dtype=np.uint8)
                padded[:n, :width] = matrix
            return padded

        if diff_ref is not None and not (
            self.diff_up is not None
            and self._diff_ref_src is diff_ref
            and self.diff_up.l_pad == l_pad
        ):
            refp = np.zeros(l_pad, dtype=np.uint8)
            refp[:width] = diff_ref
            self.diff_up = DiffUploader(refp, self.device)
            self._diff_ref_src = diff_ref
        enc = None
        if self.diff_up is not None:
            if (h2d_memo is not None
                    and h2d_memo.get("up") is self.diff_up
                    and h2d_memo.get("n_pad") == n_pad):
                enc = h2d_memo["enc"]
            else:
                enc = self.diff_up.encode(_padded(), n_real=n)
                if h2d_memo is not None:
                    h2d_memo.clear()
                    h2d_memo.update(up=self.diff_up, n_pad=n_pad, enc=enc)
        if enc is not None:
            reps = self._upload(self._ups, enc, n_pad)
        else:
            reps = self._dense(_padded())
        dev = self._register(reps)
        if (self.rel and width > 0 and n
                and not _os.environ.get("DISTANCE_TPU_NO_REL_PACK")):
            if self.diff_up is not None:
                self.rel_ref = self.diff_up.ref_dev()
            else:
                refp = np.zeros(l_pad, dtype=np.uint8)
                refp[:width] = sampled_mode_row(matrix)
                self.rel_ref = to_device(refp, self.device)
        self._prepared[id(dev)] = dev
        if self.cplan is not None:
            need = self.cplan.channels * n_pad * l_pad
            g_need = self.cplan.channels * _g_rows(
                n_pad, self.tj, self.k > 1) * l_pad
            for d, (part, rep) in enumerate(zip(self.parts, reps)):
                with part.ctx():
                    if cache_g and g_need <= FEATCACHE_BUDGET:
                        self._gcache[id(rep)] = (rep, self._gpart(rep, d),
                                                 True)
                    if cache_f and need <= FEATCACHE_BUDGET // 2:
                        self._fcache[id(rep)] = (
                            rep, self._features(rep, "f", "f"))
        return dev

    def _gpart(self, codes: torch.Tensor, d: int) -> torch.Tensor:
        """Part ``d``'s g cache of a prepared matrix's copy ``codes``: its
        features whole on one device; on a split engine those of its
        columns of every block, block after block (the JAX
        ``_jit_feat_builder_blocked``'s local shard; rows past the matrix
        have zero features, the features of code 0)."""
        if self.k == 1:
            return self._features(codes, "g", "g")
        rows, l_pad = codes.shape
        nbp = _g_rows(rows, self.tj, True)
        if nbp != rows:
            codes = torch.cat([codes, codes.new_zeros((nbp - rows, l_pad))])
        w = self.part_w
        mine = codes.view(nbp // self.tj, self.tj, l_pad)[:, d * w:(d + 1) * w]
        return self._features(mine.reshape(-1, l_pad), "g", "g")

    def _features(self, codes: torch.Tensor, side: str,
                  kind: str) -> torch.Tensor:
        """K5 of ``codes``, counted by kind in FEATURE_BUILDS."""
        FEATURE_BUILDS[kind] += 1
        return cached_ops.features(codes, self._cplans[codes.device], side)

    def gfeat_of(self, handle: torch.Tensor) -> Optional[torch.Tensor]:
        """The g-feature cache of a prepared matrix, or of a part's copy of
        it (that part's), or None."""
        entry = self._gcache.get(id(handle))
        return entry[1] if entry is not None and entry[0] is handle else None

    def fx_strip(self, m1: torch.Tensor, i0: int, ti: int) -> torch.Tensor:
        """f features of rows i0.. of ``m1`` (a prepared matrix or a part's
        copy): a slice of its f cache, else built from its codes (once a
        strip of at most the engine's ``ti`` rows: a stream's whole loaded
        side, or a super-row, without its f cache would build them all in
        one temporary)."""
        entry = self._fcache.get(id(m1))
        if entry is not None and entry[0] is m1:
            return entry[1][:, i0 : i0 + ti]
        if ti > self.ti:
            raise ValueError(
                f"f features of {ti} rows without an f cache: a strip"
                f" builds its own only up to {self.ti} rows")
        return self._features(m1[i0 : i0 + ti], "f", "strip")

    def cache_group(self, codes: torch.Tensor, loaded: torch.Tensor) -> None:
        """Build a stream group's g features (one K5 a part, of its rows,
        FEATURE_BUILDS["group"]; the JAX ``counters_xla``'s
        ``features_device(y, plan, "g")``), so that its blocks take K6
        against the f cache of the loaded rows ``loaded`` (which must have
        one) and its column baseline K6 against the reference row's f
        features.  ``drop_group`` frees them, or ``release`` with the
        codes of a staged group."""
        entry = self._fcache.get(id(loaded))
        if entry is None or entry[0] is not loaded:
            raise ValueError("a stream group takes K6 only against loaded"
                             " rows with an f cache")
        reps = self.reps(codes)
        for d, c0, c1 in self.bounds(codes.shape[0]):
            with self.parts[d].ctx():
                self._gcache[id(reps[d])] = (
                    reps[d], self._features(reps[d][c0:c1], "g", "group"),
                    False)

    def drop_group(self, codes: torch.Tensor) -> None:
        """Free a stream group's g features once its contractions and its
        column baseline are queued (a refetch packs the counters its strip
        kept), and forget its parts' codes."""
        for rep in self.reps(codes):
            entry = self._gcache.pop(id(rep), None)
            if entry is not None and entry[0] is rep:
                _free(entry[1])
        self._reps.pop(id(codes), None)

    def ref_features(self, ref: torch.Tensor) -> tuple:
        """(f, g) features of the reference row ``ref``, built once a
        reference row, on the first part."""
        if self._ref_feats is None or self._ref_feats[0] is not ref:
            self._ref_feats = (ref, self._features(ref[None], "f", "ref"),
                               self._features(ref[None], "g", "ref"))
        return self._ref_feats[1:]

    def _k6_baseline(self, fx: torch.Tensor,
                     gy: torch.Tensor) -> torch.Tensor:
        global BASELINES, K6_BASELINES
        BASELINES += 1
        K6_BASELINES += 1
        return cached_ops.contract(fx, gy, self._cplans[fx.device])

    def diff_ref_for(self, source: np.ndarray) -> Optional[np.ndarray]:
        """Reference row for diff-encoded uploads of ``source`` (a row
        sample's per-column mode), or None when diff uploads don't apply
        (an empty source, or disabled by DISTANCE_TPU_NO_DIFF_UPLOAD)."""
        if not source.size or _os.environ.get("DISTANCE_TPU_NO_DIFF_UPLOAD"):
            return None
        return sampled_mode_row(source)

    def _baseline(self, m: torch.Tensor, ref: torch.Tensor,
                  side: str) -> torch.Tensor:
        """K1 of the prepared rows ``m`` against the reference row: side
        "row" c(m, ref) (G, rows), "col" c(ref, m) (G, rows), "self"
        c(ref, ref) (G,) (``m`` is ``ref``).  Kept for a prepared matrix
        and its reference row.  On the cached-feature path K6 computes
        them instead, as the JAX engine does: "row" of a matrix with an f
        cache against the reference row's g features, "col" of a matrix
        with a g cache against its f features (on a split engine each
        part its columns, joined on the first), and "self" once those
        features are built."""
        global BASELINES
        key = (id(m), side)
        hit = self._bases.get(key)
        if hit is not None and hit[0] is m and hit[1] is ref:
            return hit[2]
        r = ref[None]
        fxf = self._fcache.get(id(m)) if side == "row" else None
        gyf = self.gfeat_of(m) if side == "col" else None
        if fxf is not None and fxf[0] is m:
            value = self._k6_baseline(fxf[1],
                                      self.ref_features(ref)[1])[:, :, 0]
        elif gyf is not None and self.k > 1:
            value = self._split_col_baseline(m, ref)
        elif gyf is not None:
            value = self._k6_baseline(self.ref_features(ref)[0], gyf)[:, 0, :]
        elif (side == "self" and self._ref_feats is not None
              and self._ref_feats[0] is ref):
            value = self._k6_baseline(*self.ref_features(ref))[:, 0, 0]
        else:
            if side == "row":
                value = kernels.counters(m, r, self.kplan)[:, :, 0]
            elif side == "col":
                value = kernels.counters(r, m, self.kplan)[:, 0, :]
            else:
                value = kernels.counters(r, r, self.kplan)[:, 0, 0]
            BASELINES += 1
        if side == "self" or id(m) in self._prepared:
            self._bases[key] = (m, ref, value)
        return value

    def _split_col_baseline(self, m: torch.Tensor,
                            ref: torch.Tensor) -> torch.Tensor:
        """c(ref, m) (G, columns) on the first part, from each part's K6 of
        the reference row's f features against its g features: a prepared
        matrix's blocked cache (whole blocks of tj columns, zero past its
        rows), or a stream group's rows."""
        f_ref = self.ref_features(ref)[0]
        vals, blocked = [], False
        for d, rep in enumerate(self.reps(m)):
            entry = self._gcache.get(id(rep))
            if entry is None or entry[0] is not rep:
                continue  # a stream group's part without columns
            blocked = entry[2]
            with self.parts[d].ctx():
                v = self._k6_baseline(self.to_part(f_ref, 0, d),
                                      entry[1])[:, 0, :]
            vals.append(self.to_part(v, d, 0))
        if not blocked:
            return torch.cat(vals, dim=-1)
        g = vals[0].shape[0]
        return torch.stack([v.view(g, -1, self.part_w) for v in vals],
                           dim=2).reshape(g, -1)

    def block(self, m1: torch.Tensor, m2: torch.Tensor, i0: int, j0: int,
              ti: int, tj: int,
              fx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One (ti, tj) launch on the current stream, rows i0.. of ``m1``
        against rows j0.. of ``m2`` (a prepared matrix or group, or one
        part's copies): (G, ti, tj) int32 counters, by K1; or given the
        strip's f features ``fx``, by K6 against rows j0.. of ``m2``'s g
        features (``gfeat_of``: a part's own rows of them)."""
        global K1_BLOCKS, K6_BLOCKS
        rows2 = m2.shape[0] if fx is None else self.gfeat_of(m2).shape[1]
        if i0 + ti > m1.shape[0] or j0 + tj > rows2:
            raise ValueError(
                f"block ({i0}+{ti}, {j0}+{tj}) outside the prepared rows"
                f" ({m1.shape[0]}, {rows2})"
            )
        if fx is not None:
            K6_BLOCKS += 1
            return cached_ops.contract(fx, self.gfeat_of(m2)[:, j0 : j0 + tj],
                                       self._cplans[fx.device])
        K1_BLOCKS += 1
        return kernels.counters(m1[i0 : i0 + ti], m2[j0 : j0 + tj],
                                self._kplans[m1.device])

    def first_dispatch(self, m1: torch.Tensor, m2: torch.Tensor, i0: int,
                       col_starts, ti: int, tj: int,
                       ref: Optional[torch.Tensor] = None):
        """The int32 counters of each block of one strip, rows i0.. of
        ``m1`` against rows j0.. of ``m2`` for each j0 of ``col_starts``,
        each a list of its parts' (G, ti, columns) counters on their
        devices (``bounds``: one (G, ti, tj) block on one device), and on
        the cached-feature path, with a reference row ``ref`` and no f
        cache on ``m1``, the strip rows' baseline against it ((G, ti) on
        the first part, else None: an f cache's is kept whole).  With a
        g cache on ``m2`` each part's f features of the strip are built
        (or sliced) once and each block part is one K6 contraction
        against its g features (the JAX engine's _dispatch_strip;
        ``block``); without one, or on a split engine at a column start
        off the block grid (the JAX ``gcache_usable``), each block part
        is one K1 launch.  Every part's launches are queued before any
        is waited for."""
        bounds = self.bounds(tj)
        r1, r2 = self.reps(m1), self.reps(m2)
        cached = self.gfeat_of(m2) is not None and (
            self.k == 1 or all(j0 % self.tj == 0 for j0 in col_starts))
        if not cached:
            kept = []
            for j0 in col_starts:
                row = []
                for d, c0, c1 in bounds:
                    with self.parts[d].ctx():
                        row.append(self.block(r1[d], r2[d], i0, j0 + c0, ti,
                                              c1 - c0))
                kept.append(row)
            return kept, None
        if i0 + ti > m1.shape[0]:
            raise ValueError(f"strip ({i0}+{ti}) outside the prepared rows"
                             f" ({m1.shape[0]})")
        fxs = {}
        for d, _, _ in bounds:
            with self.parts[d].ctx():
                fxs[d] = self.fx_strip(r1[d], i0, ti)
        kept = []
        for j0 in col_starts:
            row = []
            # a part's g features hold its columns of each block, block
            # after block (one device: the matrix's rows)
            g0 = j0 if self.k == 1 else j0 // self.tj * self.part_w
            for d, c0, c1 in bounds:
                with self.parts[d].ctx():
                    row.append(self.block(r1[d], r2[d], i0, g0, ti, c1 - c0,
                                          fxs[d]))
            kept.append(row)
        rb = None
        if ref is not None and id(m1) not in self._fcache:
            rb = self._k6_baseline(fxs[0], self.ref_features(ref)[1])[:, :, 0]
        return kept, rb

    def baselines(self, m1: torch.Tensor, m2: torch.Tensor,
                  ref: Optional[torch.Tensor], i0: int, ti: int,
                  rb: Optional[torch.Tensor] = None):
        """(rb, cb, cc) of rows i0..i0+ti of ``m1`` and of ``m2``'s rows
        against ``ref`` (the engine's reference row when None): (G, ti),
        (G, rows of m2), (G,) int32, on the first part.  cb and cc are
        kept as ``_baseline`` keeps them; rb is the given one (a
        cached-feature strip's), else a slice of m1's kept row baseline
        (K1's, or K6's over m1's f cache)."""
        if ref is None:
            ref = self.rel_ref
        if rb is None:
            rb = self._baseline(m1, ref, "row")[:, i0 : i0 + ti]
        return (rb, self._baseline(m2, ref, "col"),
                self._baseline(ref, ref, "self"))

    def pack_block(self, c: torch.Tensor, mode: str, i0: int, j0: int,
                   bases=None, nv=None, diag_off=None, col0: int = 0,
                   span: Optional[int] = None):
        """A block's (G, ti, tj) counters at rung ``mode``, or one part's
        (G, ti, columns) window of a block ``span`` columns wide from its
        column ``col0`` on: themselves under "none", their narrow lanes or
        wide words under "narrow" and "wide"; else (lanes, cb[, exc_idx,
        exc_val]) packed against ``bases`` = (rb, cb, cc) on the part's
        device: rb of the block's rows, cb of its whole column side (its
        columns are columns j0.. of it); a window's rel4 sidecar is the
        whole block's segments' (``packing.merge_rel4_sidecars``).  ``nv``
        = (valid rows, valid columns) of the sides: the rel4 pack zeroes
        padding cells so they cannot flood the exception sidecar.
        ``diag_off`` (sweeps over one source): the row side's offset minus
        the column side's, for masking self-pairs; None when the sides
        hold no self-pairs."""
        RUNG_BLOCKS[mode] += 1
        if mode == "none":
            return c
        if mode == "narrow":
            return packing.pack_narrow(self.measure, c, self.width)
        if mode == "wide":
            return packing.pack_wide(self.measure, c)
        tj = c.shape[2]
        rb, cb_all, cc = bases
        cb = cb_all[:, j0 : j0 + tj]
        if mode == "rel4":
            lanes, exc_idx, exc_val = packing.pack_rel4(
                c, rb, cb, cc, i0, j0, nv, diag_off, col0,
                tj if span is None else span)
            return lanes, cb, exc_idx, exc_val
        return packing.pack_rel(c, rb, cb, cc, i0, j0, diag_off), cb

    def dispatch_stream(self, padded: np.ndarray,
                        send_dense) -> Tuple[torch.Tensor, object]:
        """One stream group's codes on the device (on every part): diff
        encoded when the batch is low-diversity, else by ``send_dense()``
        (the group's pinned dense send, to every part).  Returns the codes
        and the reference row of the group's baselines.  The diffs are
        weighed against the dense bytes of the group's own rows (the JAX
        engine pads a group to its full size first).

        When the current reference cannot compress the batch, it is
        retargeted at the batch's own per-column mode (a stream from
        another lineage than the loaded set, or one that drifted); after
        RETARGET_FAIL_LIMIT consecutive candidates that fail too, probing
        stops.  The retarget swaps the uploaders of every part (and, when
        rel packing is on, ``rel_ref``) under the lock, after an unlocked
        probe; each group keeps the uploaders it was encoded with, so its
        codes and its baselines always share one reference."""
        bn = padded.shape[0]
        ups = self._ups
        enc = ups[0].encode(padded, n_real=bn) if ups is not None else None
        if enc is None and ups is not None:
            with self._retarget_lock:
                probe = self._retarget_fail_streak < RETARGET_FAIL_LIMIT
            if probe:
                refp = np.zeros(ups[0].l_pad, dtype=np.uint8)
                refp[:] = sampled_mode_row(padded)
                refp[self.width:] = 0  # keep pad columns zero
                cands = self._uploaders(DiffUploader(refp, self.device))
                enc2 = cands[0].encode(padded, n_real=bn)
                if enc2 is not None:
                    for part, cand in zip(self.parts, cands):
                        with part.ctx():
                            cand.ref_dev()  # upload before publishing
                with self._retarget_lock:
                    if enc2 is not None:
                        self._retarget_fail_streak = 0
                        self._ups = cands  # later groups start here
                        if self.rel_ref is not None:
                            self.rel_ref = cands[0].ref_dev()
                    else:
                        self._retarget_fail_streak += 1
                if enc2 is not None:
                    ups, enc = cands, enc2
        if enc is not None:
            return (self._register(self._upload(ups, enc, bn)),
                    ups[0].ref_dev())
        return (self._register(send_dense()),
                ups[0].ref_dev() if ups is not None else self.rel_ref)

    def mode_for(self, cols: int) -> str:
        """The rung of a dispatch whose blocks have ``cols`` columns: rel4
        packs columns two a byte, so an odd count takes rel."""
        mode = self.pack_mode
        return "rel" if mode == "rel4" and cols % 2 else mode

    @property
    def _rel_usable(self) -> bool:
        return (
            self.rel_ref is not None
            and self._rel_overflow_streak < NARROW_STICKY_LIMIT
        )

    @property
    def _rel4_usable(self) -> bool:
        return (
            self.rel_ref is not None
            and self._rel4_ok
            and self._rel4_overflow_streak < NARROW_STICKY_LIMIT
        )

    @property
    def pack_mode(self) -> str:
        """Escalation ladder: rel4 (4-bit residuals, half of every other
        rung's bytes) -> (saturations) -> rel -> (saturations) ->
        narrow/wide (packed widths) or none (>= 2^16 sites, where 16-bit
        lanes can't hold the counters).  Without a reference row the
        ladder is the historical narrow -> (saturations) -> wide; on a
        split engine whose parts do not divide tj / 2 it starts at rel."""
        if self._rel4_usable:
            return "rel4"
        if self._rel_usable:
            return "rel"
        if not self.packed:
            return "none"
        if self._overflow_streak >= NARROW_STICKY_LIMIT:
            return "wide"
        return "narrow"

    def note_narrow(self, overflowed: bool) -> None:
        """Record a narrow-fetch outcome (drives the sticky escalation)."""
        self._overflow_streak = self._overflow_streak + 1 if overflowed else 0

    def note_rel(self, saturated: bool) -> None:
        self._rel_overflow_streak = (
            self._rel_overflow_streak + 1 if saturated else 0
        )

    def note_rel4(self, saturated: bool) -> None:
        self._rel4_overflow_streak = (
            self._rel4_overflow_streak + 1 if saturated else 0
        )

    def baselines_of(self, handle: torch.Tensor) -> list:
        """The baselines kept for a prepared matrix: (side, reference
        row, baseline) each, for ``keep_baselines`` of its next upload."""
        return [(side, *self._bases[(id(handle), side)][1:])
                for side in ("row", "col") if (id(handle), side) in self._bases]

    def keep_baselines(self, handle: torch.Tensor, kept: list) -> None:
        """Give a prepared matrix the baselines ``baselines_of`` took from
        an earlier upload of the same rows; each serves while the
        reference row is the one it was computed against."""
        for side, ref, value in kept:
            self._bases[(id(handle), side)] = (handle, ref, value)

    def adopt(self, handle: torch.Tensor) -> None:
        """Keep the baselines of codes that ``prepare`` did not upload (a
        staged stream group swept against several super-rows) until
        ``release``."""
        self._prepared[id(handle)] = handle

    def release(self, handle: torch.Tensor) -> None:
        """Free a prepared matrix's memory on every part now rather than
        when its last reference goes (the handle is empty afterwards),
        with its baselines and its feature caches."""
        self._prepared.pop(id(handle), None)
        for side in ("row", "col"):
            self._bases.pop((id(handle), side), None)
        reps = self.reps(handle)
        self._reps.pop(id(handle), None)
        for rep in reps:
            _free(rep)
            for cache in (self._gcache, self._fcache):
                entry = cache.pop(id(rep), None)
                if entry is not None and entry[0] is rep:
                    _free(entry[1])


def _free(tensor: torch.Tensor) -> None:
    """Free a tensor's memory now rather than when its last reference goes
    (it is empty afterwards).  On a CUDA device the allocator hands the
    memory on in stream order, after the kernels already queued."""
    storage = tensor.untyped_storage()
    if storage.resizable():
        storage.resize_(0)


class _Strip:
    """The dispatches of one strip: every column block of rows i0.. of
    ``m1`` against ``m2`` (or of a stream group, or of a staged part of
    one).  The first call counts each block with K1 and keeps the (G, ti,
    tj) int32 counters on the device (on a split engine each part its
    columns, on its device); a later call (a refetch at a lower rung,
    after a saturation) packs the kept counters again and launches no K1.
    ``release`` drops them once the strip is finished.

    A call packs every block at ``mode`` (the engine's ladder by default)
    and concatenates them on the (first) device along columns: one (P,
    ti, span) strip of int32 counters, narrow lanes or wide words, or
    under rel packing (lanes, bundle): lanes concatenated along columns,
    and one sidecar bundle of the column baselines (concatenated), the
    strip-constant row baselines with the self-counter, and under rel4
    the blocks' sidecars stacked to (B, CAP) with block-local indices (the
    host maps them by tj; a split block's parts' sidecars merged).  A
    strip costs two device-to-host copies.  ``nv`` and ``diag_off`` are
    ``_BlockEngine.pack_block``'s; ``ref`` is the reference row of the
    baselines (the engine's by default)."""

    def __init__(self, eng: _BlockEngine, m1, m2, i0: int, col_starts,
                 ti: int, tj: int, nv=None, diag_off=None,
                 ref: Optional[torch.Tensor] = None) -> None:
        self.eng, self.m1, self.m2 = eng, m1, m2
        self.i0, self.col_starts, self.ti, self.tj = i0, col_starts, ti, tj
        self.nv = nv if nv is not None else (m1.shape[0], m2.shape[0])
        self.diag_off, self.ref = diag_off, ref
        self._kept: Optional[List[list]] = None
        self._rb = self._bases = None

    def __call__(self, mode: Optional[str] = None):
        eng = self.eng
        if mode is None:
            mode = eng.mode_for(self.tj)
        rel = mode in ("rel4", "rel")
        if self._kept is None:
            ref = self.ref if self.ref is not None else eng.rel_ref
            self._kept, self._rb = eng.first_dispatch(
                self.m1, self.m2, self.i0, self.col_starts, self.ti,
                self.tj, ref if rel else None)
        if rel and self._bases is None:
            # a stream group's codes are not prepared, so the engine does
            # not keep their baseline: the strip does, on every part
            bases = eng.baselines(self.m1, self.m2, self.ref, self.i0,
                                  self.ti, self._rb)
            self._bases = [tuple(eng.to_part(t, 0, d) for t in bases)
                           for d in range(eng.k)]
        bounds = eng.bounds(self.tj)
        handles = []  # (part, pack) in column order
        for parts, j0 in zip(self._kept, self.col_starts):
            for (d, c0, _), c in zip(bounds, parts):
                with eng.parts[d].ctx():
                    handles.append((d, eng.pack_block(
                        c, mode, self.i0, j0 + c0,
                        self._bases[d] if rel else None, self.nv,
                        self.diag_off, c0, self.tj)))

        def first(d, t):
            return eng.to_part(t, d, 0)

        if mode not in ("rel4", "rel"):
            outs = [first(d, h) for d, h in handles]
            return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        lanes = torch.cat([first(d, h[0]) for d, h in handles], dim=-1)
        rb, cb_all, cc = self._bases[0]
        cb = torch.cat([cb_all[:, j0 : j0 + self.tj]
                        for j0 in self.col_starts], dim=-1)
        rb_cc = torch.cat([rb, cc[:, None]], dim=1)
        if mode != "rel4":
            return lanes, packing.bundle_sidecars(cb, rb_cc)
        exc = [(first(d, h[2]), first(d, h[3])) for d, h in handles]
        if len(bounds) == 1:
            exc_idx = torch.stack([e[0] for e in exc])
            exc_val = torch.stack([e[1] for e in exc])
        else:
            # (parts, blocks, CAP): each block's parts' windowed sidecars
            b = len(self.col_starts)
            exc_idx, exc_val = packing.merge_rel4_sidecars(
                torch.stack([e[0] for e in exc]).view(b, len(bounds), -1)
                .transpose(0, 1),
                torch.stack([e[1] for e in exc]).view(b, len(bounds), -1)
                .transpose(0, 1))
        return lanes, packing.bundle_sidecars(cb, rb_cc, exc_idx, exc_val)

    def release(self) -> None:
        """Drop the kept counters and baselines."""
        self._kept = self._rb = self._bases = None


class _AsyncFetch:
    """Device->host copy of one strip (a tensor, or the (lanes, bundle)
    pair of a packed strip) into pinned memory, started at construction;
    ``result()`` waits for it and returns numpy views."""

    def __init__(self, handle) -> None:
        self._event = None
        self._pair = isinstance(handle, tuple)
        parts = handle if self._pair else (handle,)
        if parts[0].device.type == "cpu":
            self._host = parts
            return
        self._host = tuple(
            torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            for p in parts
        )
        for host, part in zip(self._host, parts):
            host.copy_(part, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def result(self):
        if self._event is not None:
            self._event.synchronize()
        arrs = tuple(h.numpy() for h in self._host)
        return arrs if self._pair else arrs[0]


def _fetch_strip(eng: _BlockEngine, handle: _AsyncFetch, valid_rows: int,
                 valid_cols: int, redispatch: _Strip) -> np.ndarray:
    """Wait for a strip (or a stream group) and unpack the region that is
    emitted -> (G, rows, cols) int32 counters; ``redispatch(mode)``
    dispatches it again at a lower rung after a saturation, from its kept
    counters, which are released here."""
    try:
        return _finish_fetched(eng, handle.result(), valid_rows, valid_cols,
                               redispatch)
    finally:
        redispatch.release()


def _finish_fetched(eng: _BlockEngine, arr, vr: int, vc: int,
                    redispatch) -> np.ndarray:
    """Unpack a fetched strip (the JAX ``_finish_fetched``): a rel-family
    pair reconstructs through ``_unpack_rel_parts`` and, on a saturation,
    takes the refetch ladder; a single array is cropped first (padding
    rows saturate narrow lanes by construction), then at packed widths
    unpacked (its dtype says how it was packed at dispatch: int8 is
    narrow, whatever the engine's rung is now), with a wide refetch when
    a narrow lane saturated."""
    if isinstance(arr, tuple):
        counters, was4 = _unpack_rel_parts(eng, arr, vr, vc)
        (eng.note_rel4 if was4 else eng.note_rel)(counters is None)
        if counters is not None:
            return counters
        return _rel_wide_refetch(eng, redispatch, vr, vc, try_rel=was4)
    arr = arr[:, :vr, :vc]
    if eng.packed and arr.dtype == np.int8:
        counters = packing.unpack_host_narrow(eng.measure, arr, eng.width)
        eng.note_narrow(counters is None)
        if counters is not None:
            return counters
        arr = _AsyncFetch(redispatch("wide")).result()[:, :vr, :vc]
    if eng.packed:
        return packing.unpack_host(eng.measure, arr)
    return arr


def _rel_wide_refetch(eng: _BlockEngine, redispatch, vr: int, vc: int,
                      try_rel: bool = False) -> np.ndarray:
    """Dispatch a saturated rel-family strip again.  A rel4 saturation
    first tries the adjacent int8 rel rung (nibble outliers are almost
    always within int8 range); only a rel saturation pays the wide (or,
    at 2^16 sites or more, int32) refetch."""
    if try_rel and eng.rel_ref is not None:
        parts = _AsyncFetch(redispatch("rel")).result()
        counters, _ = _unpack_rel_parts(eng, parts, vr, vc)
        eng.note_rel(counters is None)  # the ladder must see rel failing
        if counters is not None:
            return counters
    arr = _AsyncFetch(
        redispatch("wide" if eng.packed else "none")).result()[:, :vr, :vc]
    if not eng.packed:
        return arr
    return packing.unpack_host(eng.measure, arr)


def _unpack_rel_parts(eng: _BlockEngine, parts, vr: int, vc: int):
    """Crop a rel-packed fetch — (lanes, bundle) with the fused sidecar
    bundle, or an unbundled (lanes, cb, rb_cc[, exc_idx, exc_val])
    tuple — to the valid region and reconstruct int32 counters.
    Returns (counters_or_None, was_rel4); counters is None on lane
    saturation (sidecar overflow under rel4).

    rel4 lanes expand to full-width residuals first: exception indices
    address the padded tensor, and a strip's sidecars are per-block
    ((B, CAP) int32, block-local flat indices into (G, ti, tj))."""
    from distance_tpu_torch.ops.packing import (
        REL4_SAT, finish_host_rel4, unbundle_sidecars, unpack_host_rel,
        unpack_rel4_nibbles,
    )

    if len(parts) == 2:
        cb_, rb_cc_, ei, ev = unbundle_sidecars(parts[1])
        parts = (parts[0], cb_, rb_cc_) + (
            (ei, ev) if ei is not None else ()
        )
    lanes, cb, rb_cc = parts[:3]
    rb, cc = rb_cc[:, :vr], rb_cc[:, -1]
    if len(parts) == 5:
        exc_idx, exc_val = parts[3], parts[4]
        from distance_tpu_torch._native import get_lib

        lib = get_lib()
        if (
            lib is not None
            and isinstance(lanes, np.ndarray)
            and lanes.flags.c_contiguous
        ):
            return _rel4_finish_native(
                lib, lanes, rb, cb, cc, exc_idx, exc_val, vr, vc
            ), True
        res = unpack_rel4_nibbles(lanes)  # full padded (G, rows, span)
        # -8 is saturation ONLY where no exception patches it (a patched
        # residual may legitimately be -8)
        bad = res == REL4_SAT
        flat, flatbad = res.reshape(-1), bad.reshape(-1)
        if exc_idx.ndim == 1:  # single tensor (stream group / one block)
            sel = exc_idx >= 0
            idx = exc_idx[sel]
            flat[idx] = exc_val[sel]
            flatbad[idx] = False
        else:  # (B, CAP): block-local indices into (G, ti, tj)
            g_span = res.shape[1] * res.shape[2]
            n_blocks = exc_idx.shape[0]
            tj = res.shape[2] // n_blocks
            for b in range(n_blocks):
                idx = exc_idx[b]
                sel = idx >= 0
                idx = idx[sel]
                g, rem = idx // (res.shape[1] * tj), idx % (res.shape[1] * tj)
                r, c = rem // tj, rem % tj
                pos = g * g_span + r * res.shape[2] + b * tj + c
                flat[pos] = exc_val[b][sel]
                flatbad[pos] = False
        return finish_host_rel4(
            res[:, :vr, :vc], rb, cb[:, :vc], cc, bad[:, :vr, :vc]
        ), True
    return (
        unpack_host_rel(lanes[:, :vr, :vc], rb, cb[:, :vc], cc),
        False,
    )


def _rel4_finish_native(lib, lanes, rb, cb, cc, exc_idx, exc_val,
                        vr: int, vc: int):
    """Native rel4 finish: one GIL-released C pass per row chunk expands
    the nibble lanes, applies the rank-1 baseline, and counts -8
    sentinels in the cropped region; exception positions are then
    patched vectorized on host (each was emitted as a sentinel, so
    sentinels minus patched positions = genuine saturations).  Returns
    (G, vr, vc) int32 counters, or None on saturation (caller refetches).
    Bit-identical to the numpy path (tests/test_packing.py)."""
    import ctypes

    from distance_tpu_torch.ops.diffup import _get_pool, _row_chunks

    g_n, rows, ch = lanes.shape
    out = np.empty((g_n, vr, vc), dtype=np.int32)
    rb_c = np.ascontiguousarray(rb, dtype=np.int32)         # (G, vr)
    cb_c = np.ascontiguousarray(cb[:, :vc], dtype=np.int32)  # (G, vc)
    p_i8 = ctypes.POINTER(ctypes.c_int8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    pool = _get_pool()
    chunks = _row_chunks(vr, pool._max_workers)

    def run(task):
        g, (r0, r1) = task
        return lib.dt_rel4_expand_add(
            lanes[g].ctypes.data_as(p_i8), ch, r0, r1,
            rb_c[g].ctypes.data_as(p_i32), cb_c[g].ctypes.data_as(p_i32),
            ctypes.c_int32(int(cc[g])), vc,
            out[g].ctypes.data_as(p_i32),
        )

    tasks = [(g, span) for g in range(g_n) for span in chunks]
    sent = sum(pool.map(run, tasks) if len(tasks) > 1 else [run(tasks[0])])

    patched = 0
    ei = exc_idx if exc_idx.ndim == 2 else exc_idx[None]
    ev = exc_val if exc_val.ndim == 2 else exc_val[None]
    span_res = 2 * ch
    tj = span_res // ei.shape[0]
    for b in range(ei.shape[0]):
        idx = ei[b]
        sel = idx >= 0
        idx = idx[sel].astype(np.int64)
        if not idx.size:
            continue
        g = idx // (rows * tj)
        rem = idx % (rows * tj)
        r, c = rem // tj, rem % tj
        gcol = b * tj + c
        m = (r < vr) & (gcol < vc)
        g, r, gcol = g[m], r[m], gcol[m]
        out[g, r, gcol] = (
            ev[b][sel][m] + rb_c[g, r] + cb_c[g, gcol] - cc[g]
        )
        patched += int(m.sum())
    if sent - patched:
        return None
    return out


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
    n1 = setup.loaded[0].n
    n2 = n1 if setup.streamed is not None else setup.loaded[-1].n
    device = device_of(setup.backend)
    deterministic = setup.shard is not None
    if setup.tile_i == 0:
        setup.tile_i = _cap_tile_ram(
            _auto_tile(n1, device), n2, setup.measure, deterministic
        )
    if setup.tile_j == 0:
        setup.tile_j = _auto_tile(n2, device)


def _choose_tiles(n1: int, n2: int, setup: Setup, device: torch.device,
                  ndev: int = 1) -> Tuple[int, int]:
    """(ti, tj) of a loaded sweep.  On ``ndev`` devices tj is rounded up to
    a multiple of lcm(2 ndev, ti), with the JAX engine's note: its blocks'
    columns then split over the devices, rel4's halved columns too, and
    every block start stays on the strip grid that ``prepare`` pads
    for.  On one device a tj that neither divides ti nor is a multiple of
    it (6 against 8) is rounded up to a multiple of ti for the same
    reason: a block starting off the grid would reach past the padded
    rows (the JAX engine's one-device path shifts such a block's columns
    instead)."""
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
    if ndev > 1:
        mult = math.lcm(2 * ndev, ti)
        why = f"lcm(2 x {ndev} devices, tile_i {ti})"
    else:
        mult, why = (ti if ti % tj else 1), f"tile_i {ti}"
    if tj % mult:
        adj = -(-tj // mult) * mult
        print(
            f"[distance-tpu] note: tile_j {tj} -> {adj} (multiple of {why})",
            file=sys.stderr,
        )
        tj = adj
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


def _strip_grid(square: bool, n1: int, n2: int,
                ti: int) -> Tuple[List[int], List[int]]:
    """First rows of the strips of a loaded sweep and their pair counts:
    the resume units and the weights of the shard split."""
    if square:
        starts = list(range(0, n1 - 1, ti))
        return starts, [sum(n1 - 1 - i for i in range(i0, min(i0 + ti, n1)))
                        for i0 in starts]
    starts = list(range(0, n1, ti))
    return starts, [min(ti, n1 - i0) * n2 for i0 in starts]


def _emit_strip(setup: Setup, plan: CounterPlan, strip: np.ndarray, si: int,
                i0: int, col0: int, same_offset: int,
                emitter: _AsyncEmitter, pool: _ScratchPool, after) -> None:
    """Finalize and emit one strip: its (G, si, cols) counters hold rows
    i0..i0+si-1 from column col0 on.  The square emits (i, j) for j > i,
    the rectangle full rows, row-major; ``after`` runs on the emitter
    thread once the strip's rows are written."""
    aln1, aln2 = setup.loaded[0], setup.loaded[-1]
    lease: List[np.ndarray] = []
    with phase_timer("gather"):
        gathered = _gather_emit(strip, si, i0, aln2.n, col0, pool, lease,
                                tri=len(setup.loaded) == 1)
    if gathered is None:
        return
    rows_c, pair_i, col_idx = gathered
    counters = {name: rows_c[k] for k, name in enumerate(plan.counters)}
    _emit_pairs(
        setup, aln1, aln2, pair_i, col_idx, counters, same_offset,
        emitter=emitter, after=after, pool=pool, lease=lease,
    )


def _sweep_load(setup: Setup) -> None:
    """The in-core sweep of one alignment (its upper triangle) or of two
    (file1 x file2, row-major)."""
    square = len(setup.loaded) == 1
    aln1, aln2 = setup.loaded[0], setup.loaded[-1]
    n1, n2 = aln1.n, aln2.n
    if setup.shard is None or setup.shard[0] == 0:
        setup.writer.header()
    if square and n1 < 2:
        return
    sources = [a.matrix for a in setup.loaded]
    width = aln1.width
    same_offset = 0
    pruned = _prune_invariant_columns(sources)
    if pruned is not None:
        sources, same_offset, width = pruned
    devices = devices_of(setup.backend)
    device = devices[0]
    ti, tj = _choose_tiles(n1, n2, setup, device, len(devices))
    split = len(_split_devices(devices, tj)) > 1
    # (rows, max_block) of each prepared matrix.  The rectangle prepares
    # file1 for strips and file2 for blocks, both at the engine's strip
    # stride ti (as the JAX engine does, engine.py:3006-3016).
    prepared = [(n1, max(ti, tj))] if square else [(n1, ti), (n2, tj)]
    rows = [_padded_shape(n, width, ti, mb)[0] for n, mb in prepared]
    # the square's X is its Y
    footprint = _blocked_footprint(
        0 if square else rows[0], rows[-1], width,
        len(get_plan(setup.measure).counters), ti, tj,
    )
    budget = _device_budget(device)
    # the cached-feature path when its caches fit beside the rest (the
    # JAX engine's predicates): it never sends a sweep out of core
    cplan = _cached_plan_for(setup.measure)
    cache_g = cplan is not None and _cache_fits(
        cplan, _g_rows(rows[-1], tj, split), width, ti, tj, footprint,
        budget)
    if budget is not None and footprint > budget:
        print(
            f"[distance-tpu] out-of-core {'' if square else 'rectangle '}"
            f"sweep: {footprint / 1e9:.2f} GB of device memory >"
            f" {budget / 1e9:.2f} GB device budget",
            file=sys.stderr,
        )
        _sweep_blocked(setup, sources, width, same_offset, devices, ti, tj,
                       budget)
        return
    eng = _BlockEngine(setup.measure, devices, ti, width, rel=True, tj=tj)
    with phase_timer("diff-ref"):
        diff_ref = eng.diff_ref_for(sources[0])
    with phase_timer("prepare-upload"):
        # the g cache on the column side (the square's one matrix, the
        # rectangle's file2)
        mats = [eng.prepare(src, mb, diff_ref=diff_ref,
                            cache_g=cache_g and k == len(sources) - 1)
                for k, (src, (_, mb)) in enumerate(zip(sources, prepared))]
    m1, m2 = mats[0], mats[-1]
    plan = eng.plan
    # the square masks its self-pairs; rel4 masks rows and columns past
    # the records
    diag_off = 0 if square else None

    strip_starts, weights = _strip_grid(square, n1, n2, ti)
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
            strip = _Strip(eng, m1, m2, i0,
                           list(range(i0 if square else 0, n2, tj)), ti, tj,
                           (n1, n2), diag_off)
            yield ordinal, i0, strip, _AsyncFetch(strip())

    def emit(item):
        ordinal, i0, strip, handle = item
        si = min(ti, n1 - i0)
        col0 = i0 if square else 0
        strip = _fetch_strip(eng, handle, si, n2 - col0, strip)
        _emit_strip(
            setup, plan, strip, si, i0, col0, same_offset, emitter, pool,
            after=lambda: (_progress_mark(setup, ordinal + 1), meter.tick()),
        )

    try:
        _pipeline_strips(strips(), emit)
        emitter.finish()
    finally:
        for mat in mats:
            eng.release(mat)


# ---------------------------------------------------------------------------
# Out-of-core sweeps
# ---------------------------------------------------------------------------

def _upload_bytes(rows: int, l_pad: int) -> int:
    """Device bytes of uploading ``rows`` padded rows: the codes and,
    while a diff upload rebuilds them, its (index, code) pairs, at most
    2/3 of the codes (a diff upload wins 3x or is refused, and its
    capacity at most doubles it).  Linear in ``rows``."""
    return rows * (l_pad + -(-2 * l_pad // 3))


def _pack_bytes(counters_per_pair: int, width: int) -> int:
    """Bytes a pair of the largest pack of a strip or group: below 2^16
    sites the wide words (rel4, rel and narrow lanes are smaller), else
    the int32 counters' concatenation along columns."""
    if width >= packing.PACK_LIMIT:
        return 4 * counters_per_pair
    return 2 if counters_per_pair == 1 else 4 * ((counters_per_pair + 1) // 2)


# Device bytes of a block's rel4 exception sidecar (exc_idx, exc_val) with
# its copy in the strip's bundle.
_SIDECAR_BYTES = 16 * packing.REL4_EXC_CAP


def _blocked_footprint(x_rows: int, y_rows: int, width: int,
                       counters_per_pair: int, ti: int, tj: int,
                       kept: int = 0) -> int:
    """Device bytes of a square or rectangle sweep, in core or out of
    core, whose X and Y sides are prepared as ``x_rows`` and ``y_rows``
    rows (``x_rows`` 0 when X is Y, as in the in-core square): both
    uploads, a row and a column K1 baseline of each prepared row and of
    ``kept`` rows more (the staged super-rows' kept ones), the strips in
    flight, each holding its int32 counters (kept for a refetch) and its
    blocks' rel4 sidecars, the packs of one strip at a time (a dispatch
    or a refetch: its blocks' packs and their concatenation along
    columns, each at most ``_pack_bytes`` a pair; a pack is freed once
    its copy to the host is queued), and the reference row.  Affine in
    ``y_rows`` over multiples of ``tj``."""
    l_pad = _padded_shape(1, width, 1, 1)[1]
    g4 = 4 * counters_per_pair
    pack = _pack_bytes(counters_per_pair, width)
    strip = g4 * ti * y_rows + -(-y_rows // tj) * _SIDECAR_BYTES
    return (_upload_bytes(x_rows + y_rows, l_pad)
            + g4 * (2 * (x_rows + y_rows) + kept + 1)
            + (STRIP_LOOKAHEAD + 1) * strip + 2 * pack * ti * y_rows + l_pad)


def _cache_bytes(plan: CounterPlan, cached_rows: int, width: int, ti: int,
                 tj: int) -> int:
    """Device bytes the cached-feature path adds to a sweep whose feature
    caches hold ``cached_rows`` prepared rows: those caches (R int8 a
    padded site), the f features of one strip of ``ti`` rows (a strip's
    are built at its first dispatch and freed once its contractions are
    queued, before the next strip's), the reference row's f and g
    features, and for a shared plan one (ti, tj) block's per-channel
    products (R int32 a pair, freed once mixed).  A stream's cache is a
    group's g features (built at its dispatch, freed once its block and
    its column baseline are queued; a staged group's serve every
    super-row), and its strip the loaded rows' f cache."""
    l_pad = _padded_shape(1, width, 1, 1)[1]
    r = plan.total_channels
    mix = 4 * r * ti * tj if plan.mix_num is not None else 0
    return r * l_pad * (cached_rows + ti + 2) + mix


def _cache_fits(plan: CounterPlan, cached_rows: int, width: int, ti: int,
                tj: int, footprint: int, budget: Optional[int]) -> bool:
    """Whether an in-core sweep of ``footprint`` device bytes engages a g
    cache of ``cached_rows`` prepared rows: the cache within
    FEATCACHE_BUDGET, and the sweep with the cached path's bytes within
    the device budget (the JAX engine's predicates, engine.py:1051-1071)."""
    l_pad = _padded_shape(1, width, 1, 1)[1]
    return (plan.total_channels * cached_rows * l_pad <= FEATCACHE_BUDGET
            and (budget is None
                 or footprint + _cache_bytes(plan, cached_rows, width, ti, tj)
                 <= budget))


def _staged_cache(plan: Optional[CounterPlan], width: int, ti: int,
                  tj: int) -> Optional[CounterPlan]:
    """``plan`` when an out-of-core sweep's super-rows of at least ``tj``
    rows can keep their g caches within FEATCACHE_BUDGET, else None (the
    sweep then takes K1)."""
    l_pad = _padded_shape(1, width, 1, 1)[1]
    if plan is None or (plan.total_channels * (tj + max(ti, tj)) * l_pad
                        > FEATCACHE_BUDGET):
        return None
    return plan


def _x_cache_rows(cache: Optional[CounterPlan], group: int, width: int,
                  ti: int) -> int:
    """Prepared rows of an out-of-core X group of ``group`` rows that its f
    cache holds: all of them when it fits half of FEATCACHE_BUDGET (the
    predicate of ``_BlockEngine.prepare``), else 0 (no f cache)."""
    if cache is None:
        return 0
    rows, l_pad = _padded_shape(group, width, ti, ti)
    return rows if cache.total_channels * rows * l_pad <= (
        FEATCACHE_BUDGET // 2) else 0


def _layout_footprint(group: int, rows: int, n_y: int, width: int,
                      counters_per_pair: int, ti: int, tj: int,
                      cache: Optional[CounterPlan] = None,
                      split: bool = False) -> int:
    """Device bytes of an out-of-core sweep against ``n_y`` columns in X
    groups of ``group`` rows and super-rows of ``rows``: ``_blocked_footprint``
    of one of each (a super-row prepared as ``max(ti, tj)`` rows more,
    every super-row of at least ``tj`` rows keeping a baseline of its
    prepared rows), and with ``cache`` the cached-feature path's bytes
    (``_cache_bytes``: the X group's f cache when it has one, the
    super-row's g cache, in whole blocks on a ``split`` engine)."""
    pad = max(ti, tj)
    kept = n_y + -(-n_y // tj) * pad
    fp = _blocked_footprint(group, rows + pad, width, counters_per_pair, ti,
                            tj, kept)
    if cache is not None:
        fp += _cache_bytes(cache, _x_cache_rows(cache, group, width, ti)
                           + _g_rows(rows + pad, tj, split), width, ti, tj)
    return fp


def _blocked_layout(n_x: int, n_y: int, width: int, counters_per_pair: int,
                    ti: int, tj: int, budget: int,
                    cache: Optional[CounterPlan] = None,
                    split: bool = False) -> Tuple[int, int]:
    """(X-group rows, Y super-row rows) of an out-of-core sweep of ``n_x``
    rows against ``n_y`` columns.

    An X group is a multiple of ``ti``, so that its strips keep the
    in-core sweep's resume ordinals.  Its (G, rows, n_y) int32 counter
    buffer takes at most half of HOST_BUF_BUDGET, unless one strip alone
    needs more (``_cap_tile_ram`` bounds that strip), and its codes at
    most a third of the device budget.  A super-row is a multiple of
    ``tj``, prepared as at most ``max(ti, tj)`` rows more, and takes the
    rest, as ``_layout_footprint`` counts it beside the baselines every
    super-row keeps (``_StagedSide``).

    ``cache`` (the plan of the cached-feature path, ``_staged_cache``): an
    X row then costs its R features too (the JAX engine's (1 + R) x
    l_pad row bytes), an X group keeps an f cache when it fits half of
    FEATCACHE_BUDGET (``_BlockEngine.prepare``), every super-row a g cache
    within FEATCACHE_BUDGET, and the layout counts them
    (``_cache_bytes``; a ``split`` engine's g caches in whole blocks)."""
    l_pad = _padded_shape(1, width, 1, 1)[1]
    r = cache.total_channels if cache is not None else 0
    host_cap = HOST_BUF_BUDGET // 2 // max(1, n_y * counters_per_pair * 4)
    group = max(ti, min(host_cap // ti * ti,
                        budget // 3 // ((1 + r) * l_pad) // ti * ti,
                        -(-n_x // ti) * ti))
    pad = max(ti, tj)

    def footprint(rows: int) -> int:
        return _layout_footprint(group, rows, n_y, width, counters_per_pair,
                                 ti, tj, cache, split)

    per_tj = footprint(tj) - footprint(0)
    rows = max(0, budget - footprint(0)) // per_tj * tj
    if cache is not None:
        rows = min(rows, (FEATCACHE_BUDGET // (r * l_pad) - pad) // tj * tj)
    return group, max(tj, min(rows, -(-n_y // tj) * tj))


class _StagedSide:
    """A host-resident matrix staged through the device in super-rows:
    the Y side of the out-of-core sweeps, the loaded side of the staged
    stream.

    Two levels of reuse (the JAX engine's).  On the host, each
    super-row's diff encoding against ``diff_ref`` is kept
    (``prepare(h2d_memo=)``), so a super-row staged again ships its
    diffs without the pad, compare and extract passes; memos stop being
    admitted past half of HOST_BUF_BUDGET (the X groups' and staged
    groups' counter buffers take the other half).  On the device, the
    last staged super-row stays, and ``serpentine`` alternates the sweep
    direction, so the last super-row of one group is the first of the
    next: one upload fewer per group.  The resident super-row is released
    before the next one is uploaded, so one slot is on the device at a
    time, with its g cache under ``cache_g`` (a blocked sweep's Y side)
    or its f cache under ``cache_f`` (the cached stream's loaded side),
    built from the codes on the device each time it is staged.  Uploads
    run on the current stream, after the kernels that read the released
    super-row: the allocator hands its memory on in stream order.  The
    baselines of a released super-row stay on the device (G int32 a
    prepared row, which the layouts count), so a super-row staged again
    against the same reference row launches none, whichever kernel made
    them (the counters are exact integers).
    """

    def __init__(self, eng: _BlockEngine, source: np.ndarray,
                 max_block: int, diff_ref: Optional[np.ndarray] = None,
                 cache_g: bool = False, cache_f: bool = False) -> None:
        self.eng = eng
        self.source = source
        self.max_block = max_block
        self.diff_ref = diff_ref
        self.cache_g = cache_g
        self.cache_f = cache_f
        self._memos: Dict[Tuple[int, int], dict] = {}
        self._memo_bytes = 0
        self._bases: Dict[Tuple[int, int], list] = {}
        self._dev: Optional[torch.Tensor] = None
        self._key: Optional[Tuple[int, int]] = None
        self._serp = False

    def serpentine(self, spans: list) -> list:
        """The spans in alternating direction on successive calls."""
        self._serp = not self._serp
        return list(spans) if self._serp else list(reversed(spans))

    def get(self, q0: int, q1: int) -> torch.Tensor:
        """source[q0:q1] prepared on the device (no upload when it is the
        resident super-row)."""
        key = (q0, q1)
        if self._key == key:
            return self._dev
        self.drop()
        memo = self._memos.get(key)
        if memo is None and self._memo_bytes < HOST_BUF_BUDGET // 2:
            memo = self._memos[key] = {}
        prev = memo.get("enc") if memo is not None else None
        with phase_timer("ooc-stage"):
            self._dev = self.eng.prepare(self.source[q0:q1], self.max_block,
                                         diff_ref=self.diff_ref,
                                         h2d_memo=memo, cache_g=self.cache_g,
                                         cache_f=self.cache_f)
        if memo is not None and memo.get("enc") is not prev:
            # a prepare may replace a kept encoding (a retarget swapped
            # the uploader), not only fill an empty one
            for enc, sign in ((prev, -1), (memo.get("enc"), 1)):
                if enc is not None:
                    self._memo_bytes += sign * (enc[0].nbytes + enc[1].nbytes)
        self.eng.keep_baselines(self._dev, self._bases.get(key, []))
        self._key = key
        return self._dev

    def drop(self) -> None:
        """Release the resident super-row (not the host memos, nor its
        baselines)."""
        if self._dev is not None:
            self._bases[self._key] = self.eng.baselines_of(self._dev)
            self.eng.release(self._dev)
            self._dev, self._key = None, None


def _sweep_blocked(setup: Setup, sources: List[np.ndarray], width: int,
                   same_offset: int, devices: List[torch.device], ti: int,
                   tj: int, budget: int) -> None:
    """Out-of-core square or rectangle sweep (the JAX engine's
    ``_sweep_square_blocked`` and ``_sweep_rectangle_blocked``).

    The codes stay on the host.  Groups of X rows (the square's rows, or
    file1's) are uploaded once each; Y super-rows (the square's columns,
    or file2's) are staged through ``_StagedSide``; both go diff-encoded
    against one reference row of file1's.  Each strip of the group runs
    against each super-row, packed on the ladder of the in-core sweep
    (the square masking its self-pairs, and rel4 the padding of both
    sides), with at most STRIP_LOOKAHEAD strips ahead of the one being
    fetched; a saturated strip is packed again from its kept counters.
    The counters accumulate in the group's host buffer;
    the group's strips then emit in the in-core order, so the bytes, the
    resume units and the shard bounds are the in-core sweep's.
    """
    square = len(setup.loaded) == 1
    aln1, aln2 = setup.loaded[0], setup.loaded[-1]
    n1, n2 = aln1.n, aln2.n
    src1, src2 = sources[0], sources[-1]
    eng = _BlockEngine(setup.measure, devices, ti, width, rel=True, tj=tj)
    plan = eng.plan
    g = len(plan.counters)
    split = eng.k > 1
    cache = _staged_cache(_cached_plan_for(setup.measure), width, ti, tj)
    group_rows, sr_rows = _blocked_layout(n1, n2, width, g, ti, tj, budget,
                                          cache, split)
    if cache is not None and _layout_footprint(
            group_rows, sr_rows, n2, width, g, ti, tj, cache, split) > budget:
        # the least layout with the caches passes the budget: K1
        cache = None
        group_rows, sr_rows = _blocked_layout(n1, n2, width, g, ti, tj,
                                              budget)
    # the f cache of an X group when the layout counted it
    x_cache = _x_cache_rows(cache, group_rows, width, ti) > 0
    strip_starts, weights = _strip_grid(square, n1, n2, ti)
    a, b = _split_strips(weights, setup.shard)
    if a >= b:
        return
    done = _resume_skip(setup)
    row_lo = strip_starts[a]
    row_hi = min(n1, strip_starts[b - 1] + ti)
    from distance_tpu_torch.utils.timing import ProgressMeter

    meter = ProgressMeter("sweep (out-of-core)", weights[a + done : b])
    emitter = _AsyncEmitter()
    pool = _ScratchPool()
    with phase_timer("diff-ref"):
        dref = eng.diff_ref_for(src1)
    yside = _StagedSide(eng, src2, tj, dref, cache_g=cache is not None)

    def sweep_super_row(dev_x, bufs, g0, g1, col0, q0, q1):
        """Every strip of the group against source2[q0:q1], into bufs."""
        dev_y = yside.get(q0, q1)
        nv = (g1 - g0, q1 - q0)
        # a self-pair: X row g0 + r is Y row q0 + c
        diag_off = g0 - q0 if square else None

        def strips():
            for i0_loc in range(0, g1 - g0, ti):
                abs_i0 = g0 + i0_loc
                lo = 0
                if square:
                    # only columns j > abs_i0 are emitted: start at the
                    # aligned block holding abs_i0
                    if q1 <= abs_i0 + 1:
                        continue
                    if q0 <= abs_i0:
                        lo = (abs_i0 - q0) // tj * tj
                strip = _Strip(eng, dev_x, dev_y, i0_loc,
                               list(range(lo, q1 - q0, tj)), ti, tj, nv,
                               diag_off)
                yield i0_loc, lo, _AsyncFetch(strip()), strip

        def fill(item):
            i0_loc, lo, handle, strip = item
            si = min(ti, g1 - g0 - i0_loc)
            with phase_timer("ooc-fetch-wait"):
                strip = _fetch_strip(eng, handle, si, q1 - q0 - lo, strip)
            dst = q0 + lo - col0
            if dst < 0:
                # the first aligned block begins before the group's column
                # origin g0 when tj does not divide g0: clip its columns
                # rather than let a negative offset wrap the buffer
                strip = strip[:, :, -dst:]
                dst = 0
            bufs[:, i0_loc : i0_loc + si, dst : dst + strip.shape[2]] = strip

        # every strip is fetched (and refetched) before the next super-row
        # is staged and before the group's codes are released
        _pipeline_strips(strips(), fill)

    try:
        for g0 in range(row_lo, row_hi, group_rows):
            g1 = min(g0 + group_rows, row_hi)
            # resume: skip groups whose strips are all emitted
            if (g1 - 1 - row_lo) // ti < done:
                continue
            col0 = g0 if square else 0
            with phase_timer("ooc-xgroup-prepare"):
                dev_x = eng.prepare(src1[g0:g1], ti, diff_ref=dref,
                                    cache_f=x_cache)
            try:
                bufs = np.zeros((g, g1 - g0, n2 - col0), dtype=np.int32)
                spans = [(q0, min(q0 + sr_rows, n2))
                         for q0 in range(0, n2, sr_rows)
                         if min(q0 + sr_rows, n2) > col0]
                for q0, q1 in yside.serpentine(spans):
                    sweep_super_row(dev_x, bufs, g0, g1, col0, q0, q1)
            finally:
                eng.release(dev_x)
            for i0_loc in range(0, g1 - g0, ti):
                ordinal = (g0 + i0_loc - row_lo) // ti
                if ordinal < done:
                    continue
                si = min(ti, g1 - g0 - i0_loc)
                _emit_strip(
                    setup, plan, bufs[:, i0_loc : i0_loc + si], si,
                    g0 + i0_loc, col0, same_offset, emitter, pool,
                    after=lambda ordinal=ordinal: (
                        _progress_mark(setup, ordinal + 1), meter.tick()
                    ),
                )
        emitter.finish()
    finally:
        yside.drop()


# ---------------------------------------------------------------------------
# Streamed sweep
# ---------------------------------------------------------------------------

class _StreamSplit:
    """Variant/invariant column split for stream mode.

    Every counter is a columnwise sum of per-code-pair weights
    W_k(a, b) (ops/features.reference_counter_matrix).  A column where
    every LOADED row holds one code ``a`` contributes W_k(a, b_r) to
    each pair of streamed record r — independent of the loaded row — so
    the device sweep runs over the variant columns only, and each
    record's invariant contribution is restored as a per-record counter
    offset computed from one small code-pair histogram (native
    dt_code_hist, one pass over the record's bytes).  Exactness is
    unconditional; wire bytes and MXU work shrink by the invariant
    fraction.  This is the streamed-path analog of the reference's
    consensus-difference sparsification (measures.rs:28-53) and of the
    loaded-path invariant-column pruning above.
    """

    def __init__(self, matrix: np.ndarray, plan: CounterPlan):
        from distance_tpu_torch.encoding import ALL_CODES
        from distance_tpu_torch.ops.features import reference_counter_matrix

        first = matrix[0:1]
        inv = (matrix == first).all(axis=0) if matrix.size else (
            np.zeros(matrix.shape[1], dtype=bool)
        )
        self.frac = float(inv.mean()) if inv.size else 0.0
        if inv.size and inv.all():
            # keep one column on-device so the block engine always has a
            # non-empty matrix (identical loaded rows edge case)
            inv = inv.copy()
            inv[0] = False
        self.keep = ~inv
        nc = len(ALL_CODES)
        # bins: (code a, code b) pairs row-major, plus one sentinel row
        # absorbing variant columns (ignored by the zero weight tail)
        self.nbins = nc * nc + nc
        idx_lut = np.zeros(256, dtype=np.uint8)
        idx_lut[ALL_CODES] = np.arange(nc, dtype=np.uint8)
        self.idx_lut = idx_lut
        colkey = np.full(matrix.shape[1], nc * nc, dtype=np.int16)
        colkey[inv] = idx_lut[first[0][inv]].astype(np.int16) * nc
        self.colkey = np.ascontiguousarray(colkey)
        self.wflat = {}
        for name in plan.counters:
            w = reference_counter_matrix(name)[
                np.ix_(ALL_CODES, ALL_CODES)
            ].astype(np.int32)
            flat = np.zeros(self.nbins, dtype=np.int32)
            flat[: nc * nc] = w.reshape(-1)
            self.wflat[name] = flat

    def offsets(self, mat: np.ndarray) -> Dict[str, np.ndarray]:
        """Counter name -> (rows,) int32 invariant-column offsets."""
        hist = self._hist(np.ascontiguousarray(mat))
        return {k: hist @ w for k, w in self.wflat.items()}

    def _hist(self, mat: np.ndarray) -> np.ndarray:
        import ctypes

        from distance_tpu_torch._native import get_lib

        rows, width = mat.shape
        hist = np.zeros((rows, self.nbins), dtype=np.int32)
        lib = get_lib()
        if lib is None:
            keys = self.colkey[None, :].astype(np.int32) + self.idx_lut[mat]
            keys += np.arange(rows, dtype=np.int32)[:, None] * self.nbins
            hist[:] = np.bincount(
                keys.ravel(), minlength=rows * self.nbins
            ).reshape(rows, self.nbins)
            return hist
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        p_i16 = ctypes.POINTER(ctypes.c_int16)
        p_i32 = ctypes.POINTER(ctypes.c_int32)

        def run(a, b):
            lib.dt_code_hist(
                mat[a:b].ctypes.data_as(p_u8), b - a, width,
                self.colkey.ctypes.data_as(p_i16),
                self.idx_lut.ctypes.data_as(p_u8),
                hist[a:b].ctypes.data_as(p_i32), self.nbins,
            )

        chunk = max(64, rows // 8)
        if rows > 2 * chunk:
            from distance_tpu_torch.finalize import _get_pool

            pool = _get_pool()
            futs = [
                pool.submit(run, a, min(a + chunk, rows))
                for a in range(0, rows, chunk)
            ]
            for f in futs:
                f.result()
        elif rows:
            run(0, rows)
        return hist

def _transpose_add(mat: np.ndarray, n1: int, bn: int,
                   add: Optional[np.ndarray],
                   spool: Optional[_ScratchPool] = None,
                   lease: Optional[List[np.ndarray]] = None) -> np.ndarray:
    """(n1_pad, rows_pad)-strided counter matrix -> flat streamed-major
    (bn*n1,) int32 vector with an optional per-streamed-record offset
    added (stream variant-split).  Native blocked transpose chunked
    across the pool when available; numpy fallback otherwise.  With
    ``spool``/``lease`` the output recycles through the scratch pool
    (give_all once the emission tail is done with it)."""
    from distance_tpu_torch._native import get_lib

    lib = get_lib()
    if (
        lib is None
        or mat.dtype != np.int32
        or mat.strides[1] != 4
        or mat.strides[0] % 4
    ):
        out = np.ascontiguousarray(mat[:n1, :bn].T).reshape(-1)
        if add is not None:
            out = out + np.repeat(add, n1)
        return out
    import ctypes

    from distance_tpu_torch.ops.diffup import _get_pool, _row_chunks

    add_c = np.ascontiguousarray(
        add if add is not None else np.zeros(bn, dtype=np.int32),
        dtype=np.int32,
    )
    out = (
        spool.take(bn * n1, np.int32, lease)
        if spool is not None and lease is not None
        else np.empty(bn * n1, dtype=np.int32)
    )
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    in_stride = mat.strides[0] // 4
    pool = _get_pool()

    def run(span):
        c0, c1 = span
        lib.dt_transpose_add_i32(
            mat.ctypes.data_as(p_i32), n1, in_stride, c0, c1,
            add_c.ctypes.data_as(p_i32), out.ctypes.data_as(p_i32),
        )

    chunks = _row_chunks(bn, pool._max_workers)
    if len(chunks) > 1:
        list(pool.map(run, chunks))
    else:
        run(chunks[0])
    return out

def _threaded_iter(it, maxsize: int = 64):
    """Run an iterator in a background thread (bounded queue).

    The reference's stream reader is its own thread (lib.rs:288-306); this
    overlaps FASTA parse+encode with device dispatch and emission.  An
    exception from the source is re-raised here only after every earlier
    item has been consumed — preserving the mid-stream-error contract
    (all fully-read batches are emitted first).
    """
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=maxsize)
    sentinel = object()

    def run() -> None:
        try:
            for item in it:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:  # re-raised on the consumer side
            q.put(e)

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _stream_group_size(n1: int, width: int, measure: str,
                       device: torch.device, sharded: bool = False) -> int:
    """Streamed records per device group, even: as many as fit, up to
    STREAM_GROUP_CAP.

    Each group in flight (the one computed and the STREAM_PENDING before
    it) holds its emission buffers on the host (~(G + 2) int32 per pair)
    and, within the device budget of the card's total memory, what
    ``_stream_footprint`` counts beside the loaded side (``width`` is the
    loaded side's width on the device, after the variant split).  The
    size is a resume unit, so it does not follow the memory that is free.  A nonzero STREAM_GROUP fixes it instead.

    Under a shard (``sharded``) the groups are also the units the merge
    interleaves, so every shard must cut the stream alike, whatever card
    and host it runs on: the size then follows only the inputs, the
    measure and the module constants (the pinned host allowance of
    ``_strip_ram_budget(deterministic=True)``, the cap, K1's y-row limit,
    and the staged group's host cap of ``_stream_layout``), never a
    card's or a host's memory.  Either way a group's (G, n1, rows)
    counters stay within what one rel pack takes (``packing.MAX_CELLS``).
    """
    if STREAM_GROUP:
        return max(2, STREAM_GROUP + (STREAM_GROUP & 1))
    g = len(get_plan(measure).counters)
    in_flight = STREAM_PENDING + 1
    ram = (_strip_ram_budget(deterministic=True) if sharded
           else _strip_ram_budget())
    rows = min(STREAM_GROUP_CAP, ram // (in_flight * (g + 2) * n1 * 4),
               packing.MAX_CELLS // (g * max(1, n1)))
    if sharded:
        rows = min(rows, kernels.MAX_Y_ROWS, _staged_group_cap(n1, g))
        return max(2, rows // 2 * 2)
    budget = _device_budget(device, of_total=True)
    if budget is not None:
        fixed = _stream_footprint(0, n1, width, g, in_flight)
        per_row = _stream_footprint(1, n1, width, g, in_flight) - fixed
        rows = min(rows, (budget - fixed) // per_row)
    return max(2, rows // 2 * 2)


def _staged_group_cap(n1: int, counters_per_pair: int) -> int:
    """Most records in a staged group: its (G, n1, rows) int32 host
    buffer takes at most half of HOST_BUF_BUDGET, but the group is never
    below STAGED_ROWS_FLOOR."""
    col_bytes = max(1, counters_per_pair * n1 * 4)
    return max(STAGED_ROWS_FLOOR, HOST_BUF_BUDGET // 2 // col_bytes // 2 * 2)


@dataclass(frozen=True)
class _StreamLayout:
    """How a stream runs: ``group`` streamed records at most per device
    group (the resume unit), ``pending`` groups computed ahead of the one
    being emitted, ``sr_rows`` loaded rows per super-row of a staged
    stream (0 when the loaded side is on the device whole), and whether
    its blocks take the cached-feature form (``cached``: the loaded rows'
    f cache, each group's g features, K6) or K1."""

    group: int
    pending: int
    sr_rows: int = 0
    cached: bool = False


def _stream_layout(n1: int, width: int, measure: str, device: torch.device,
                   ti: int, sharded: bool = False) -> _StreamLayout:
    """In core when the loaded codes and STREAM_PENDING + 1 groups fit the
    device budget; staged otherwise (the JAX engine's ``_run_stream``
    staging, sized for int32 counters).

    The group size is a resume unit, so it is fixed by the card's total
    memory, never by what is free: ``_stream_group_size`` when the loaded
    side fits half the card in core, else the staged size, that raised to
    2048 records and then bounded so that its (G, n1, rows) host buffer
    takes at most half of HOST_BUF_BUDGET, but never below
    STAGED_ROWS_FLOOR.  A nonzero STREAM_GROUP fixes it instead, and
    under a shard ``_stream_group_size`` gives it whatever the card.
    Only the choice between in core and staged follows the free memory.
    Fewer groups are in flight when their buffers would pass half the
    host budget.  A super-row, a multiple of ``ti``, takes the device
    budget left beside one group.  ``_stream_footprint`` counts both
    layouts, and ``_stream_group_size`` sizes with it too.  A
    group, in core, and a super-row's part of one, staged, stay within
    what one rel pack takes (``packing.MAX_CELLS``).

    Then, for a measure of the cached-feature path (``_cached_plan_for``),
    whether its caches engage (``_stream_cache_fits``): in core beside
    the in-core footprint; staged with super-rows sized with the caches
    counted (an f cache of R bytes a site on every loaded row of a
    super-row, the JAX staged stream's (1 + R) bytes a site), and K1's
    super-rows when even the least of those does not fit.  The caches
    never move the group size or the choice between in core and staged.
    """
    g = len(get_plan(measure).counters)
    col_bytes = max(1, g * n1 * 4)
    cplan = _cached_plan_for(measure)

    def fits(budget: Optional[int], grows: int) -> bool:
        # one launch and one pack over the whole group
        if g * n1 * grows > packing.MAX_CELLS:
            return False
        return budget is None or _stream_footprint(
            grows, n1, width, g, STREAM_PENDING + 1) <= budget

    grows = _stream_group_size(n1, width, measure, device, sharded)
    if not (STREAM_GROUP or sharded) and not fits(
            _device_budget(device, of_total=True), grows):
        grows = min(max(grows, 2048), _staged_group_cap(n1, g))
    budget = _device_budget(device)
    if fits(budget, grows):
        return _StreamLayout(grows, STREAM_PENDING, cached=(
            cplan is not None and _stream_cache_fits(
                cplan, n1, grows, width,
                _stream_footprint(grows, n1, width, g, STREAM_PENDING + 1),
                budget)))
    pending = max(1, min(STREAM_PENDING,
                         HOST_BUF_BUDGET // 2 // (col_bytes * grows)))

    def footprint(rows: int, cache: Optional[CounterPlan] = None) -> int:
        # one group at a time against a super-row; every loaded row keeps
        # its baseline (``_StagedSide``)
        fp = _stream_footprint(grows, rows, width, g, 1, kept=n1)
        if cache is not None:
            fp += _cache_bytes(cache, grows, width, rows, grows)
        return fp

    def super_row(cache: Optional[CounterPlan] = None) -> int:
        per_row = footprint(1, cache) - footprint(0, cache)
        rows = min(max(0, budget - footprint(0, cache)) // per_row,
                   packing.MAX_CELLS // (g * grows))
        if cache is not None:
            # the f cache within half of FEATCACHE_BUDGET (``prepare``)
            rows = min(rows, FEATCACHE_BUDGET // 2 // (
                cache.total_channels * _padded_shape(1, width, 1, 1)[1]))
        return max(ti, min(rows // ti * ti, -(-n1 // ti) * ti))

    if cplan is not None:
        rows = super_row(cplan)
        if _stream_cache_fits(cplan, rows, grows, width, footprint(rows),
                              budget):
            return _StreamLayout(grows, pending, rows, cached=True)
    return _StreamLayout(grows, pending, super_row())


def _stream_footprint(grows: int, rows: int, width: int,
                      counters_per_pair: int, groups: int,
                      kept: int = 0) -> int:
    """Device bytes of a stream, in core or staged: ``rows`` loaded rows
    on the device (all of them, or one super-row) with their K1
    baselines and those of ``kept`` rows more (the staged super-rows'
    kept ones); ``groups`` groups of ``grows`` records in flight, each
    with its codes, its baselines, its (G, rows, grows) int32 counters
    (kept for a refetch) and a rel4 sidecar; the pack of one group at a
    time (``_pack_bytes`` a pair: a group is one block, whose pack needs
    no concatenation); and the reference row.  Affine in ``grows`` and in
    ``rows``."""
    l_pad = _padded_shape(1, width, 1, 1)[1]
    g4 = 4 * counters_per_pair
    pack = _pack_bytes(counters_per_pair, width)
    group = (_upload_bytes(grows, l_pad) + g4 * grows + g4 * rows * grows
             + _SIDECAR_BYTES)
    return (_upload_bytes(rows, l_pad) + g4 * (rows + kept + 1)
            + groups * group + pack * rows * grows + l_pad)


def _stream_cache_fits(plan: CounterPlan, rows: int, grows: int, width: int,
                       footprint: int, budget: Optional[int]) -> bool:
    """Whether a stream of ``footprint`` device bytes with ``rows`` loaded
    rows on the device (all of them, or a super-row) and groups of
    ``grows`` records engages the cached-feature form: the loaded rows'
    f cache within half of FEATCACHE_BUDGET (``_BlockEngine.prepare``'s
    rule), and ``_cache_fits`` of its one (rows, grows) block, whose
    group's g features are the cache and whose loaded rows the strip.
    Otherwise the stream takes K1, decided before any launch."""
    l_pad = _padded_shape(1, width, 1, 1)[1]
    return (plan.total_channels * rows * l_pad <= FEATCACHE_BUDGET // 2
            and _cache_fits(plan, grows, width, rows, grows, footprint,
                            budget))


class _GroupUploads:
    """Stream groups into device memory through reused host buffers.

    A group is assembled in place in a host buffer (``take``) and sent to
    the device (``send``).  On a CUDA device there are two pinned
    buffers, and each copy runs non-blocking on a side stream, so it
    overlaps the kernel of the group before it.  An event recorded after
    the copy guards its buffer: ``take`` waits on it before the buffer is
    refilled (the copy returns at once, and would otherwise read the next
    group's codes), and the compute stream waits on it before the kernel
    reads the codes.  On the CPU there is one buffer, and a group gets a
    copy of it: a refetch after a saturation reads the group's codes
    again after the next groups have refilled the buffer.

    Buffers are zeroed once; a group overwrites the rows it sends, and
    the site columns past the loaded width stay code 0.  On a split
    engine (``parts``) one buffer is copied to every part, by a side
    stream of each card, and each part's stream waits for its copy.
    """

    def __init__(self, rows: int, width: int, parts: List[_Part]) -> None:
        self.parts = parts
        cuda = parts[0].device.type == "cuda"
        self._bufs = [
            torch.zeros((rows, width), dtype=torch.uint8, pin_memory=cuda)
            for _ in range(2 if cuda else 1)
        ]
        self._copied: List[list] = [[] for _ in self._bufs]
        self._k = 0
        self._sides = ({p.device: torch.cuda.Stream(p.device) for p in parts}
                       if cuda else None)

    def take(self) -> np.ndarray:
        """The next host buffer, once the copies that last read it are
        done."""
        for copied in self._copied[self._k]:
            copied.synchronize()
        return self._bufs[self._k].numpy()

    def send(self, rows: int) -> List[torch.Tensor]:
        """The first ``rows`` rows of the buffer ``take`` returned, on
        every part's device, ordered before any later work of its
        stream."""
        k = self._k
        self._k = (k + 1) % len(self._bufs)
        host = self._bufs[k][:rows]
        if self._sides is None:
            return [host.clone() for _ in self.parts]
        out, events = [], []
        for part in self.parts:
            side = self._sides[part.device]
            compute = part.current()
            with torch.cuda.stream(side):
                # allocated on the side stream, which writes it first
                codes = torch.empty(host.shape, dtype=torch.uint8,
                                    device=part.device)
                codes.copy_(host, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            compute.wait_event(copied)
            # its memory is not reused before the compute stream is done
            codes.record_stream(compute)
            out.append(codes)
            events.append(copied)
        self._copied[k] = events
        return out


def _run_stream(setup: Setup, split: Optional[_StreamSplit],
                layout: _StreamLayout) -> None:
    """Stream records against one loaded alignment (lib.rs:269-365).

    The loaded side's variant columns (``split``) are prepared on the
    device once, on a thread of their own, while the stream parses.
    Records are read at the user's ``-b`` granularity and gathered into
    groups of at most ``layout.group`` rows; a group holds whole user
    batches (a batch larger than a group fills groups of its own).  Per
    group, the codes go to the device diff-encoded (``dispatch_stream``,
    which retargets the reference row) or dense, one counter block
    computes the (G, n1, rows) counters (``layout.cached``: K5 builds the
    group's g features, contracted by K6 against the f cache that K5
    built once for the loaded rows, with the baselines by K6 too; else
    one K1 launch), and one pack at the engine's
    rung gives rel4 (an odd group rel) lanes and a sidecar bundle, or
    narrow lanes or wide words, which are copied back asynchronously into
    pinned memory with ``layout.pending`` groups in flight; the host
    finishes the counters (a saturated group is packed again at the next
    rung from its counters, kept on the device), transposes them to
    streamed-major order, adds each record's invariant-column offset and
    emits.  A staged stream (``layout.sr_rows``) keeps the loaded side on
    the host and sweeps it in super-rows per group instead, each
    super-row's part packed and finished on its own
    (``_dispatch_stream_staged``).  A group is one resume unit.  On a bad
    streamed record every fully read user batch is emitted first, then
    the error is raised.

    Under ``--shard K/N`` groups go round-robin by global ordinal: every
    shard parses the whole stream but uploads and launches only the
    groups ``g`` with ``g % N == K``; the resume key is the shard's own
    count of groups.  With an output path each emitted group is recorded
    in the part's ``.units`` sidecar (``UnitIndex``: global ordinal and
    bytes, and the group size), which the merge interleaves.
    """
    from concurrent.futures import ThreadPoolExecutor

    aln = setup.loaded[0]
    n1, width = aln.n, aln.width
    grows = layout.group
    shard_k, shard_n = setup.shard if setup.shard is not None else (0, 1)
    done = _resume_skip(setup)
    unit_index = None
    if setup.shard is not None and setup.out_path is not None:
        unit_index = UnitIndex(setup.out_path)
        if done:
            if not unit_index.load() or len(unit_index.units) < done:
                raise DistanceError(
                    "Cannot resume sharded stream: missing or short"
                    f" units index {unit_index.sidecar}"
                )
            unit_index.truncate(done)
    setup.writer.header()
    if unit_index is not None and not done:
        try:
            unit_index.preamble = setup.writer.tell()
        except (OSError, AttributeError):
            unit_index = None
    if unit_index is not None:
        # saved now, so that a shard left without groups still has its
        # sidecar (and its group size) for the merge
        unit_index.group = grows
        unit_index.save()
    plan = get_plan(setup.measure)
    width_dev = int(split.keep.sum()) if split is not None else width
    l_pad = _padded_shape(n1, width_dev, 1, 1)[1]
    # one launch covers every loaded row (of a super-row, when staged), so
    # they need no strip padding; a group's records split over the
    # devices when they divide the group size (the JAX engine's
    # _device_mesh(rows_pad))
    eng = _BlockEngine(setup.measure, devices_of(setup.backend), 1,
                       width_dev, rel=True, tj=grows)
    mat_loaded = (
        np.ascontiguousarray(aln.matrix[:, split.keep])
        if split is not None else aln.matrix
    )
    prep_fut = lside = None

    def diff_ref():
        # streamed records share ancestry with the loaded set, so its
        # per-column mode is the diff reference of both
        return (None if _os.environ.get("DISTANCE_TPU_NO_DIFF_UPLOAD")
                else mode_row(mat_loaded))

    if layout.sr_rows:
        print(
            f"[distance-tpu] staged stream: {n1 * l_pad / 1e9:.2f} GB"
            f" loaded matrix swept from the host in super-rows of"
            f" {layout.sr_rows} rows per group of {grows}",
            file=sys.stderr,
        )
        with phase_timer("diff-ref"):
            lside = _StagedSide(eng, mat_loaded, 1, diff_ref(),
                                cache_f=layout.cached)
        spans = [(q0, min(q0 + layout.sr_rows, n1))
                 for q0 in range(0, n1, layout.sr_rows)]
    else:
        def prepare():
            with phase_timer("stream-prepare-upload"):
                return eng.prepare(mat_loaded, 1, diff_ref=diff_ref(),
                                   cache_f=layout.cached)

        # The loaded side's upload (with its reference row) overlaps the
        # stream parse.  Its future's result() raises a failed upload on
        # the thread that consumes it.
        preparer = ThreadPoolExecutor(1)
        prep_fut = preparer.submit(prepare)
        preparer.shutdown(wait=False)
    uploads = _GroupUploads(grows, l_pad, eng.parts)

    pending: List[tuple] = []
    emitter = _AsyncEmitter()
    # groups repeat the same (bn, n1) shape: emission index arrays are
    # computed once per distinct bn; counter vectors recycle through the
    # scratch pool
    emit_idx_cache: Dict[int, tuple] = {}
    spool = _ScratchPool()

    def flush_one() -> None:
        (g_ord, local_ord, ids2, bcounts, offs, bn, handle,
         redispatch) = pending.pop(0)
        with phase_timer("stream-fetch-wait"):
            # (G, n1, bn); a staged group is finished already
            strip = (handle if isinstance(handle, np.ndarray) else
                     _fetch_strip(eng, handle, n1, bn, redispatch))
        # Emission: for each streamed record (outer), all loaded (inner)
        # with columns (loaded_id, streamed_id) — lib.rs:322-333.
        with phase_timer("stream-gather"):
            cached = emit_idx_cache.get(bn)
            if cached is None:
                local_cols = np.repeat(np.arange(bn, dtype=np.int32), n1)
                row_idx = np.tile(np.arange(n1, dtype=np.int32), bn)
                if len(emit_idx_cache) >= 4:  # bn takes few values
                    emit_idx_cache.pop(next(iter(emit_idx_cache)))
                emit_idx_cache[bn] = (row_idx, local_cols)
            else:
                row_idx, local_cols = cached
            # streamed-major emission == the transposed (bn, n1) flat
            # view, plus each record's invariant-column contribution
            lease: List[np.ndarray] = []
            counters = {
                name: _transpose_add(
                    strip[k], n1, bn,
                    offs[name] if offs is not None else None,
                    spool, lease,
                )
                for k, name in enumerate(plan.counters)
            }
        bc = None
        if setup.measure == "tn93":
            # loaded side indexed by row_idx, streamed side by local_cols
            bc = (aln.base_counts, row_idx, bcounts, local_cols)
        with phase_timer("keys"):
            if (
                setup.measure == "tn93" and bcounts is not None
                and aln.base_counts is not None
            ):
                uniq, inv = np.unique(bcounts, axis=0, return_inverse=True)
                grp_ranks = (
                    np.ascontiguousarray(inv.reshape(-1), dtype=np.int32),
                    int(uniq.shape[0]),
                )
                keys, keyspace = _tn93_value_keys(
                    counters, aln.tally_ranks(), row_idx, grp_ranks,
                    local_cols, spool, lease,
                )
            else:
                keys, keyspace = _value_keys(setup.measure, counters,
                                             width, spool, lease)
        if keys is not None:
            # deferred finalize-by-representative (see _emit_pairs): the
            # writer calls back with one row per distinct key
            measure = setup.measure

            def values(first_rows, counters=counters, bc=bc):
                if first_rows is None:
                    with phase_timer("finalize"):
                        return finalize_block(measure, counters, bc)
                sub = {k: v[first_rows] for k, v in counters.items()}
                sbc = None
                if bc is not None:
                    bcq, iq, bct, it = bc
                    sbc = (bcq, iq[first_rows], bct, it[first_rows])
                with phase_timer("finalize"):
                    return finalize_block(measure, sub, sbc)
        else:
            with phase_timer("finalize"):
                values = finalize_block(setup.measure, counters, bc)

        def tail(ids2=ids2, row_idx=row_idx, local_cols=local_cols,
                 values=values, keys=keys, keyspace=keyspace,
                 g_ord=g_ord, local_ord=local_ord, lease=lease):
            try:
                if unit_index is not None:
                    pos0 = setup.writer.tell()
                setup.writer.rows(
                    aln.ids, ids2, row_idx, local_cols, values, keys,
                    keyspace,
                )
                if unit_index is not None:
                    unit_index.append(g_ord, setup.writer.tell() - pos0)
                    unit_index.save()
                _progress_mark(setup, local_ord + 1)
            finally:
                spool.give_all(lease)

        with phase_timer("stream-emit-wait"):
            emitter.submit(tail)

    group: List[tuple] = []  # (batch, r0, r1): rows r0..r1-1 of a batch
    group_rows = 0
    g_ordinal = 0  # global group ordinal (shard-independent)
    local_idx = 0  # this shard's group count (the resume key)

    def dispatch_group() -> None:
        nonlocal group, group_rows, g_ordinal, local_idx
        pieces, bn = group, group_rows
        group, group_rows = [], 0
        if not pieces:
            return
        this_global = g_ordinal
        g_ordinal += 1
        if this_global % shard_n != shard_k:
            return
        this_local = local_idx
        local_idx += 1
        if this_local < done:
            return
        with phase_timer("stream-group-build"):
            ids2 = [i for b, r0, r1 in pieces for i in b.ids[r0:r1]]
            bcounts = (
                np.concatenate([b.base_counts[r0:r1] for b, r0, r1 in pieces])
                if pieces[0][0].base_counts is not None
                else None
            )
        with phase_timer("stream-upload"):
            buf = uploads.take()
            offs_parts = []
            r = 0
            for b, r0, r1 in pieces:
                m = b.matrix[r0:r1]
                if split is not None:
                    offs_parts.append(split.offsets(m))
                    m = m[:, split.keep]
                buf[r : r + r1 - r0, : m.shape[1]] = m
                r += r1 - r0
            offs = (
                {
                    k: np.concatenate([p[k] for p in offs_parts])
                    for k in offs_parts[0]
                }
                if split is not None
                else None
            )
            if lside is None:
                m1 = prep_fut.result()
                codes, ref = eng.dispatch_stream(
                    buf[:bn], lambda: uploads.send(bn))
        redispatch = None
        if lside is not None:
            fetch = _dispatch_stream_staged(
                eng, lside, spans, buf[:bn], lambda: uploads.send(bn), n1,
                bn)
        else:
            # one block over the whole (G, n1, bn) group (the group's g
            # features against the loaded rows' f cache by K6, else K1),
            # the baselines and one pack; its counters stay on the device
            # for a refetch at a lower rung
            if layout.cached:
                eng.cache_group(codes, m1)
            redispatch = _Strip(eng, m1, codes, 0, [0], n1, bn, (n1, bn),
                                None, ref)
            try:
                fetch = _AsyncFetch(redispatch())
            finally:
                eng.drop_group(codes)
        pending.append((this_global, this_local, ids2, bcounts, offs, bn,
                        fetch, redispatch))
        while len(pending) > layout.pending:
            flush_one()

    _SENTINEL = object()
    try:
        it = _threaded_iter(stream_fasta(
            setup.streamed, width, setup.measure, setup.consensus,
            max(1, setup.batchsize),
        ))
        while True:
            with phase_timer("stream-parse-wait"):
                batch = next(it, _SENTINEL)
            if batch is _SENTINEL:
                break
            rows = batch.matrix.shape[0]
            for r0 in range(0, rows, grows):
                r1 = min(r0 + grows, rows)
                if group_rows + r1 - r0 > grows:
                    dispatch_group()
                group.append((batch, r0, r1))
                group_rows += r1 - r0
            if group_rows == grows:
                dispatch_group()
    except DistanceError:
        # a bad streamed record: emit every fully read user batch first;
        # the stream error is the one reported
        dispatch_group()
        while pending:
            flush_one()
        try:
            emitter.finish()
        except Exception:
            pass
        raise
    dispatch_group()
    while pending:
        flush_one()
    if lside is not None:
        lside.drop()
    else:
        # a run whose groups were all emitted before a resume never
        # consumed the upload: a failed one must still surface
        eng.release(prep_fut.result())
    emitter.finish()


def _dispatch_stream_staged(eng: _BlockEngine, lside: _StagedSide,
                            spans: List[Tuple[int, int]], padded: np.ndarray,
                            send_dense, n1: int, bn: int) -> np.ndarray:
    """One stream group against a host-resident loaded side: its finished
    (G, n1, bn) counters.

    The group's codes go to the device once (``dispatch_stream``: diff
    encoded, or ``send_dense()``), after the first super-row is staged,
    so that the uploader exists; they and their reference serve every
    super-row (the JAX engine's ``h2d_cache``), and their baselines are
    kept until the group is done.  On the cached-feature form (the
    super-rows staged with their f caches, ``lside.cache_f``) the group's
    g features are built once then too, serve every super-row, and go
    with its codes.  Each loaded super-row is staged (in serpentine
    order, so the boundary super-row of the last group is not uploaded
    again), its block launched (K6, else K1: the super-row as x against
    the group), packed at the engine's rung, and fetched and finished
    into the group's buffer, with its own refetch, before the next
    super-row is staged.
    """
    buf = np.empty((len(eng.plan.counters), n1, bn), dtype=np.int32)
    codes = ref = None
    try:
        for q0, q1 in lside.serpentine(spans):
            m1 = lside.get(q0, q1)
            if codes is None:
                with phase_timer("stream-upload"):
                    codes, ref = eng.dispatch_stream(padded, send_dense)
                eng.adopt(codes)
                if lside.cache_f:
                    eng.cache_group(codes, m1)

            strip = _Strip(eng, m1, codes, 0, [0], q1 - q0, bn,
                           (q1 - q0, bn), None, ref)
            part = _AsyncFetch(strip())
            with phase_timer("ooc-fetch-wait"):
                buf[:, q0:q1] = _fetch_strip(eng, part, q1 - q0, bn, strip)
    finally:
        if codes is not None:
            eng.release(codes)
    return buf
