"""Multi-process and multi-host runs: shard-by-process launch, rendezvous,
merge.

The port of ``distance_tpu/parallel/multihost.py``.  The reference runs
as one command that spawns all of its own workers (reference/src/lib.rs:
367-474, thread::spawn); this module gives the port the same
single-command use across *processes and hosts*:

* ``--launch N`` — spawn N local worker processes, each computing the
  k-th of N balanced shards (engine ``--shard k/N``) on card k mod the
  card count, each with its share of that card's auto device budget, and
  merge their part files into the final output as workers finish (the
  reference's ``gather_write`` reorder buffer, lifted to process
  granularity).
* ``--num-hosts N --host-id K [--coordinator ADDR]`` — multi-host runs
  on a shared filesystem: every host derives its shard from its index,
  writes ``<output>.partK`` plus a ``.done`` marker, and host 0 merges
  once all markers exist.  With ``--coordinator`` the hosts also meet in
  a ``torch.distributed`` rendezvous (gloo; nothing but the rendezvous
  and the exit barrier crosses processes), and the indices default to
  torchrun's ``WORLD_SIZE``/``RANK``; without it they come from the
  explicit flags.

Merging is mode-aware: load-mode (square/rectangle) shards are
contiguous row-strip ranges, so parts concatenate byte-for-byte; stream
mode shards device-batch groups round-robin, so each part carries a
``.units`` sidecar indexing its emission units by global group ordinal
and the merge interleaves units in ordinal order.  Either way the final
file is byte-identical to a single-process run.  The sidecar also
records the shard's group size, and parts cut into different groups are
refused rather than interleaved.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from distance_tpu_torch.fastaio import DistanceError

# Set by ``launch`` in its workers' environment only, never by a user:
# "k/N" for worker k of N, which takes card k mod the card count
# (``engine.devices_of``) and its share of the auto device budget of that
# card, 1 over the workers on it (``engine._card_share``).
CARD_SHARE_ENV = "DISTANCE_TPU_TORCH_CARD_SHARE"
# Seconds the --coordinator rendezvous waits for every host (JAX's
# jax.distributed.initialize waits as long): a missing peer fails the
# run instead of hanging it.
RENDEZVOUS_TIMEOUT_S = 300.0


# ---------------------------------------------------------------------------
# Stream-mode unit index
# ---------------------------------------------------------------------------

class UnitIndex:
    """Byte-range index of one part file's emission units.

    Stream-mode shards emit device-batch groups round-robin; this sidecar
    (``<part>.units``) records the part's preamble length (header bytes,
    shard 0 only) and ``[global_ordinal, nbytes]`` per unit so the merge
    can interleave parts in global order.  Rewritten atomically at every
    checkpoint; a resume truncates it in lockstep with the output.
    """

    def __init__(self, path: str):
        self.path = path
        self.preamble = 0
        self.units: List[List[int]] = []  # [global_ordinal, nbytes]
        # records per stream group: every shard must cut the stream into
        # the same groups for the ordinals to interleave
        self.group: Optional[int] = None

    @property
    def sidecar(self) -> str:
        return self.path + ".units"

    def load(self) -> bool:
        try:
            with open(self.sidecar) as f:
                d = json.load(f)
            self.preamble = int(d["preamble"])
            self.units = [[int(a), int(b)] for a, b in d["units"]]
            self.group = d.get("group")
            return True
        except (OSError, ValueError, KeyError):
            return False

    def truncate(self, n_units: int) -> None:
        self.units = self.units[:n_units]

    def append(self, ordinal: int, nbytes: int) -> None:
        self.units.append([ordinal, nbytes])

    def save(self) -> None:
        tmp = self.sidecar + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"preamble": self.preamble, "units": self.units,
                       "group": self.group}, f)
        os.replace(tmp, self.sidecar)

    def clear(self) -> None:
        try:
            os.remove(self.sidecar)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------

def merge_parts(out, part_paths: List[str], cleanup: bool = True) -> None:
    """Merge shard part files into ``out`` (binary file object).

    If every part has a ``.units`` sidecar the merge interleaves units by
    global ordinal (stream mode); otherwise parts are concatenated in
    shard order (load mode, contiguous strip ranges).  Byte-identical to
    the unsharded output in both cases.
    """
    indexes = [UnitIndex(p) for p in part_paths]
    if part_paths and all(ix.load() for ix in indexes):
        if len({ix.group for ix in indexes}) > 1:
            raise DistanceError(
                "cannot merge stream parts cut into groups of different"
                " sizes (" + ", ".join(
                    f"{p}: {ix.group}" for p, ix in zip(part_paths, indexes)
                ) + ")"
            )
        _merge_stream(out, part_paths, indexes)
    else:
        for p in part_paths:
            with open(p, "rb") as f:
                while True:
                    chunk = f.read(8 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
    if cleanup:
        for p, ix in zip(part_paths, indexes):
            try:
                os.remove(p)
            except OSError:
                pass
            ix.clear()


def _merge_stream(out, part_paths: List[str], indexes: List[UnitIndex]) -> None:
    handles = [open(p, "rb") for p in part_paths]
    try:
        # Preamble (header) comes from shard 0; other shards wrote none,
        # but skip whatever preamble they recorded for safety.
        out.write(handles[0].read(indexes[0].preamble))
        for k in range(1, len(handles)):
            handles[k].seek(indexes[k].preamble)
        # Each part's units are ascending in global ordinal; k-way merge.
        iters = [list(ix.units) for ix in indexes]
        pos = [0] * len(handles)
        remaining = sum(len(u) for u in iters)
        while remaining:
            best = None
            for k, units in enumerate(iters):
                if pos[k] < len(units):
                    if best is None or units[pos[k]][0] < iters[best][pos[best]][0]:
                        best = k
            _, nbytes = iters[best][pos[best]]
            pos[best] += 1
            remaining -= 1
            out.write(handles[best].read(nbytes))
    finally:
        for h in handles:
            h.close()


# ---------------------------------------------------------------------------
# --launch N: single-command local multi-process run
# ---------------------------------------------------------------------------

def _worker_argv(args, k: int, n: int, part_path: str) -> List[str]:
    """A shard worker's command line.  It always names ``--backend``, so
    a worker never falls back from the card its parent was asked for."""
    argv = [sys.executable, "-m", "distance_tpu_torch.cli"]
    for p in (args.input_pos_1, args.input_pos_2):
        if p:
            argv.append(p)
    if args.input:
        argv.append("-i")
        argv.extend(args.input)
    if args.stream is not None:
        argv.extend(["-s", args.stream])
    argv.extend(["-m", args.measure])
    argv.extend(["--shard", f"{k}/{n}"])
    argv.extend(["-o", part_path])
    if args.threads is not None:
        argv.extend(["-t", str(args.threads)])
    if args.batchsize != 1:
        argv.extend(["-b", str(args.batchsize)])
    argv.extend(["--backend", args.backend])
    if getattr(args, "resume", False):
        argv.append("--resume")
    return argv


def launch(args) -> int:
    """Run ``--launch N``: spawn N shard workers, merge, clean up.

    Returns the process exit code.  Workers inherit stdio for stderr;
    each writes ``<output>.partK`` (or a temp dir when printing to
    stdout).  Each is told its index (``CARD_SHARE_ENV``), so that worker
    k takes card k mod the card count and its share of that card's auto
    device budget.  Load-mode parts are appended
    to the final output as soon as their turn arrives (ReorderBuffer over
    shard indices), so the merge overlaps the stragglers.
    """
    n = args.launch
    if n < 1:
        raise DistanceError(f"--launch needs at least 1 process, got {n}")
    _check_no_stdin(args, "--launch")

    import tempfile

    from distance_tpu_torch.writer import ReorderBuffer

    if args.output is not None:
        part_dir = None
        part_paths = [f"{args.output}.part{k}" for k in range(n)]
        out = open(args.output, "wb")
    else:
        part_dir = tempfile.mkdtemp(prefix="distance_tpu_parts_")
        part_paths = [os.path.join(part_dir, f"part{k}") for k in range(n)]
        out = sys.stdout.buffer

    # stale sidecars from an earlier (e.g. failed stream-mode) run at
    # the same -o path would make merge_parts misread a fresh load-mode
    # part by the OLD unit byte ranges — clear them before spawning
    for p in part_paths:
        for stale in (p, p + ".units"):
            try:
                os.remove(stale)
            except OSError:
                pass

    procs = [
        subprocess.Popen(_worker_argv(args, k, n, part_paths[k]),
                         env=dict(os.environ, **{CARD_SHARE_ENV: f"{k}/{n}"}))
        for k in range(n)
    ]

    stream_mode = args.stream is not None
    failed: List[int] = []

    def emit(k: int) -> None:
        # Stream parts need every part's unit index before interleaving;
        # load parts are contiguous and append immediately.
        if not stream_mode:
            merge_parts(out, [part_paths[k]])

    reorder = ReorderBuffer(emit)
    done = [False] * n
    while not all(done):
        for k, p in enumerate(procs):
            if done[k]:
                continue
            rc = p.poll()
            if rc is None:
                continue
            done[k] = True
            if rc != 0:
                failed.append(k)
            elif not failed:
                reorder.add(k, k)
        if failed:
            break  # don't wait hours for stragglers a failure voids
        time.sleep(0.02)

    if failed:
        for p in procs:  # stop stragglers; exact PIDs we spawned
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait()
        if args.output is not None:
            out.close()
            try:  # no partial merged output on failure
                os.remove(args.output)
            except OSError:
                pass
        # no stale parts/sidecars either: a later run at the same -o
        # must not see this run's leftovers (they corrupt merges)
        for pp in part_paths:
            for stale in (pp, pp + ".units"):
                try:
                    os.remove(stale)
                except OSError:
                    pass
        if part_dir is not None:
            try:
                os.rmdir(part_dir)
            except OSError:
                pass
        raise DistanceError(
            f"--launch worker shard(s) {sorted(failed)} failed"
        )
    if stream_mode:
        merge_parts(out, part_paths)
    out.flush()
    if args.output is not None:
        out.close()
    if part_dir is not None:
        try:
            os.rmdir(part_dir)
        except OSError:
            pass
    return 0


def _check_no_stdin(args, what: str) -> None:
    uses_stdin = not (args.input or args.input_pos_1 or args.input_pos_2)
    if uses_stdin or args.stream == "-":
        raise DistanceError(
            f"{what} requires file inputs (stdin cannot be shared"
            " across worker processes)"
        )


# ---------------------------------------------------------------------------
# Multi-host (--num-hosts/--host-id/--coordinator) orchestration
# ---------------------------------------------------------------------------

@dataclass
class MultihostCtx:
    """State carried from startup to the post-run merge."""

    host_id: int
    num_hosts: int
    final_output: Optional[str]  # None = stdout on host 0
    part_paths: List[str]
    used_coordinator: bool = False
    # shared-config fingerprint stamped into .done markers: a marker
    # from an earlier run with a different config is treated as absent
    # instead of merged (stale-marker corruption guard)
    fp: str = ""


MERGE_POLL_S = 0.05
MERGE_TIMEOUT_S = float(os.environ.get("DISTANCE_TPU_MERGE_TIMEOUT", 0))
# progress note cadence while host 0 waits for peer markers (a peer
# killed hard never writes one; the wait must be visible, not silent)
MERGE_NOTE_S = 30.0


def _run_fingerprint(args, num_hosts: int) -> str:
    """Config fingerprint shared by every host of one logical run.

    Built only from inputs all hosts agree on via the shared filesystem
    (measure, host count, input basenames + sizes — NOT mtimes, which
    some shared filesystems skew): a .done marker stamped with a
    different fingerprint belongs to some earlier run and is ignored.
    """
    import hashlib

    paths = []
    for p in (getattr(args, "input", None) or []):
        paths.append(p)
    for p in (getattr(args, "input_pos_1", None),
              getattr(args, "input_pos_2", None),
              getattr(args, "stream", None)):
        if p is not None:
            paths.append(p)
    h = hashlib.sha256()
    h.update(f"{num_hosts}|{getattr(args, 'measure', '')}".encode())
    for p in paths:
        if p == "-":
            continue
        try:
            size = os.stat(p).st_size
        except OSError:
            size = -1
        h.update(f"|{os.path.basename(str(p))}:{size}".encode())
    return h.hexdigest()[:16]


def _env_index(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def _rendezvous(coordinator: str, num_hosts: int,
                host_id: int) -> Tuple[int, int]:
    """Join the gloo process group of ``num_hosts`` hosts at
    ``coordinator`` (host:port; host 0 serves it) as ``host_id``, within
    RENDEZVOUS_TIMEOUT_S -> (world size, rank)."""
    import datetime

    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_hosts, rank=host_id,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S),
        )
    except (RuntimeError, ValueError) as e:
        raise DistanceError(
            f"rendezvous of {num_hosts} hosts at {coordinator} failed: {e}"
        ) from None
    return dist.get_world_size(), dist.get_rank()


def resolve_multihost(args) -> Optional[MultihostCtx]:
    """Derive this process's shard from the multi-host flags, if any.

    Mutates ``args`` so the engine runs the local shard into a part
    file.  Three startup paths:

    * ``--coordinator ADDR``: a ``torch.distributed`` rendezvous (gloo)
      of the hosts; ``--num-hosts``/``--host-id`` default to the
      ``WORLD_SIZE``/``RANK`` that torchrun sets, and the process
      index/count come from the initialized process group.
    * ``--num-hosts N --host-id K`` alone: explicit shared-filesystem
      mode, no runtime rendezvous needed.
    * neither: returns None (single-host run).

    Every check runs before the rendezvous, so a bad command line fails
    at once instead of after its peers arrive.
    """
    num_hosts = getattr(args, "num_hosts", None)
    host_id = getattr(args, "host_id", None)
    coordinator = getattr(args, "coordinator", None)
    if coordinator is None and num_hosts is None and host_id is None:
        return None
    if coordinator is not None:
        if num_hosts is None:
            num_hosts = _env_index("WORLD_SIZE")
        if host_id is None:
            host_id = _env_index("RANK")
    if num_hosts is None or host_id is None:
        raise DistanceError(
            "--num-hosts and --host-id must be given together"
            " (or derived via --coordinator)"
        )
    if not (0 <= host_id < num_hosts):
        raise DistanceError(
            f"--host-id {host_id} out of range for --num-hosts {num_hosts}"
        )
    if getattr(args, "shard", None):
        raise DistanceError(
            "--shard conflicts with multi-host flags (the shard is"
            " derived from the host id)"
        )
    _check_no_stdin(args, "multi-host mode")
    if args.output is None and host_id != 0:
        # stdout only exists on host 0; other hosts still need a part
        raise DistanceError(
            "multi-host runs without -o/--output must merge on host 0;"
            " give every host the same -o path on a shared filesystem"
        )
    used_coordinator = coordinator is not None
    if used_coordinator:
        num_hosts, host_id = _rendezvous(coordinator, num_hosts, host_id)

    final_output = args.output
    base = final_output if final_output is not None else "distance_out"
    part_paths = [f"{base}.part{k}" for k in range(num_hosts)]
    args.shard = f"{host_id}/{num_hosts}"
    args.output = part_paths[host_id]
    # clear THIS host's leftovers from any earlier run at the same
    # path: a stale .done marker would let host 0 merge this host's
    # part while it is still being written, and a stale .units sidecar
    # would index the new part by old byte ranges
    mine = part_paths[host_id]
    for stale in (mine + ".done", mine + ".units"):
        try:
            os.remove(stale)
        except OSError:
            pass
    return MultihostCtx(
        host_id=host_id,
        num_hosts=num_hosts,
        final_output=final_output,
        part_paths=part_paths,
        used_coordinator=used_coordinator,
        fp=_run_fingerprint(args, num_hosts),
    )


def _distributed_shutdown() -> None:
    """The exit barrier of a --coordinator run, then leave the group.  A
    peer already gone (or a barrier that outwaits the group's timeout)
    only shortens the handshake: the .done markers order the merge."""
    import torch.distributed as dist

    try:
        dist.barrier()
    except RuntimeError:
        pass
    dist.destroy_process_group()


def finish_multihost(ctx: MultihostCtx, ok: bool, err: str = "") -> None:
    """Post-run: publish this host's done marker; host 0 merges.

    The data barrier is the shared filesystem (markers) so it works with
    or without a torch.distributed rendezvous; a marker is written on
    failure too, and the merge aborts if any marker reports one.  In
    coordinator mode every host additionally joins the group's exit
    barrier strictly AFTER writing its marker (and host 0 after its
    merge), so the exit sequence can never deadlock on a marker.
    """
    marker = ctx.part_paths[ctx.host_id] + ".done"
    with open(marker + ".tmp", "w") as f:
        f.write(f"{ctx.fp}\n" + ("ok" if ok else f"err {err}"))
    os.replace(marker + ".tmp", marker)

    error: Optional[DistanceError] = None
    if ctx.host_id == 0 and ok:
        try:
            _merge_when_ready(ctx)
        except DistanceError as e:
            error = e
    if ctx.used_coordinator:
        _distributed_shutdown()
    if error is not None:
        raise error


def _read_marker(path: str, fp: str) -> Optional[str]:
    """The marker's status line, or None if absent / from another run
    (fingerprint mismatch — a stale file must not gate the merge)."""
    try:
        with open(path) as f:
            content = f.read()
    except OSError:
        return None
    head, _, status = content.partition("\n")
    if head != fp:
        return None  # stale marker from a different configuration
    return status


def _merge_when_ready(ctx: MultihostCtx) -> None:
    markers = [p + ".done" for p in ctx.part_paths]
    t0 = time.monotonic()
    last_note = t0
    while True:
        statuses = [_read_marker(m, ctx.fp) for m in markers]
        if all(s is not None for s in statuses):
            break
        now = time.monotonic()
        if MERGE_TIMEOUT_S and now - t0 > MERGE_TIMEOUT_S:
            raise DistanceError(
                "timed out waiting for host part files"
                f" ({[m for m, s in zip(markers, statuses) if s is None]})"
            )
        if now - last_note >= MERGE_NOTE_S:
            last_note = now
            pending = [
                k for k, s in enumerate(statuses) if s is None
            ]
            print(
                f"[distance-tpu] host 0 waiting for host(s) {pending}"
                f" ({now - t0:.0f}s; a host killed without writing its"
                " .done marker waits forever — set"
                " DISTANCE_TPU_MERGE_TIMEOUT to bound this)",
                file=sys.stderr,
            )
        time.sleep(MERGE_POLL_S)
    errs = []
    for k, status in enumerate(statuses):
        if status != "ok":
            errs.append(f"host {k}: {status}")
    if errs:
        raise DistanceError("multi-host run failed: " + "; ".join(errs))

    out = (
        sys.stdout.buffer if ctx.final_output is None
        else open(ctx.final_output, "wb")
    )
    merge_parts(out, ctx.part_paths)
    out.flush()
    if ctx.final_output is not None:
        out.close()
    for m in markers:
        try:
            os.remove(m)
        except OSError:
            pass
