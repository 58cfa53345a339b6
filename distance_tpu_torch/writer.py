"""Ordered TSV output with Rust-compatible formatting.

Reproduces the reference writer (reference/src/lib.rs:598-644):

* header ``sequence1\\tsequence2\\tdistance``;
* integer measures print bare integers, float measures fixed 12 decimals
  (``{:.12}``), with Rust spellings ``NaN`` / ``inf`` / ``-inf`` and a
  preserved ``-0.000000000000``;
* results may arrive as out-of-order blocks — a reorder buffer flushes
  them in block-index order so output is deterministic and independent of
  tiling/threading (the ``gather_write`` HashMap analog, lib.rs:612-638);
* a broken pipe on the output stream exits 0 silently (lib.rs:598-608).
"""

from __future__ import annotations

import ctypes
import io
import math
import sys
from typing import BinaryIO, Dict, List, Optional, Sequence

import numpy as np

from distance_tpu_torch._native import get_lib

HEADER = b"sequence1\tsequence2\tdistance\n"


def format_float(v: float) -> str:
    """Rust ``{:.12}`` formatting for one f64."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    return f"{v:.12f}"


class TsvWriter:
    """Streaming TSV writer over a binary file object."""

    def __init__(self, out: BinaryIO, on_broken_pipe=None):
        self._out = out
        self._wrote_header = False
        # Invoked before the silent exit-0 on a broken pipe — used by the
        # engine to drop a now-inconsistent resume sidecar.
        self._on_broken_pipe = on_broken_pipe
        # Recycled large scratch arrays (vidx, row bounds, rank table):
        # rows() runs serially per writer, and fresh multi-GB allocations
        # per block are expensive on lazily-faulted VM memory.
        self._scratch: Dict[str, np.ndarray] = {}
        # Per-side id-blob cache: square/rect sweeps pass the SAME id
        # lists to every strip's rows() call; re-encoding 10^5-10^6 ids
        # per block sits on the serial emitter path otherwise.  Keyed by
        # object identity with a strong reference held, so a dead list's
        # id() can never alias a new one.
        self._idblob: Dict[int, tuple] = {}

    def _scr(self, name: str, n: int, dtype) -> np.ndarray:
        arr = self._scratch.get(name)
        if arr is None or arr.shape[0] < n or arr.dtype != np.dtype(dtype):
            arr = np.empty(n, dtype=dtype)
            self._scratch[name] = arr
        return arr[:n]

    def _broken_pipe_exit(self) -> None:
        # reference/src/lib.rs:598-608
        if self._on_broken_pipe is not None:
            try:
                self._on_broken_pipe()
            except Exception:
                pass
        try:
            sys.stderr.close()
        except Exception:
            pass
        import os

        os._exit(0)

    def _write(self, data: bytes) -> None:
        from distance_tpu_torch.utils.timing import phase_timer

        try:
            with phase_timer("write:io"):
                self._out.write(data)
        except BrokenPipeError:
            self._broken_pipe_exit()

    def header(self) -> None:
        if not self._wrote_header:
            self._write(HEADER)
            self._wrote_header = True

    def suppress_header(self) -> None:
        """Skip the header line (non-zero shards of a multi-host run —
        concatenation keeps the single header from shard 0)."""
        self._wrote_header = True

    def rows(
        self,
        ids1: Sequence[str],
        ids2: Sequence[str],
        pair_i: np.ndarray,
        pair_j: np.ndarray,
        values,
        keys: Optional[np.ndarray] = None,
        keyspace: int = 0,
    ) -> None:
        """Emit rows (ids1[pair_i[r]], ids2[pair_j[r]], values[r]).

        ``keys``/``keyspace``: optional per-row integer keys that
        determine each row's value — enables sort-free memoized
        formatting (see _value_table).  ``values`` may be a CALLABLE
        ``values(first_rows)``: with the memo engaged it is called once
        with the representative row index per distinct key (finalize
        only those); called with None it must return the full per-row
        array (memo bypassed).

        Large keyed blocks going to a seekable regular file are
        formatted straight into an mmap of the file (single copy, chunks
        fault pages in parallel) — a buffered ``write`` of the assembled
        gigabyte was the measured tail bottleneck (250-400 MB/s vs
        >1 GB/s mapped)."""
        self.header()
        data = _format_rows(
            ids1, ids2, pair_i, pair_j, values, keys, keyspace,
            sink=self,
        )
        if data is not None:
            self._write(data)

    def _mmap_dest(self, total: int):
        """(buffer_addr, done_fn) window of ``total`` bytes appended to
        the underlying file, or None when the output is not a seekable
        regular file (pipes, BytesIO, stdout)."""
        import mmap as _mmap
        import os as _os

        out = self._out
        try:
            if not out.seekable():
                return None
            fd = out.fileno()
            self.flush()  # buffered bytes must land before the window
            pos = out.tell()
            if _os.fstat(fd).st_size != pos:
                # tell() is not the append position (e.g. an O_APPEND
                # fd from shell '>>' reports 0 over existing content) —
                # ftruncate here would destroy it; the buffered write
                # path appends correctly, so fall back to it
                return None
            _os.ftruncate(fd, pos + total)
            gran = _mmap.ALLOCATIONGRANULARITY
            delta = pos % gran
            # Outputs open write-only ("wb"); a writable mapping needs a
            # read-write fd — reopen the same file via /proc/self/fd
            # (same inode, works for unlinked files too).
            rw = _os.open(f"/proc/self/fd/{fd}", _os.O_RDWR)
            try:
                mm = _mmap.mmap(rw, total + delta, offset=pos - delta)
            finally:
                _os.close(rw)
        except (OSError, ValueError, AttributeError, io.UnsupportedOperation):
            return None
        base = ctypes.addressof(ctypes.c_char.from_buffer(mm)) + delta

        def done() -> None:
            mm.close()
            out.seek(pos + total)

        return base, done

    def flush(self) -> None:
        try:
            self._out.flush()
        except BrokenPipeError:
            self._broken_pipe_exit()

    def tell(self) -> int:
        return self._out.tell()

    def close(self) -> None:
        self.flush()
        if self._out not in (getattr(sys.stdout, "buffer", None),):
            self._out.close()


def _id_blob(ids: Sequence[str], sink: Optional["TsvWriter"] = None,
             slot: int = 0):
    """Concatenated utf-8 id bytes + offsets.

    With a ``sink``, the result memoizes per (slot, ids-object): the
    sweeps pass the same id list to every strip, so the encode + cumsum
    + join runs once per alignment instead of once per block.  The
    cached entry holds a strong reference to ``ids``, making the
    identity check sound (a freed list's id() cannot be reused while
    cached); callers must not mutate an id list between rows() calls.
    """
    if sink is not None:
        hit = sink._idblob.get(slot)
        if hit is not None and hit[0] is ids:
            return hit[1], hit[2]
    enc = [s.encode() for s in ids]
    offs = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    blob = b"".join(enc)
    if sink is not None:
        sink._idblob[slot] = (ids, blob, offs)
    return blob, offs


# Rows formatted per native call — bounds the worst-case scratch buffer
# (~360 B/row for extreme f64 values) to a few hundred MB.
_FORMAT_CHUNK_ROWS = 1 << 20
# Blocks at least this large try the unique-value table path, and native
# chunks run on a thread pool (the C emitters release the GIL).
_MEMO_MIN_ROWS = 1 << 16


def _format_pool():
    from distance_tpu_torch.finalize import _get_pool

    return _get_pool()


def _value_table(values, keys: np.ndarray, keyspace: int, lib=None,
                 sink: Optional["TsvWriter"] = None):
    """(vblob, voffs, vidx) from caller-supplied value keys.

    ``keys`` maps each row to an integer < ``keyspace`` that DETERMINES
    its value (the engine derives keys from the small per-pair counters,
    so equal keys imply bit-identical values — so any occurrence may
    represent its key).  Distances on real alignments repeat heavily, so
    each distinct key's value is finalized + formatted once and row
    emission becomes pure memcpy (dt_format_rows_pre).  A callable
    ``values`` is invoked only with the representative row indices — the
    per-pair f64 array is never materialized.

    Requires the native lib: the only caller (_format_rows) takes this
    path only when ``lib is not None`` (a numpy fallback here would be
    dead code that could drift from dt_key_rank unnoticed).
    """
    assert lib is not None
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    n = keys.shape[0]
    cap = min(n, keyspace)
    if sink is not None:
        rank = sink._scr("rank", keyspace, np.int32)
        rank.fill(-1)
        present = sink._scr("present", cap, np.int32)
        first_row = sink._scr("first_row", cap, np.int64)
        vidx = sink._scr("vidx", n, np.int32)
    else:
        rank = np.full(keyspace, -1, dtype=np.int32)
        present = np.empty(cap, dtype=np.int32)
        first_row = np.empty(cap, dtype=np.int64)
        vidx = np.empty(n, dtype=np.int32)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    n_present = lib.dt_key_rank(
        keys.ctypes.data_as(p_i32), n, rank.ctypes.data_as(p_i32),
        present.ctypes.data_as(p_i32),
        first_row.ctypes.data_as(p_i64), vidx.ctypes.data_as(p_i32),
    )
    if callable(values):
        reps = values(first_row[:n_present])
    else:
        reps = values[first_row[:n_present]]
    if reps.dtype == np.float64:
        strs = [format_float(v).encode() for v in reps]
    else:
        strs = [b"%d" % v for v in reps]
    voffs = np.zeros(len(strs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in strs], out=voffs[1:])
    return b"".join(strs), voffs, vidx


def _format_rows(
    ids1: Sequence[str],
    ids2: Sequence[str],
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    values,
    keys: Optional[np.ndarray] = None,
    keyspace: int = 0,
    sink: Optional["TsvWriter"] = None,
) -> Optional[bytes]:
    lib = get_lib()
    pair_i = np.ascontiguousarray(pair_i, dtype=np.int32)
    pair_j = np.ascontiguousarray(pair_j, dtype=np.int32)
    n = pair_i.shape[0]
    if callable(values) and not (
        lib is not None and keys is not None and n >= _MEMO_MIN_ROWS
    ):
        values = values(None)  # memo not engaged: full finalize
    if lib is not None and n:
        blob1, off1 = _id_blob(ids1, sink, 1)
        blob2, off2 = _id_blob(ids2, sink, 2)
        max_id = int((off1[1:] - off1[:-1]).max(initial=0)) + int(
            (off2[1:] - off2[:-1]).max(initial=0)
        )
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        id_args = [
            blob1, off1.ctypes.data_as(p_i64),
            blob2, off2.ctypes.data_as(p_i64),
        ]
        if keys is not None and n >= _MEMO_MIN_ROWS:
            from distance_tpu_torch.utils.timing import phase_timer

            with phase_timer("write:value_table"):
                table = _value_table(values, keys, keyspace, lib, sink)
            with phase_timer("write:assemble"):
                return _assemble_keyed(
                    lib, id_args, off1, off2, pair_i, pair_j, table, n,
                    sink=sink,
                )
        if values.dtype == np.float64:
            vals64 = np.ascontiguousarray(values)
        else:
            vals64 = np.ascontiguousarray(values, dtype=np.int64)

        def chunk(c0: int) -> Optional[bytes]:
            c1 = min(c0 + _FORMAT_CHUNK_ROWS, n)
            cn = c1 - c0
            pi = np.ascontiguousarray(pair_i[c0:c1])
            pj = np.ascontiguousarray(pair_j[c0:c1])
            args = id_args + [
                pi.ctypes.data_as(p_i32), pj.ctypes.data_as(p_i32),
            ]
            # typical rows are short; retry with the f64 worst case
            # (~360 chars) only if the tight buffer overflows
            for per_row in (64, 384):
                cap = cn * (max_id + per_row + 3) + 16
                buf = ctypes.create_string_buffer(cap)
                vs = vals64[c0:c1]
                if values.dtype == np.float64:
                    w = lib.dt_format_rows_f64(
                        *args,
                        vs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        cn, buf, cap,
                    )
                else:
                    w = lib.dt_format_rows_i64(
                        *args, vs.ctypes.data_as(p_i64), cn, buf, cap,
                    )
                if w >= 0:
                    return ctypes.string_at(buf, w)
            return None

        starts = list(range(0, n, _FORMAT_CHUNK_ROWS))
        if len(starts) > 1:
            out = list(_format_pool().map(chunk, starts))
        else:
            out = [chunk(starts[0])]
        if all(o is not None for o in out):
            return b"".join(out)
    # Python fallback
    parts: List[str] = []
    if values.dtype == np.float64:
        for r in range(n):
            parts.append(
                f"{ids1[pair_i[r]]}\t{ids2[pair_j[r]]}\t{format_float(values[r])}\n"
            )
    else:
        for r in range(n):
            parts.append(f"{ids1[pair_i[r]]}\t{ids2[pair_j[r]]}\t{int(values[r])}\n")
    return "".join(parts).encode()


def _assemble_keyed(lib, id_args, off1, off2, pair_i, pair_j, table, n,
                    sink=None):
    """Zero-copy emission for the keyed path: row lengths are known
    exactly up front (id lengths + value-string lengths), so chunks of
    dt_format_rows_pre write straight into one exact-size buffer in
    parallel — no zero-fill, no per-chunk copy, no final join.

    With a ``sink`` whose output is a seekable regular file, the buffer
    IS an mmap window appended to the file (TsvWriter._mmap_dest):
    formatting lands directly in the page cache and the separate
    gigabyte-scale ``write`` copy disappears.  Returns the bytes when no
    mapped window is available, else None (rows already in the file)."""
    vblob, voffs, vidx = table
    # int32 throughout: int64 fancy-gathers are an order of magnitude
    # slower on common hosts, and every length fits easily
    idl1 = (off1[1:] - off1[:-1]).astype(np.int32)
    idl2 = (off2[1:] - off2[:-1]).astype(np.int32)
    vlen = (voffs[1:] - voffs[:-1]).astype(np.int32)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    if sink is not None:
        bounds = sink._scr("bounds", n + 1, np.int64)
        bounds[0] = 0
    else:
        bounds = np.zeros(n + 1, dtype=np.int64)
    lib.dt_row_bounds(
        pair_i.ctypes.data_as(p_i32), pair_j.ctypes.data_as(p_i32),
        vidx.ctypes.data_as(p_i32), idl1.ctypes.data_as(p_i32),
        idl2.ctypes.data_as(p_i32), vlen.ctypes.data_as(p_i32),
        n, bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    total = int(bounds[-1])
    out = None
    done = None
    dest = sink._mmap_dest(total) if sink is not None else None
    if dest is not None:
        base, done = dest
    else:
        out = bytearray(total)
        base = ctypes.addressof((ctypes.c_char * 1).from_buffer(out))
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)

    def chunk(c0: int) -> bool:
        c1 = min(c0 + _FORMAT_CHUNK_ROWS, n)
        off = int(bounds[c0])
        cap = int(bounds[c1]) - off
        w = lib.dt_format_rows_pre(
            *id_args,
            pair_i[c0:c1].ctypes.data_as(p_i32),
            pair_j[c0:c1].ctypes.data_as(p_i32),
            vblob, voffs.ctypes.data_as(p_i64),
            vidx[c0:c1].ctypes.data_as(p_i32),
            c1 - c0, base + off, cap,
        )
        return w == cap

    starts = list(range(0, n, _FORMAT_CHUNK_ROWS))
    if len(starts) > 1:
        oks = list(_format_pool().map(chunk, starts))
    else:
        oks = [chunk(0)]
    assert all(oks), "keyed row assembly size mismatch"
    if done is not None:
        done()
        return None
    return out


class ReorderBuffer:
    """Flush out-of-order blocks in index order (gather_write analog)."""

    def __init__(self, emit) -> None:
        self._emit = emit
        self._pending: Dict[int, object] = {}
        self._counter = 0

    def add(self, idx: int, payload) -> None:
        self._pending[idx] = payload
        while self._counter in self._pending:
            self._emit(self._pending.pop(self._counter))
            self._counter += 1

    @property
    def outstanding(self) -> int:
        return len(self._pending)
