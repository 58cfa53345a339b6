"""Keyed rows into a writer's output, chunk by chunk.

``writer._format_rows`` hands its keyed path here whenever a
``TsvWriter`` is the sink.  Every row's byte size is known before any row
is formatted (``dt_row_bounds``), so each chunk of
``writer._FORMAT_CHUNK_ROWS`` rows has an exact size up front.

* A seekable regular file takes the mmap window of
  ``TsvWriter._mmap_dest``, as ``writer._assemble_keyed`` does: the pool
  formats every chunk in place, and there is no write to overlap.
* Any other output (a pipe, a FIFO, stdout, an in-memory file) gets the
  chunks through a ring of at most ``RING_CHUNKS`` recycled buffers: the
  shared pool formats chunks ahead while the calling thread (the
  emitter) writes the oldest, in order.  A strip then costs the larger of
  its formatting and its write, not their sum, and no strip-sized buffer
  is allocated.

The rows are ``dt_format_rows_pre``'s, byte for byte, in the same order.
If a chunk fails, nothing more is written: the chunks in flight are
waited for, none of them is written, and the error re-raises.

Phases: ``write:assemble`` is the calling thread's own assembly (the row
bounds, the ring's set-up, the waits for chunks not yet formatted);
``write:io`` is each chunk's write, beside it, never inside it.  Once a
strip, ``write:format-ahead`` adds (``timing.add``, no span) the pool's
seconds formatting the ring's chunks, with their number as its count.
"""

from __future__ import annotations

import ctypes
import time
from collections import deque
from concurrent.futures import wait

import numpy as np

from distance_tpu_torch import writer
from distance_tpu_torch.utils import timing

# Chunks formatted ahead of the write, at most (and at most the pool's
# width): the main thread's own pool tasks (rel4 finish, gathers,
# finalize chunks) queue behind no more than these.
RING_CHUNKS = 4

_P_I32 = ctypes.POINTER(ctypes.c_int32)
_P_I64 = ctypes.POINTER(ctypes.c_int64)


def write_keyed(lib, id_args, off1, off2, pair_i, pair_j, table, n,
                sink) -> None:
    """Writes the rows ``writer._assemble_keyed`` assembles (same
    arguments, ``sink`` a ``TsvWriter``) to the sink's output."""
    vblob, voffs, vidx = table
    pool = writer._format_pool()
    step = writer._FORMAT_CHUNK_ROWS
    starts = list(range(0, n, step))

    def fmt(c0: int, dest: int):
        """Formats the chunk at row ``c0`` into ``dest``: (its size was
        exact, its seconds, its bytes)."""
        c1 = min(c0 + step, n)
        cap = int(bounds[c1] - bounds[c0])
        t0 = time.perf_counter()
        w = lib.dt_format_rows_pre(
            *id_args,
            pair_i[c0:c1].ctypes.data_as(_P_I32),
            pair_j[c0:c1].ctypes.data_as(_P_I32),
            vblob, voffs.ctypes.data_as(_P_I64),
            vidx[c0:c1].ctypes.data_as(_P_I32),
            c1 - c0, dest, cap,
        )
        return w == cap, time.perf_counter() - t0, cap

    with timing.phase_timer("write:assemble"):
        bounds = _row_bounds(lib, off1, off2, voffs, pair_i, pair_j, vidx,
                             n, sink)
        window = sink._mmap_dest(int(bounds[n]))
        if window is not None:
            base, done = window

            def mapped(c0: int) -> bool:
                return fmt(c0, base + int(bounds[c0]))[0]

            # every chunk ends before the window can close
            oks = list(pool.map(mapped, starts))
            if not all(oks):
                raise RuntimeError("keyed row assembly size mismatch")
            done()
            return
    _ring(pool, sink, fmt, starts, bounds, n)


def _row_bounds(lib, off1, off2, voffs, pair_i, pair_j, vidx, n, sink):
    """Each row's first byte, and the end (``n + 1`` int64, the sink's
    scratch), as ``writer._assemble_keyed`` computes them."""
    # int32 throughout: int64 fancy-gathers are an order of magnitude
    # slower on common hosts, and every length fits easily
    idl1 = (off1[1:] - off1[:-1]).astype(np.int32)
    idl2 = (off2[1:] - off2[:-1]).astype(np.int32)
    vlen = (voffs[1:] - voffs[:-1]).astype(np.int32)
    bounds = sink._scr("bounds", n + 1, np.int64)
    bounds[0] = 0
    lib.dt_row_bounds(
        pair_i.ctypes.data_as(_P_I32), pair_j.ctypes.data_as(_P_I32),
        vidx.ctypes.data_as(_P_I32), idl1.ctypes.data_as(_P_I32),
        idl2.ctypes.data_as(_P_I32), vlen.ctypes.data_as(_P_I32),
        n, bounds.ctypes.data_as(_P_I64),
    )
    return bounds


def _ring(pool, sink, fmt, starts, bounds, n) -> None:
    """Chunk ``c`` is formatted on the pool into buffer ``c % depth``, and
    written once every chunk before it is; its buffer then takes chunk
    ``c + depth``.  ``depth`` is ``RING_CHUNKS``, or less where the pool
    or the strip is smaller.  The buffers are the sink's scratch
    (``ring<k>``), kept for its later strips and grown only when a chunk
    outgrows them."""
    chunks = len(starts)
    with timing.phase_timer("write:assemble"):
        depth = min(RING_CHUNKS, pool._max_workers, chunks)
        ends = starts[1:] + [n]
        size = int((bounds[ends] - bounds[starts]).max())
        bufs = [sink._scr(f"ring{k}", size, np.uint8) for k in range(depth)]
        flight = deque(pool.submit(fmt, starts[c], bufs[c].ctypes.data)
                       for c in range(depth))
    seconds = 0.0
    try:
        for c in range(chunks):
            with timing.phase_timer("write:assemble"):
                ahead = c + depth - 1
                if c and ahead < chunks:
                    # into the buffer chunk c - 1 left, written by now
                    flight.append(pool.submit(
                        fmt, starts[ahead], bufs[ahead % depth].ctypes.data))
                ok, secs, nbytes = flight.popleft().result()
                if not ok:
                    raise RuntimeError("keyed row assembly size mismatch")
                seconds += secs
            sink._write(bufs[c % depth][:nbytes])
    except BaseException:
        # the chunks in flight still write into the ring: let them end,
        # and write none of them
        for f in flight:
            f.cancel()
        wait(flight)
        raise
    timing.add("write:format-ahead", seconds, chunks)
