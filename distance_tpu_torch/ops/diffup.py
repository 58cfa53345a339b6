"""Diff-encoded host-to-device uploads.

Low-diversity alignments are overwhelmingly identical to a per-column
consensus: each record differs at a few dozen of ~30k sites.  So a code
matrix travels to the device as (linear index, code) pairs against a
reference row that lives there, and the device rebuilds the dense padded
matrix: ``diff_rebuild`` launches the hand-written kernel of
``csrc/diffup.cu`` (the port of ``distance_tpu/ops/diffup.py::_build_fn``)
for CUDA tensors and its plain PyTorch version ``diff_rebuild_torch`` for
CPU tensors.  The rebuilt matrix equals the dense upload except for PAD
ROWS, which hold the reference row instead of zeros: pad rows never
reach an emitted pair, and pad columns stay zero because the reference
row is zero-padded.  A batch too diverse for the encoding to win goes
dense, through pinned memory (``to_device``).

The host half (``mode_row``, ``sampled_mode_row``, the encoder of
``DiffUploader`` with its native passes ``dt_diff_count``/``dt_diff_fill``
and its two environment variables, and the pool helpers) is copied from
the JAX module; ``tests/test_torch_host_copies.py`` pins it.  Beside it
the port's own passes give the same results without a copy of the whole
matrix: ``pooled_mode_row`` (``sampled_mode_row``'s row, over column
ranges on the pool) and ``DiffUploader.encode_rows`` (``encode``'s
encoding of the zero-padded matrix, read from the unpadded rows).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from distance_tpu_torch.ops import _build


def _get_pool() -> ThreadPoolExecutor:
    from distance_tpu_torch.finalize import _get_pool as shared

    return shared()


def _row_chunks(n_rows: int, workers: int):
    per = max(256, -(-n_rows // (workers * 2)))
    return [(r0, min(n_rows, r0 + per)) for r0 in range(0, n_rows, per)]

# Pad flat diff lists to one of these capacities so the scatter builder
# compiles once per (shape, capacity) instead of once per batch.
_MIN_CAP = 4096

# Diff upload must shrink wire bytes by at least this factor to be worth
# the device-side rebuild.
_MIN_WIN = 3.0


def _round_cap(n: int) -> int:
    cap = _MIN_CAP
    while cap < n:
        cap *= 2
    return cap


# Kernel launches made by diff_rebuild_cuda in this process.
LAUNCHES = 0

_bound = None


def sampled_mode_row(matrix: np.ndarray, cap: int = 4096) -> np.ndarray:
    """mode_row over an evenly-strided sample of at most ``cap`` rows —
    the shared recipe for picking diff/rel reference rows cheaply."""
    step = max(1, matrix.shape[0] // cap)
    return mode_row(np.ascontiguousarray(matrix[::step][:cap]))


def pooled_mode_row(matrix: np.ndarray, cap: int = 4096) -> np.ndarray:
    """``sampled_mode_row(matrix, cap)``, computed from the strided sample
    in place (no contiguous copy) by ``mode_row`` over column ranges on
    the pool: the mode of a column depends on that column alone."""
    step = max(1, matrix.shape[0] // cap)
    sample = matrix[::step][:cap]
    rows, width = sample.shape
    pool = _get_pool()
    # a range a worker, of at least 2 MiB of codes
    per = max(-(-width // pool._max_workers), (1 << 21) // max(1, rows))
    if width <= per:
        return mode_row(sample)
    spans = range(0, width, per)
    return np.concatenate(list(pool.map(
        lambda c0: mode_row(sample[:, c0 : c0 + per]), spans)))


def mode_row(matrix: np.ndarray) -> np.ndarray:
    """Per-column modal code over the matrix — the reference row that
    minimizes expected diffs for records sharing its ancestry.

    The JAX package's result (among equal counts the code first in
    ALL_CODES; codes outside it count nowhere), found faster: a column
    whose first-row code (of ALL_CODES) holds a strict majority is
    settled by that one comparison, and only the others are counted code
    by code, as the JAX function counts every column."""
    from distance_tpu_torch.encoding import ALL_CODES

    if matrix.shape[0] == 0:
        return np.zeros(matrix.shape[1], dtype=np.uint8)
    first = matrix[0]
    agree = np.add.reduce((matrix == first).view(np.uint8), axis=0,
                          dtype=np.int64)
    settled = (2 * agree > matrix.shape[0]) & np.isin(first, ALL_CODES)
    best = np.where(settled, first, ALL_CODES[0]).astype(np.uint8)
    rest = np.flatnonzero(~settled)
    if not rest.size:
        return best
    sub = matrix[:, rest]
    best_count = None
    sub_best = np.full(rest.size, ALL_CODES[0], dtype=np.uint8)
    for code in ALL_CODES:
        count = (sub == code).sum(axis=0)
        if best_count is None:
            best_count = count.copy()
        else:
            better = count > best_count
            sub_best[better] = code
            np.maximum(best_count, count, out=best_count)
    best[rest] = sub_best
    return best


def to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """``host`` on ``device``.  To a card it is copied into pinned memory
    and from there asynchronously on the current stream (torch's pinned
    allocator keeps the staging buffer until the copy is done); on the
    CPU the tensor shares the array's memory."""
    t = torch.from_numpy(host)
    if device.type != "cuda":
        return t
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return staged.to(device, non_blocking=True)


def diff_rebuild_torch(ref: torch.Tensor, idx: torch.Tensor,
                       vals: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain version of the rebuild: (rows, l_pad) uint8, the reference row
    (l_pad,) in every row, then ``vals`` at the flat indices ``idx`` that
    fall inside the matrix (the capacity tail past it is dropped)."""
    l_pad = ref.shape[0]
    out = ref.expand(rows, l_pad).clone()
    keep = (idx >= 0) & (idx < rows * l_pad)
    out.view(-1).index_put_((idx[keep].long(),), vals[keep])
    return out


def _kernel_lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = _build.load("diffup")
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.dt_diff_rebuild_launch.argtypes = [vp, vp, vp, ll, ll, ll, vp, vp]
        lib.dt_diff_rebuild_launch.restype = ctypes.c_int
        _bound = lib
    return _bound


def diff_rebuild_cuda(ref: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor, rows: int) -> torch.Tensor:
    """Launch the rebuild kernel (one launch a call, none for an empty
    matrix) on the current stream of the reference's device; raises on
    anything it does not take.  As the JAX scatter assumes, ``idx`` must be
    sorted and unique (the encoder's are): the kernel walks it in order."""
    global LAUNCHES
    if ref.device.type != "cuda":
        raise ValueError(f"the rebuild kernel needs CUDA tensors, got"
                         f" {ref.device}")
    if (ref.dtype != torch.uint8 or vals.dtype != torch.uint8
            or idx.dtype != torch.int32):
        raise ValueError(f"expected uint8 ref and vals and int32 idx, got"
                         f" {ref.dtype}, {vals.dtype}, {idx.dtype}")
    if ref.dim() != 1 or idx.shape != vals.shape or idx.dim() != 1:
        raise ValueError(f"expected ref (l_pad,), idx and vals (cap,), got"
                         f" {tuple(ref.shape)}, {tuple(idx.shape)},"
                         f" {tuple(vals.shape)}")
    if idx.device != ref.device or vals.device != ref.device:
        raise ValueError(f"tensors on {ref.device}, {idx.device} and"
                         f" {vals.device}")
    l_pad = ref.shape[0]
    if l_pad % 16:
        raise ValueError(f"the rebuild writes 16-byte words: l_pad {l_pad}")
    ref, idx, vals = ref.contiguous(), idx.contiguous(), vals.contiguous()
    if ref.data_ptr() % 16:
        ref = ref.clone()
    out = torch.empty((rows, l_pad), dtype=torch.uint8, device=ref.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    with torch.cuda.device(ref.device):
        rc = _kernel_lib().dt_diff_rebuild_launch(
            ref.data_ptr(), idx.data_ptr(), vals.data_ptr(), idx.shape[0],
            rows, l_pad, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"diff rebuild kernel launch failed: CUDA error"
                           f" {rc}")
    LAUNCHES += 1
    return out


def diff_rebuild(ref: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """The rebuilt (rows, l_pad) matrix: the plain version for CPU
    tensors, the kernel for CUDA tensors (it raises rather than falling
    back)."""
    if ref.device.type == "cpu":
        return diff_rebuild_torch(ref, idx, vals, rows)
    return diff_rebuild_cuda(ref, idx, vals, rows)


class DiffUploader:
    """Upload padded row batches against a fixed padded reference row,
    to one torch device."""

    def __init__(self, ref_padded: np.ndarray, device: torch.device):
        self.l_pad = int(ref_padded.shape[0])
        self.ref = np.ascontiguousarray(ref_padded, dtype=np.uint8)
        self.device = device
        self._ref_dev = None
        disable = os.environ.get("DISTANCE_TPU_NO_DIFF_UPLOAD")
        force = os.environ.get("DISTANCE_TPU_DIFF_UPLOAD") == "force"
        self._min_win = 0.0 if force else (np.inf if disable else _MIN_WIN)

    def ref_dev(self) -> torch.Tensor:
        """The reference row as a device tensor (uploaded once)."""
        if self._ref_dev is None:
            self._ref_dev = to_device(self.ref, self.device)
        return self._ref_dev

    def encode(self, padded: np.ndarray, n_real: Optional[int] = None):
        """(idx, vals) capacity-padded diff arrays for ``padded``, or
        None when the batch is too diverse for the encoding to win.

        ``idx`` is sorted/unique int32 linear indices with a strictly
        increasing out-of-bounds tail (dropped by the device scatter).
        ``n_real`` (the number of real, non-pad rows) skips the pad-row
        scan when the caller already knows it.
        """
        rows_pad, l_pad = padded.shape
        assert l_pad == self.l_pad, (l_pad, self.l_pad)
        # pad rows are all-zero in `padded` but become `ref` on device;
        # diff only the real (non-pad) prefix — trailing all-zero rows
        # are indistinguishable from pad rows here, and a legitimately
        # all-invalid record encodes as width diffs anyway, never as an
        # accidental pad row (code 0 never equals a nonzero ref entry).
        # Rows of pure padding contribute ref-row diffs vs zero; exclude
        # them by construction: find the last row with any nonzero byte.
        if n_real is None:
            nz_rows = np.flatnonzero(padded.any(axis=1))
            n_real = int(nz_rows[-1]) + 1 if nz_rows.size else 0
        dense_bytes = padded.nbytes
        step = 64
        if n_real > 2 * step:
            # sampled pre-check: when even a 2x-optimistic estimate of
            # the diff volume loses, skip the full-matrix compare
            srows = padded[:n_real:step]
            sdiff = int(np.count_nonzero(srows != self.ref[None, :]))
            est = sdiff * (n_real / srows.shape[0])
            if est * 5 * self._min_win > 2 * dense_bytes:
                return None
        from distance_tpu_torch._native import get_lib

        lib = get_lib()
        if (
            lib is not None
            and n_real >= 512
            and padded.flags.c_contiguous
        ):
            return self._encode_native(
                lib, padded, n_real, rows_pad, l_pad, dense_bytes
            )
        neq = padded[:n_real] != self.ref[None, :]
        # Decide from the cheap COUNT before materializing indices: on a
        # diverse batch flatnonzero would allocate and fill hundreds of
        # MB of indices (measured ~22 s per 8k x 30k group) only to be
        # thrown away by this very test.
        n_diff = int(np.count_nonzero(neq))
        if self._rejects(n_diff, rows_pad, l_pad, dense_bytes):
            return None
        flat = np.flatnonzero(neq.reshape(-1)).astype(np.int32)
        vals = padded.reshape(-1)[flat]
        return self._with_tail(flat, vals, int(flat.size), rows_pad, l_pad)

    def _rejects(
        self, n_diff: int, rows_pad: int, l_pad: int, dense_bytes: int
    ) -> bool:
        diff_bytes = n_diff * 5 + self.l_pad
        return diff_bytes * self._min_win > dense_bytes or (
            # int32 linear indices (incl. the OOB pad tail) must not wrap
            rows_pad * l_pad + _round_cap(n_diff) >= 1 << 31
        )

    @staticmethod
    def _with_tail(idx_part, val_part, n_diff, rows_pad, l_pad):
        """Capacity-pad (idx, vals) with a strictly-increasing
        out-of-bounds index tail (dropped by the device scatter) so the
        whole index vector stays sorted and unique."""
        cap = _round_cap(n_diff)
        idx = np.empty(cap, dtype=np.int32)
        idx[:n_diff] = idx_part[:n_diff]
        idx[n_diff:] = np.arange(
            rows_pad * l_pad, rows_pad * l_pad + (cap - n_diff),
            dtype=np.int64,
        ).astype(np.int32)
        v = np.zeros(cap, dtype=np.uint8)
        v[:n_diff] = val_part[:n_diff]
        return idx, v

    def _encode_native(
        self, lib, padded, n_real, rows_pad, l_pad, dense_bytes
    ):
        """Two GIL-released C passes (count, then extract), each chunked
        over rows across the module pool — measured ~10x the numpy
        compare+flatnonzero path on winning groups, off the dispatcher
        thread's critical path."""
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        ref_p = self.ref.ctypes.data_as(p_u8)
        pool = _get_pool()
        chunks = _row_chunks(n_real, pool._max_workers)

        def count(span):
            r0, r1 = span
            return lib.dt_diff_count(
                padded[r0:r1].ctypes.data_as(p_u8), ref_p, r1 - r0, l_pad
            )

        counts = list(pool.map(count, chunks)) if len(chunks) > 1 else [
            count(chunks[0])
        ]
        n_diff = int(sum(counts))
        if self._rejects(n_diff, rows_pad, l_pad, dense_bytes):
            return None
        cap = _round_cap(n_diff)
        idx = np.empty(cap, dtype=np.int32)
        vals = np.zeros(cap, dtype=np.uint8)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

        def fill(k):
            r0, r1 = chunks[k]
            o = int(offs[k])
            w = lib.dt_diff_fill(
                padded[r0:r1].ctypes.data_as(p_u8), ref_p, r1 - r0, l_pad,
                r0 * l_pad,
                idx[o:].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                vals[o:].ctypes.data_as(p_u8),
            )
            assert w == counts[k], (w, counts[k])

        if len(chunks) > 1:
            list(pool.map(fill, range(len(chunks))))
        else:
            fill(0)
        idx[n_diff:] = np.arange(
            rows_pad * l_pad, rows_pad * l_pad + (cap - n_diff),
            dtype=np.int64,
        ).astype(np.int32)
        return idx, vals

    def in_place(self, matrix: np.ndarray) -> bool:
        """Whether ``encode_rows`` takes ``matrix``: ``encode`` would take
        its native path for it, its uint8 rows lie at stride ``width``,
        and the reference row holds 0 past ``width``."""
        from distance_tpu_torch._native import get_lib

        n, width = matrix.shape
        return (get_lib() is not None and n >= 512 and width > 0
                and matrix.dtype == np.uint8 and matrix.flags.c_contiguous
                and not self.ref[width:].any())

    def encode_rows(self, matrix: np.ndarray, rows_pad: int):
        """``encode(padded, n_real=n)``, where ``padded`` is the (n, width)
        ``matrix`` zero-padded to (rows_pad, l_pad), read from ``matrix``
        where it lies (``in_place`` must hold).  The padding adds no diff:
        its columns hold 0 there and in the reference row, and its rows
        lie past ``n_real``.  So ``encode``'s sampled pre-check and
        ``_encode_native`` run over the unpadded rows (stride ``width``),
        weighed against the padded dense bytes, and the indices then move
        to the padded layout, ``i + (i // width) * (l_pad - width)``, with
        the tail past ``rows_pad * l_pad``: the same (idx, vals), or None
        where ``encode`` gives None."""
        from distance_tpu_torch._native import get_lib

        n, width = matrix.shape
        l_pad = self.l_pad
        dense_bytes = rows_pad * l_pad
        # encode's sampled pre-check (n >= 512 > 2 * 64 here)
        srows = matrix[:n:64]
        sdiff = int(np.count_nonzero(srows != self.ref[None, :width]))
        est = sdiff * (n / srows.shape[0])
        if est * 5 * self._min_win > 2 * dense_bytes:
            return None
        enc = self._encode_native(get_lib(), matrix, n, rows_pad, width,
                                  dense_bytes)
        if enc is None:
            return None
        idx, vals = enc
        # the real indices lie below the tail's start, rows_pad * width
        n_diff = int(np.searchsorted(idx, rows_pad * width))
        # encode's int32 guard, at the padded width
        if rows_pad * l_pad + _round_cap(n_diff) >= 1 << 31:
            return None
        if l_pad != width:
            part = idx[:n_diff]
            part += (part // width) * (l_pad - width)
        idx[n_diff:] = np.arange(
            rows_pad * l_pad, rows_pad * l_pad + (idx.size - n_diff),
            dtype=np.int64,
        ).astype(np.int32)
        return idx, vals

    def upload(self, padded: np.ndarray) -> torch.Tensor:
        """Device (rows_pad, l_pad) uint8 tensor; diff-encoded when the
        batch is low-diversity, else dense through pinned memory."""
        enc = self.encode(padded)
        if enc is None:
            return to_device(padded, self.device)
        return self.upload_encoded(enc, padded.shape[0])

    def upload_encoded(self, enc, rows_pad: int) -> torch.Tensor:
        """Device rebuild from an already-computed (idx, vals) encoding:
        the diffs go to the device through pinned memory, and the rebuild
        runs there."""
        idx, v = enc
        return diff_rebuild(self.ref_dev(), to_device(idx, self.device),
                            to_device(v, self.device), rows_pad)
