"""The float32 distance estimate of a block of counters.

The port of the in-graph tail of
``distance_tpu/parallel/mesh.py::sharded_step``: the ``psum`` over "sp"
of the site partials of (G, m, n) int32 counters of one measure, and the
(m, n) float32 estimate of their sum, each counter row taken by name from
the measure's plan (``plan.counters``), every operation in the JAX
expression's order:

* n, n_high: diff;
* raw: p = diff / (same + diff); jc69: -0.75 log(1 - 4/3 p), the
  difference fused with its product as XLA compiles it;
* k80: -0.5 log((1 - 2p - q) sqrt(1 - 2q)), p and q the transitions and
  transversions over count_l = same + ts + tv;
* tn93: the count_d rate (kk - same) / kk (the estimate needs no base
  counts).

``estimate_partials_cuda`` launches the hand-written kernel of
``csrc/estimate.cu`` (K8): it sums up to ``SP_MAX`` partials in int32 and
writes their estimate into a window of an output, one pass over each
partial; ``estimate_partials_torch`` is its plain version.
``estimate_cuda`` is its whole-block call (one partial, the whole
output), ``estimate_torch`` that call's plain version.  ``estimate`` and
``estimate_partials`` take the plain version for tensors on the CPU and
the kernel for tensors on a CUDA device (raising rather than falling
back).  A partial holds the measure's plan rows (G, m, cols), or, where
the form reads fewer rows than the plan has (tn93), just the rows it reads
in ``FORMS`` order (``form_rows``).  The exact float64 distances stay the
host finalizer's (``finalize.py``): this estimate is the dry run's, as in
the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from distance_tpu_torch.ops import _build
from distance_tpu_torch.ops.features import get_plan

# The kernel's form of each measure, and the counter rows it reads, in
# the order it takes them.
FORMS = {
    "n": (0, ("diff",)),
    "n_high": (0, ("diff",)),
    "raw": (1, ("diff", "same")),
    "jc69": (2, ("diff", "same")),
    "k80": (3, ("same", "ts", "tv")),
    "tn93": (4, ("kk", "same")),
}

# Partials a launch of K8 sums.
SP_MAX = 8

# Launches of K8 (by estimate_partials_cuda and estimate_cuda) in this
# process.
LAUNCHES = 0

_bound = None
# Each measure's (form, the plan's rows of the form's in its order, the
# plan's row count), kept at first use.
_LAYOUT: Dict[str, Tuple[int, Tuple[int, ...], int]] = {}


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = _build.load("estimate")
        vp = ctypes.c_void_p
        ll = ctypes.c_longlong
        lib.dt_estimate_partials_launch.argtypes = [
            ctypes.c_int, vp, ctypes.c_int, ll, ll, vp, ll, ll, vp]
        lib.dt_estimate_partials_launch.restype = ctypes.c_int
        _bound = lib
    return _bound


def _layout(measure: str) -> Tuple[int, Tuple[int, ...], int]:
    layout = _LAYOUT.get(measure)
    if layout is None:
        if measure not in FORMS:
            raise ValueError(f"unknown measure {measure!r}")
        form, names = FORMS[measure]
        counters = get_plan(measure).counters
        layout = _LAYOUT[measure] = (
            form, tuple(counters.index(name) for name in names),
            len(counters))
    return layout


def _row_index(part: torch.Tensor, measure: str) -> Tuple[int, ...]:
    """The indices in ``part`` of the rows the form reads: a (G, m, cols)
    int32 block of the plan's rows, or of the form's rows alone."""
    _, rows, g = _layout(measure)
    if part.dim() == 3 and part.dtype == torch.int32:
        if part.shape[0] == g:
            return rows
        if part.shape[0] == len(rows):
            return tuple(range(len(rows)))
    raise ValueError(
        f"{measure} counters must be ({g}, m, n) int32 (or ({len(rows)},"
        f" m, n), the form's rows), got {tuple(part.shape)} {part.dtype}")


def form_rows(counters: torch.Tensor, measure: str,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """The rows of (G, m, cols) counters that ``measure``'s form reads, in
    ``FORMS`` order, on ``device`` (the counters' own by default): the
    counters themselves where the form reads every row (the plan's order
    is the form's), else each row it reads copied straight there."""
    device = counters.device if device is None else device
    rows = _row_index(counters, measure)
    if rows == tuple(range(counters.shape[0])):
        return counters.to(device)
    out = torch.empty((len(rows), *counters.shape[1:]), dtype=torch.int32,
                      device=device)
    for k, row in enumerate(rows):
        out[k].copy_(counters[row])
    return out


def _check(partials: Sequence[torch.Tensor], measure: str,
           out: Optional[torch.Tensor], col0: int) -> tuple:
    """(m, cols, each partial's ``_row_index``); raises on what K8 does
    not take."""
    if not 1 <= len(partials) <= SP_MAX:
        raise ValueError(f"{len(partials)} partials: K8 sums 1 to {SP_MAX}")
    m, cols = partials[0].shape[1:] if partials[0].dim() == 3 else (-1, -1)
    rows = [_row_index(part, measure) for part in partials]
    for part in partials:
        if tuple(part.shape[1:]) != (m, cols):
            raise ValueError(f"partials of {tuple(part.shape[1:])} and"
                             f" {(m, cols)} cells")
        if part.device != partials[0].device:
            raise ValueError(f"partials on {part.device} and"
                             f" {partials[0].device}")
    if out is None:
        if col0:
            raise ValueError("a window (col0) needs an output")
        return m, cols, rows
    if (out.dtype != torch.float32 or out.dim() != 2 or out.shape[0] != m
            or not out.is_contiguous()):
        raise ValueError(f"the output must be a contiguous ({m}, ld)"
                         f" float32 matrix, got {tuple(out.shape)}"
                         f" {out.dtype}")
    if col0 < 0 or col0 + cols > out.shape[1]:
        raise ValueError(f"the window {col0}..{col0 + cols} is past ld"
                         f" {out.shape[1]}")
    if out.device != partials[0].device:
        raise ValueError(f"output on {out.device}, partials on"
                         f" {partials[0].device}")
    return m, cols, rows


# 4/3 as the float32 that JAX multiplies by.
FOUR_THIRDS = float(np.float32(4.0 / 3.0))


def _one_minus_four_thirds(p: torch.Tensor) -> torch.Tensor:
    """1 - 4/3 p of float32 p, rounded once, as compiled JAX computes it:
    XLA fuses the product and the difference into one multiply-add (at p
    = 0.75 it gives -2^-25, a NaN distance, where two roundings give 0,
    an infinite one).  The product of two float32 values is exact in
    float64, and so is the difference for p of 2^-5 or more; below, the
    float64 difference is rounded before the float32 one, which moves
    the result only where it lies within 2^-54 of a float32 midpoint."""
    return (1.0 - FOUR_THIRDS * p.double()).float()


def _estimate_rows(c, measure: str) -> torch.Tensor:
    """The estimate of float32 counter rows ``c``, in FORMS order."""
    if measure in ("n", "n_high"):
        return c[0]
    if measure in ("raw", "jc69"):
        diff, same = c
        p = diff / (same + diff)
        if measure == "raw":
            return p
        return -0.75 * torch.log(_one_minus_four_thirds(p))
    if measure == "k80":
        same, ts, tv = c
        count_l = same + ts + tv
        p = ts / count_l
        q = tv / count_l
        return -0.5 * torch.log(
            (1.0 - 2.0 * p - q) * torch.sqrt(1.0 - 2.0 * q))
    kk, same = c
    return (kk - same) / kk


def estimate_partials_torch(partials: Sequence[torch.Tensor], measure: str,
                            out: Optional[torch.Tensor] = None,
                            col0: int = 0) -> torch.Tensor:
    """Plain version: the estimate of the int32 sum of ``partials`` (each
    (G, m, cols), or the form's rows), as the JAX ``sharded_step`` writes
    it; into columns col0 .. col0 + cols of ``out`` ((m, ld) float32, the
    other cells left as they are) where given, else a new (m, cols)."""
    _, _, rows = _check(partials, measure, out, col0)
    total = None
    for part, index in zip(partials, rows):
        part = part[list(index)]
        total = part if total is None else total + part
    est = _estimate_rows(total.to(torch.float32), measure)
    if out is None:
        return est
    out[:, col0 : col0 + est.shape[1]] = est
    return out


def estimate_torch(counters: torch.Tensor, measure: str) -> torch.Tensor:
    """Plain version of the whole-block call: (G, m, n) int32 counters ->
    (m, n) float32, as the JAX ``sharded_step`` writes it."""
    return estimate_partials_torch([counters], measure)


def estimate_partials_cuda(partials: Sequence[torch.Tensor], measure: str,
                           out: Optional[torch.Tensor] = None,
                           col0: int = 0) -> torch.Tensor:
    """Launch K8 on the current stream of the partials' device: the
    estimate of the int32 sum of ``partials`` (1 to SP_MAX contiguous
    (G, m, cols) int32 blocks, or the form's rows, on one CUDA device)
    into columns col0 .. col0 + cols of ``out`` (a contiguous (m, ld)
    float32 matrix on that device; the other cells left as they are)
    where given, else into a new (m, cols); returns the output.  Raises on
    anything the kernel does not take."""
    global LAUNCHES
    if len(partials) and partials[0].device.type != "cuda":
        raise ValueError(f"estimate_partials_cuda needs CUDA tensors, got"
                         f" {partials[0].device}")
    m, cols, rows = _check(partials, measure, out, col0)
    device = partials[0].device
    form = _layout(measure)[0]
    ptrs = (ctypes.c_void_p * (3 * len(partials)))()
    step = 4 * m * cols
    for p, (part, index) in enumerate(zip(partials, rows)):
        if not part.is_contiguous():
            raise ValueError("partials must be contiguous")
        base = part.data_ptr()
        for j in range(3):
            ptrs[3 * p + j] = base + step * index[j if j < len(index) else 0]
    if out is None:
        out = torch.empty((m, cols), dtype=torch.float32, device=device)
    if out.numel() == 0 or cols == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (form, ptrs, len(partials), m, cols, out.data_ptr(),
            out.shape[1], col0, stream)
    if device.index is None or device.index == torch.cuda.current_device():
        rc = _lib().dt_estimate_partials_launch(*args)
    else:
        with torch.cuda.device(device):
            rc = _lib().dt_estimate_partials_launch(*args)
    if rc != 0:
        raise RuntimeError(f"estimate kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def estimate_cuda(counters: torch.Tensor, measure: str) -> torch.Tensor:
    """Launch K8 on the current stream of the counters' device: (G, m, n)
    int32 counters (a strided view is taken as its contiguous copy) ->
    (m, n) float32; raises on anything it does not take."""
    if counters.device.type != "cuda":
        raise ValueError(f"estimate_cuda needs a CUDA tensor, got"
                         f" {counters.device}")
    return estimate_partials_cuda([counters.contiguous()], measure)


def estimate_partials(partials: Sequence[torch.Tensor], measure: str,
                      out: Optional[torch.Tensor] = None,
                      col0: int = 0) -> torch.Tensor:
    """The estimate of the sum of ``partials`` (see
    ``estimate_partials_cuda``): the plain version for CPU tensors, K8 for
    CUDA tensors."""
    if len(partials) and partials[0].device.type == "cpu":
        return estimate_partials_torch(partials, measure, out, col0)
    return estimate_partials_cuda(partials, measure, out, col0)


def estimate(counters: torch.Tensor, measure: str) -> torch.Tensor:
    """(m, n) float32 estimates of ``measure``: the plain version for CPU
    tensors, K8 for CUDA tensors."""
    if counters.device.type == "cpu":
        return estimate_torch(counters, measure)
    return estimate_cuda(counters, measure)
