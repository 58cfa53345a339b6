"""The float32 distance estimate of a block of counters.

The port of the in-graph estimate of
``distance_tpu/parallel/mesh.py::sharded_step``: (G, m, n) int32
counters of one measure -> (m, n) float32, each counter row taken by name
from the measure's plan (``plan.counters``), every operation in the JAX
expression's order:

* n, n_high: diff;
* raw: p = diff / (same + diff); jc69: -0.75 log(1 - 4/3 p), the
  difference fused with its product as XLA compiles it;
* k80: -0.5 log((1 - 2p - q) sqrt(1 - 2q)), p and q the transitions and
  transversions over count_l = same + ts + tv;
* tn93: the count_d rate (kk - same) / kk (the estimate needs no base
  counts).

``estimate_cuda`` launches the hand-written kernel of
``csrc/estimate.cu`` (K8); ``estimate_torch`` is its plain version.
``estimate`` takes the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device (raising rather than falling back).
The exact float64 distances stay the host finalizer's (``finalize.py``):
this estimate is the dry run's, as in the JAX package.
"""

from __future__ import annotations

import ctypes

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

# Launches made by estimate_cuda (K8) in this process.
LAUNCHES = 0

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = _build.load("estimate")
        vp = ctypes.c_void_p
        lib.dt_estimate_launch.argtypes = [ctypes.c_int, vp, vp, vp,
                                           ctypes.c_longlong, vp, vp]
        lib.dt_estimate_launch.restype = ctypes.c_int
        _bound = lib
    return _bound


def _rows(counters: torch.Tensor, measure: str) -> dict:
    """The measure's counter rows by name (its plan's order)."""
    if measure not in FORMS:
        raise ValueError(f"unknown measure {measure!r}")
    names = get_plan(measure).counters
    if (counters.dim() != 3 or counters.dtype != torch.int32
            or counters.shape[0] != len(names)):
        raise ValueError(
            f"{measure} counters must be ({len(names)}, m, n) int32, got"
            f" {tuple(counters.shape)} {counters.dtype}")
    return {name: counters[k] for k, name in enumerate(names)}


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


def estimate_torch(counters: torch.Tensor, measure: str) -> torch.Tensor:
    """Plain version: (G, m, n) int32 counters -> (m, n) float32, as the
    JAX ``sharded_step`` writes it."""
    c = {name: row.to(torch.float32)
         for name, row in _rows(counters, measure).items()}
    if measure in ("n", "n_high"):
        return c["diff"]
    if measure in ("raw", "jc69"):
        p = c["diff"] / (c["same"] + c["diff"])
        if measure == "raw":
            return p
        return -0.75 * torch.log(_one_minus_four_thirds(p))
    if measure == "k80":
        count_l = c["same"] + c["ts"] + c["tv"]
        p = c["ts"] / count_l
        q = c["tv"] / count_l
        return -0.5 * torch.log(
            (1.0 - 2.0 * p - q) * torch.sqrt(1.0 - 2.0 * q))
    return (c["kk"] - c["same"]) / c["kk"]


def estimate_cuda(counters: torch.Tensor, measure: str) -> torch.Tensor:
    """Launch K8 on the current stream of the counters' device: (G, m, n)
    int32 counters -> (m, n) float32; raises on anything it does not
    take."""
    global LAUNCHES
    if counters.device.type != "cuda":
        raise ValueError(f"estimate_cuda needs a CUDA tensor, got"
                         f" {counters.device}")
    counters = counters.contiguous()
    rows = _rows(counters, measure)
    form, names = FORMS[measure]
    ptrs = [rows[name].data_ptr() for name in names]
    ptrs += [ptrs[0]] * (3 - len(ptrs))
    m, n = counters.shape[1:]
    out = torch.empty((m, n), dtype=torch.float32, device=counters.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(counters.device).cuda_stream
    with torch.cuda.device(counters.device):
        rc = _lib().dt_estimate_launch(form, *ptrs, m * n, out.data_ptr(),
                                       stream)
    if rc != 0:
        raise RuntimeError(f"estimate kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def estimate(counters: torch.Tensor, measure: str) -> torch.Tensor:
    """(m, n) float32 estimates of ``measure``: the plain version for CPU
    tensors, K8 for CUDA tensors."""
    if counters.device.type == "cpu":
        return estimate_torch(counters, measure)
    return estimate_cuda(counters, measure)
