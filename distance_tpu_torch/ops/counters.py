"""Pairwise counters of one measure: (m, L) x (n, L) uint8 -> (G, m, n) int32.

``counters_cuda`` launches the hand-written kernel of ``csrc/counters.cu``
(the port of ``distance_tpu/ops/pairwise_pallas.py::_kernel``, an int8
tensor-core GEMM); ``counters_torch`` is its plain PyTorch version, the
reference the kernel is held against.  ``counters`` takes the plain
version for tensors on the CPU and the kernel for tensors on a CUDA
device.  Every counter is an exact integer.  Codes are Paradis codes or
0 (padding), as ``encoding`` makes them: the kernel reads each code's
candidacy nibble only (``ops/plan.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from distance_tpu_torch.ops import _build
from distance_tpu_torch.ops.plan import KernelPlan

# Kernel launches made by counters_cuda in this process.
LAUNCHES = 0

# Rows one launch takes (csrc/counters.cu MAX_M, MAX_N): x row tiles of
# 128 go on the grid's x axis, y row tiles of 256 on its y axis (65535
# blocks).
MAX_X_ROWS = (1 << 31) - 1 - 128
MAX_Y_ROWS = 65535 * 256

# The kernel copies code rows in 16-byte pieces: row strides and widths
# are padded to a multiple of this many sites (code 0) before a launch.
SITE_ALIGN = 16

# Elements of one side's feature chunk in the plain version: bounds its
# (R, rows, sites) temporaries.
_PLAIN_CHUNK_ELEMS = 1 << 25

_bound = None


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(
            f"codes must be 2-D, got {tuple(x.shape)} and {tuple(y.shape)}"
        )
    if x.dtype != torch.uint8 or y.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, got {x.dtype} and {y.dtype}")
    if x.shape[1] != y.shape[1]:
        raise ValueError(
            f"alignment widths differ: {x.shape[1]} and {y.shape[1]}"
        )
    if y.device != x.device:
        raise ValueError(f"codes on {x.device} and {y.device}")


def features_torch(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """(m, L) uint8 codes -> (R, m, L) features in ``lut``'s dtype, by
    lookup in an (R, 256) feature table."""
    return lut[:, codes.long()]


def counters_torch(x: torch.Tensor, y: torch.Tensor,
                   plan: KernelPlan) -> torch.Tensor:
    """Plain version: gather features through the LUTs, then contract.

    On the CPU the contraction is int32, which torch computes exactly.
    On a CUDA device, which has no integer matmul, it is float64, exact
    because every partial sum is at most R x L < 2^53.
    """
    _check(x, y)
    dev = x.device
    exact = torch.int32 if dev.type == "cpu" else torch.float64
    m, width = x.shape
    n = y.shape[0]
    f_lut = plan.f_lut.to(device=dev, dtype=exact)
    g_lut = plan.g_lut.to(device=dev, dtype=exact)
    acc = torch.zeros((plan.counters, m, n), dtype=exact, device=dev)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, plan.channels * max(m, n)))
    for s0 in range(0, width, chunk):
        fx = features_torch(x[:, s0 : s0 + chunk], f_lut)  # (R, m, sites)
        gy = features_torch(y[:, s0 : s0 + chunk], g_lut)  # (R, n, sites)
        for g in range(plan.counters):
            lo, hi = plan.bounds[g], plan.bounds[g + 1]
            acc[g] += torch.einsum("rml,rnl->mn", fx[lo:hi], gy[lo:hi])
    den = torch.tensor(plan.den, dtype=torch.int64, device=dev)
    return (acc.to(torch.int64) // den[:, None, None]).to(torch.int32)


def nibble_words(plan: KernelPlan) -> list:
    """The kernel's feature tables: for each channel its x-side, then its
    y-side 16-entry nibble table as four little-endian uint32 words."""
    tabs = np.stack([plan.f_nib, plan.g_nib], axis=1)  # (R, 2, 16)
    return np.ascontiguousarray(tabs).view("<u4").ravel().tolist()


def _kernel_lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = _build.load("counters")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.dt_counters_launch.argtypes = [
            vp, vp, ll, ll, ll, ll, ll, i, vp, vp, vp, vp, vp,
        ]
        lib.dt_counters_launch.restype = ctypes.c_int
        _bound = lib
    return _bound


def _site_aligned(codes: torch.Tensor) -> torch.Tensor:
    """``codes``, or a copy with its sites zero-padded to a multiple of
    SITE_ALIGN when its row stride or address is not 16-byte aligned."""
    width = codes.shape[1]
    if width % SITE_ALIGN == 0 and codes.data_ptr() % SITE_ALIGN == 0:
        return codes
    out = torch.zeros((codes.shape[0], -(-width // SITE_ALIGN) * SITE_ALIGN),
                      dtype=codes.dtype, device=codes.device)
    out[:, :width] = codes
    return out


def counters_cuda(x: torch.Tensor, y: torch.Tensor,
                  plan: KernelPlan) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of the codes' device;
    raises on anything it does not take.  Codes whose width is not a
    multiple of SITE_ALIGN are first copied into padded rows."""
    global LAUNCHES
    _check(x, y)
    if x.shape[0] > MAX_X_ROWS or y.shape[0] > MAX_Y_ROWS:
        raise ValueError(
            f"counter kernel takes at most {MAX_X_ROWS} x rows and"
            f" {MAX_Y_ROWS} y rows a launch, got {x.shape[0]} and"
            f" {y.shape[0]}"
        )
    if x.device.type != "cuda":
        raise ValueError(f"counters_cuda needs CUDA tensors, got {x.device}")
    if plan.f_lut.device != x.device or plan.g_lut.device != x.device:
        raise ValueError(
            f"plan tables on {plan.f_lut.device}, codes on {x.device}"
        )
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("codes must be contiguous")
    m, n = x.shape[0], y.shape[0]
    out = torch.empty(
        (plan.counters, m, n), dtype=torch.int32, device=x.device
    )
    if m == 0 or n == 0:
        return out
    x, y = _site_aligned(x), _site_aligned(y)
    lib = _kernel_lib()
    g = plan.counters
    bounds = (ctypes.c_int * (g + 1))(*plan.bounds)
    den = (ctypes.c_int * g)(*plan.den)
    tables = (ctypes.c_uint32 * (8 * plan.channels))(*nibble_words(plan))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.dt_counters_launch(
            x.data_ptr(), y.data_ptr(), m, n, x.shape[1], x.stride(0),
            y.stride(0), g, ctypes.addressof(bounds), ctypes.addressof(den),
            ctypes.addressof(tables), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"counter kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def counters(x: torch.Tensor, y: torch.Tensor,
             plan: KernelPlan) -> torch.Tensor:
    """Counters of every (x, y) pair: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (it raises rather than falling back)."""
    if x.device.type == "cpu":
        return counters_torch(x, y, plan)
    return counters_cuda(x, y, plan)
