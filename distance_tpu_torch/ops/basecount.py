"""The tn93 base count on the device: each row's (A, T, G, C) tallies.

The port of ``distance_tpu/ops/pairwise_xla.py::base_counts_device``:
(m, L) uint8 codes -> (m, 4) int32, the counts of the codes A, T, G and
C in each row, in that order.  ``base_counts_cuda`` launches the
hand-written kernel of ``csrc/basecount.cu`` (K7); ``base_counts_torch``
is its plain version, the JAX function's expression.  ``base_counts``
takes the plain version for tensors on the CPU and the kernel for
tensors on a CUDA device (raising rather than falling back).  Rows may
lie at any stride (slices of a larger matrix); an empty width counts
zeros.
"""

from __future__ import annotations

import ctypes

import torch

from distance_tpu_torch.encoding import A, C, G, T
from distance_tpu_torch.ops import _build

# The codes counted, in the order of the output's columns.
BASES = (A, T, G, C)

# Launches made by base_counts_cuda (K7) in this process.
LAUNCHES = 0

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = _build.load("basecount")
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.dt_base_counts_launch.argtypes = [vp, ll, ll, ll, vp, vp]
        lib.dt_base_counts_launch.restype = ctypes.c_int
        _bound = lib
    return _bound


def _check_codes(codes: torch.Tensor) -> None:
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(
            f"codes must be 2-D uint8, got {tuple(codes.shape)} {codes.dtype}")


def base_counts_torch(codes: torch.Tensor) -> torch.Tensor:
    """Plain version: (m, L) uint8 codes -> (m, 4) int32 tallies of A, T,
    G and C, as the JAX function writes it."""
    _check_codes(codes)
    return torch.stack(
        [(codes == v).to(torch.int32).sum(1, dtype=torch.int32)
         for v in BASES], dim=1)


def base_counts_cuda(codes: torch.Tensor) -> torch.Tensor:
    """Launch K7 on the current stream of the codes' device: (m, L) uint8
    codes (rows at any stride, sites contiguous) -> (m, 4) int32; raises
    on anything it does not take."""
    global LAUNCHES
    _check_codes(codes)
    if codes.device.type != "cuda":
        raise ValueError(f"base_counts_cuda needs a CUDA tensor, got"
                         f" {codes.device}")
    m, width = codes.shape
    out = torch.empty((m, 4), dtype=torch.int32, device=codes.device)
    if m == 0:
        return out
    if width > 1 and codes.stride(1) != 1:
        raise ValueError("codes must have contiguous sites")
    ld = codes.stride(0) if m > 1 else width
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with torch.cuda.device(codes.device):
        rc = _lib().dt_base_counts_launch(codes.data_ptr(), m, width, ld,
                                          out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"base count kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def base_counts(codes: torch.Tensor) -> torch.Tensor:
    """(m, 4) int32 tallies of A, T, G and C: the plain version for CPU
    tensors, K7 for CUDA tensors."""
    if codes.device.type == "cpu":
        return base_counts_torch(codes)
    return base_counts_cuda(codes)
