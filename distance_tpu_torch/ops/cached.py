"""The cached-feature counter path: features built once, then contracted.

The port of the JAX package's default device path
(``distance_tpu/ops/features.py::features_device`` and
``distance_tpu/ops/pairwise_xla.py::contract_features``, joined in
``counters_xla``):

* ``features``: (m, L) uint8 codes -> (R, m, L) int8 features of one
  side, "f" (x, each channel's sign included) or "g" (y).  ``features_cuda``
  launches the hand-written kernel of ``csrc/features.cu`` (K5);
  ``features_torch`` is its plain version, a lookup in the plan's LUTs.
* ``contract``: (R, m, L) x (R, n, L) int8 features -> (G, m, n) int32
  counters under a ``CachedPlan`` (``ops/plan.py``): one product per
  counter over its channel slice, or for a shared plan one product per
  channel and the exact integer mix.  ``contract_cuda`` launches the
  kernels of ``csrc/contract.cu`` (K6: the int8 tensor-core product, and
  for a shared plan the mix); ``contract_torch`` is its plain version.
* ``counters_cached``: both sides' features, then the contraction.

Each dispatching function takes the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device (raising rather than falling
back).  Every counter is an exact integer.  Codes are Paradis codes or 0
(padding), whose features are 0 in every channel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from distance_tpu_torch.ops import _build
from distance_tpu_torch.ops.counters import (
    MAX_X_ROWS,
    MAX_Y_ROWS,
    SITE_ALIGN,
)
from distance_tpu_torch.ops.plan import CachedPlan

# Launches made by features_cuda (K5) and contract_cuda (K6: a product,
# with a shared plan's mix) in this process.
LAUNCHES_FEATURES = 0
LAUNCHES_CONTRACT = 0

# Sites of one chunk of the plain contraction on a CUDA device, which has
# no integer matmul: bounds its float64 copies of the features.
_PLAIN_CHUNK_ELEMS = 1 << 25

_bound = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _bound.get(name)
    if lib is None:
        lib = _build.load(name)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if name == "features":
            lib.dt_features_launch.argtypes = [vp, ll, ll, ll, i, vp, vp, vp]
            lib.dt_features_launch.restype = i
        else:
            lib.dt_contract_launch.argtypes = [
                vp, vp, ll, ll, ll, ll, ll, ll, ll, i, vp, vp, vp, vp]
            lib.dt_contract_launch.restype = i
            lib.dt_mix_launch.argtypes = [vp, ll, i, i, vp, vp, vp, vp]
            lib.dt_mix_launch.restype = i
        _bound[name] = lib
    return lib


def _side_lut(plan: CachedPlan, side: str) -> torch.Tensor:
    if side not in ("f", "g"):
        raise ValueError(f"side must be 'f' or 'g', got {side!r}")
    return plan.f_lut if side == "f" else plan.g_lut


def _check_codes(codes: torch.Tensor) -> None:
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(
            f"codes must be 2-D uint8, got {tuple(codes.shape)} {codes.dtype}")


def features_torch(codes: torch.Tensor, plan: CachedPlan,
                   side: str) -> torch.Tensor:
    """Plain version: (m, L) uint8 codes -> (R, m, L) int8 features of
    ``side`` by lookup in the plan's (R, 256) LUT."""
    _check_codes(codes)
    lut = _side_lut(plan, side).to(codes.device)
    return lut[:, codes.long()]


def features_cuda(codes: torch.Tensor, plan: CachedPlan,
                  side: str) -> torch.Tensor:
    """Launch K5 on the current stream of the codes' device: (m, L) uint8
    codes (rows at any stride, sites contiguous) -> (R, m, L) int8 features
    of ``side``, contiguous; raises on anything it does not take."""
    global LAUNCHES_FEATURES
    _check_codes(codes)
    lut = _side_lut(plan, side)
    if codes.device.type != "cuda":
        raise ValueError(f"features_cuda needs a CUDA tensor, got"
                         f" {codes.device}")
    if lut.device != codes.device:
        raise ValueError(f"plan tables on {lut.device}, codes on"
                         f" {codes.device}")
    m, width = codes.shape
    out = torch.empty((plan.channels, m, width), dtype=torch.int8,
                      device=codes.device)
    if m == 0 or width == 0:
        return out
    if width > 1 and codes.stride(1) != 1:
        raise ValueError("codes must have contiguous sites")
    nib = plan.f_nib if side == "f" else plan.g_nib
    words = np.ascontiguousarray(nib).view("<u4").ravel().tolist()
    tables = (ctypes.c_uint32 * len(words))(*words)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with torch.cuda.device(codes.device):
        rc = _lib("features").dt_features_launch(
            codes.data_ptr(), m, width, codes.stride(0), plan.channels,
            ctypes.addressof(tables), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"feature kernel launch failed: CUDA error {rc}")
    LAUNCHES_FEATURES += 1
    return out


def features(codes: torch.Tensor, plan: CachedPlan,
             side: str) -> torch.Tensor:
    """Features of one side: the plain version for CPU tensors, K5 for
    CUDA tensors."""
    if codes.device.type == "cpu":
        return features_torch(codes, plan, side)
    return features_cuda(codes, plan, side)


def _check_features(fx: torch.Tensor, gy: torch.Tensor,
                    plan: CachedPlan) -> None:
    if fx.dim() != 3 or gy.dim() != 3:
        raise ValueError(f"features must be 3-D, got {tuple(fx.shape)} and"
                         f" {tuple(gy.shape)}")
    if fx.dtype != torch.int8 or gy.dtype != torch.int8:
        raise ValueError(f"features must be int8, got {fx.dtype} and"
                         f" {gy.dtype}")
    if fx.shape[0] != plan.channels or gy.shape[0] != plan.channels:
        raise ValueError(f"features have {fx.shape[0]} and {gy.shape[0]}"
                         f" channels, the plan {plan.channels}")
    if fx.shape[2] != gy.shape[2]:
        raise ValueError(f"alignment widths differ: {fx.shape[2]} and"
                         f" {gy.shape[2]}")
    if fx.device != gy.device:
        raise ValueError(f"features on {fx.device} and {gy.device}")


def _mix(o: torch.Tensor, plan: CachedPlan) -> torch.Tensor:
    """(P, m, n) exact planes -> (G, m, n) int32 counters: themselves, or
    a shared plan's integer mix."""
    if plan.mix_num is None:
        return o.to(torch.int32)
    o = o.to(torch.int64)
    return torch.stack([
        sum(w * o[k] for k, w in enumerate(row) if w) // den
        for row, den in zip(plan.mix_num, plan.mix_den)]).to(torch.int32)


def contract_torch(fx: torch.Tensor, gy: torch.Tensor,
                   plan: CachedPlan) -> torch.Tensor:
    """Plain version: each plane contracted over its channels and all
    sites, divided by its ``den``, then mixed.  On the CPU in int32, which
    torch computes exactly; on a CUDA device, which has no integer
    matmul, in float64, exact because every partial sum is at most
    R x L < 2^53."""
    _check_features(fx, gy, plan)
    dev = fx.device
    exact = torch.int32 if dev.type == "cpu" else torch.float64
    m, n, width = fx.shape[1], gy.shape[1], fx.shape[2]
    acc = torch.zeros((plan.planes, m, n), dtype=exact, device=dev)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, plan.channels * max(m, n)))
    for s0 in range(0, width, chunk):
        f = fx[:, :, s0 : s0 + chunk].to(exact)
        g = gy[:, :, s0 : s0 + chunk].to(exact)
        for p in range(plan.planes):
            lo, hi = plan.bounds[p], plan.bounds[p + 1]
            acc[p] += torch.einsum("rml,rnl->mn", f[lo:hi], g[lo:hi])
    den = torch.tensor(plan.den, dtype=torch.int64, device=dev)
    return _mix(acc.to(torch.int64) // den[:, None, None], plan)


def _site_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (R, rows, L) when K6 takes it in place (sites contiguous, L,
    the strides and the address multiples of SITE_ALIGN), else a copy with
    its sites zero-padded to a multiple of SITE_ALIGN."""
    width = t.shape[2]
    if (width % SITE_ALIGN == 0 and t.stride(2) == 1
            and t.stride(0) % SITE_ALIGN == 0
            and t.stride(1) % SITE_ALIGN == 0
            and t.data_ptr() % SITE_ALIGN == 0):
        return t
    out = torch.zeros((*t.shape[:2], -(-width // SITE_ALIGN) * SITE_ALIGN),
                      dtype=t.dtype, device=t.device)
    out[:, :, :width] = t
    return out


def contract_cuda(fx: torch.Tensor, gy: torch.Tensor,
                  plan: CachedPlan) -> torch.Tensor:
    """Launch K6 on the current stream of the features' device: the
    product, and for a shared plan the mix of its per-channel planes.
    Features are read in place at their channel and row strides (a slice
    of a cache), unless their sites are not aligned to SITE_ALIGN, when
    they are first copied into padded rows; raises on anything it does
    not take."""
    global LAUNCHES_CONTRACT
    _check_features(fx, gy, plan)
    if fx.device.type != "cuda":
        raise ValueError(f"contract_cuda needs CUDA tensors, got {fx.device}")
    m, n = fx.shape[1], gy.shape[1]
    if m > MAX_X_ROWS or n > MAX_Y_ROWS:
        raise ValueError(
            f"contraction kernel takes at most {MAX_X_ROWS} x rows and"
            f" {MAX_Y_ROWS} y rows a launch, got {m} and {n}")
    out = torch.empty((plan.counters, m, n), dtype=torch.int32,
                      device=fx.device)
    if m == 0 or n == 0:
        return out
    fx, gy = _site_aligned(fx), _site_aligned(gy)
    lib = _lib("contract")
    shared = plan.mix_num is not None
    o = (torch.empty((plan.planes, m, n), dtype=torch.int32,
                     device=fx.device) if shared else out)
    bounds = (ctypes.c_int * (plan.planes + 1))(*plan.bounds)
    den = (ctypes.c_int * plan.planes)(*plan.den)
    stream = torch.cuda.current_stream(fx.device).cuda_stream
    with torch.cuda.device(fx.device):
        rc = lib.dt_contract_launch(
            fx.data_ptr(), gy.data_ptr(), m, n, fx.shape[2], fx.stride(0),
            fx.stride(1), gy.stride(0), gy.stride(1), plan.planes,
            ctypes.addressof(bounds), ctypes.addressof(den), o.data_ptr(),
            stream)
        if rc == 0 and shared:
            num = [w for row in plan.mix_num for w in row]
            num_c = (ctypes.c_int * len(num))(*num)
            den_c = (ctypes.c_int * plan.counters)(*plan.mix_den)
            rc = lib.dt_mix_launch(
                o.data_ptr(), m * n, plan.planes, plan.counters,
                ctypes.addressof(num_c), ctypes.addressof(den_c),
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"contraction kernel launch failed: CUDA error {rc}")
    LAUNCHES_CONTRACT += 1
    return out


def contract(fx: torch.Tensor, gy: torch.Tensor,
             plan: CachedPlan) -> torch.Tensor:
    """Counters over prebuilt features: the plain version for CPU
    tensors, K6 for CUDA tensors."""
    if fx.device.type == "cpu":
        return contract_torch(fx, gy, plan)
    return contract_cuda(fx, gy, plan)


def counters_cached(x: torch.Tensor, y: torch.Tensor,
                    plan: CachedPlan) -> torch.Tensor:
    """Counters of every (x, y) pair of two code matrices through the
    cached-feature path (the JAX ``counters_xla``): f features of x, g
    features of y, then the contraction."""
    if x.shape[1:] != y.shape[1:]:
        raise ValueError(f"alignment widths differ: {tuple(x.shape)} and"
                         f" {tuple(y.shape)}")
    return contract(features(x, plan, "f"), features(y, plan, "g"), plan)
