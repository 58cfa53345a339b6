"""Packing of counter blocks before they leave the device.

Two families, as in ``distance_tpu/ops/packing.py``.  Below 2^16 sites
(``PACK_LIMIT``) a measure's counters fit 16-bit fields: the wide pack
puts them in one or two 32-bit words a pair (16-bit for the one-counter
measures), and the narrow pack in saturating 8-bit lanes (255 =
saturated) of the small quantities each measure needs (raw [diff, width -
(diff + same)], k80 [width - count, ts, tv], tn93 [width - kk, kk - same,
p1, p2]).  ``pack_narrow_cuda``/``pack_wide_cuda`` launch the
hand-written kernel of ``csrc/packing.cu`` (the port of
``pack_device_narrow`` and ``pack_device``); ``pack_narrow_torch`` and
``pack_wide_torch`` are their plain PyTorch versions, and the words keep
the JAX package's signed wire types (int8, int16, int32).

The rel family packs rank-1 residuals.  Every counter is a sum over
columns of f(x_col, y_col), so for any reference row ``ref`` the
residual

    c(i, r) - c(i, ref) - c(ref, r) + c(ref, ref)

accrues only on columns where both records differ from ``ref``: a handful
of columns even for diverse data.  The device ships it as int8 lanes
(``rel``, -128 = saturated) or as two 4-bit lanes a byte (``rel4``, -8 =
saturated) with a segmented exception sidecar for the outliers, beside
the small int32 baselines rb = c(i, ref), cb = c(ref, r), cc = c(ref,
ref); the host adds the baselines back.

``pack_rel4_cuda``/``pack_rel_cuda`` launch the same kernel source's
other entries (the port of ``pack_device_rel4`` and ``pack_device_rel``,
which XLA ran inside the JAX engine's block and stream functions), one
launch a pack, reading the baselines in place at their row stride;
``pack_rel4_torch`` and ``pack_rel_torch`` are their plain versions.
Every plain version computes exactly what the JAX function computes with
``xp=np``.  ``pack_narrow``, ``pack_wide``, ``pack_rel4`` and
``pack_rel`` take the plain version for CPU tensors and the kernel for
CUDA tensors, and raise rather than fall back.  ``bundle_sidecars`` fuses
the small arrays into one int32 vector (torch glue).

The host halves (constants, ``unpack_host``, ``unpack_host_narrow``,
``unpack_host_rel``, ``unpack_rel4_nibbles``, ``finish_host_rel4``,
``unbundle_sidecars``) are copied verbatim from the JAX module;
``tests/test_torch_host_copies.py`` pins them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distance_tpu_torch.measures import MEASURE_COUNTERS
from distance_tpu_torch.ops import _build

PACK_LIMIT = 1 << 16  # alignment width must be < 2^16 to pack (wide)
NARROW_SAT = 255

REL_SAT = -128  # sentinel: residual out of [-127, 127] (wide refetch)
REL4_SAT = -8   # nibble sentinel: residual out of [-7, 7]

# Exception sidecar of rel4: the flat (G, m, n) residual tensor splits
# into REL4_SEGMENTS ranges of ceil(G m n / REL4_SEGMENTS) cells, and the
# first and last outlier of each travel as (flat index, value); a segment
# holding three or more leaves the others at -8, and the block takes the
# refetch.  Sidecar = 2 * REL4_SEGMENTS entries.
REL4_SEGMENTS = 8192
REL4_EXC_CAP = 2 * REL4_SEGMENTS

# Most cells the rel packs take in one launch: rel4's sidecar indexes the
# flat (G, m, n) tensor with int32.
MAX_CELLS = (1 << 31) - 1

SIDECAR_MAGIC = 0x52454C42  # 'RELB'
_HDR = 6  # [magic, G, ti, span, exc_b, cap]

# Kernel launches made by pack_rel4_cuda, pack_rel_cuda, pack_narrow_cuda
# and pack_wide_cuda in this process.
LAUNCHES_REL4 = 0
LAUNCHES_REL = 0
LAUNCHES_NARROW = 0
LAUNCHES_WIDE = 0

_bound = None


def _sat(v: torch.Tensor) -> torch.Tensor:
    """numpy's ``minimum(v, 255).astype(uint8)`` viewed as int8."""
    return torch.clamp(v, max=NARROW_SAT).to(torch.uint8).view(torch.int8)


def _word(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """numpy's ``(hi.astype(uint32) << 16) | lo.astype(uint32)`` viewed
    as int32."""
    mask = 0xFFFFFFFF
    w = (((hi.to(torch.int64) & mask) << 16) | (lo.to(torch.int64) & mask))
    return (w & mask).to(torch.int32)


def pack_narrow_torch(measure: str, c: torch.Tensor,
                      width: int) -> torch.Tensor:
    """Plain version of the narrow pack: (G, m, n) int32 counters -> (G,
    m, n) int8 saturating lanes of ``measure``'s form at ``width`` sites
    (``pack_device_narrow``)."""
    if measure in ("n", "n_high"):
        lanes = [_sat(c[0])]
    elif measure in ("raw", "jc69"):
        lanes = [_sat(c[0]), _sat(width - (c[0] + c[1]))]
    elif measure == "k80":
        lanes = [_sat(width - (c[0] + c[1] + c[2])), _sat(c[1]), _sat(c[2])]
    elif measure == "tn93":
        lanes = [_sat(width - c[1]), _sat(c[1] - c[0]), _sat(c[2]),
                 _sat(c[3])]
    else:
        raise ValueError(measure)
    return torch.stack(lanes)


def pack_wide_torch(measure: str, c: torch.Tensor) -> torch.Tensor:
    """Plain version of the wide pack: (G, m, n) int32 counters -> (1, m,
    n) int16 for the one-counter measures, (1, m, n) int32 for raw and
    jc69, (2, m, n) int32 for k80 and tn93 (``pack_device``)."""
    if measure in ("n", "n_high"):
        return c[0].to(torch.int16)[None]
    if measure in ("raw", "jc69"):
        return _word(c[0], c[1])[None]
    if measure == "k80":
        return torch.stack([_word(c[0], c[1]), c[2]])
    if measure == "tn93":
        return torch.stack([_word(c[0], c[1]), _word(c[2], c[3])])
    raise ValueError(measure)


def _check_lanes(measure: str, c: torch.Tensor) -> int:
    """The measure's counter count, once ``c`` is checked to hold them."""
    if measure not in MEASURE_COUNTERS:
        raise ValueError(measure)
    g = len(MEASURE_COUNTERS[measure])
    if c.dim() != 3 or c.shape[0] != g or c.dtype != torch.int32:
        raise ValueError(f"{measure} packs ({g}, m, n) int32 counters, got"
                         f" {tuple(c.shape)} {c.dtype}")
    return g


def block_mask(m: int, n: int, i0: int = 0, j0: int = 0,
               nv: Optional[Tuple[int, int]] = None,
               diag_off: Optional[int] = None,
               device: Optional[torch.device] = None
               ) -> Optional[torch.Tensor]:
    """(m, n) bool of a block's cells that the pack zeroes, or None: its
    rows are records i0.. and its columns j0.. of their sides.  With
    ``diag_off`` the self-pairs of a sweep over one source (row i0 + r is
    column j0 + c when i0 + r + diag_off == j0 + c); with ``nv`` = (valid
    rows, valid columns) the padding past them."""
    if diag_off is None and nv is None:
        return None
    ri = torch.arange(m, device=device)[:, None] + i0
    cj = torch.arange(n, device=device)[None, :] + j0
    mask = None
    if diag_off is not None:
        mask = (ri + diag_off) == cj
    if nv is not None:
        pad = (ri >= nv[0]) | (cj >= nv[1])
        mask = pad if mask is None else mask | pad
    return mask


def _residual(c, rb, cb, cc, mask):
    res = c - rb[:, :, None] - cb[:, None, :] + cc[:, None, None]
    if mask is not None:
        res = torch.where(mask[None, :, :], 0, res)
    return res


def pack_rel_torch(c: torch.Tensor, rb: torch.Tensor, cb: torch.Tensor,
                   cc: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of rel: (G, m, n) int32 counters -> (G, m, n) int8
    residual lanes; ``rb`` (G, m), ``cb`` (G, n), ``cc`` (G,) int32, cells
    of ``mask`` (m, n) zeroed."""
    res = _residual(c, rb, cb, cc, mask)
    return torch.where(res.abs() > 127, REL_SAT, res).to(torch.int8)


def pack_rel4_torch(c: torch.Tensor, rb: torch.Tensor, cb: torch.Tensor,
                    cc: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    col0: int = 0, n_whole: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of rel4: (G, m, n) int32 counters (n even) -> lanes
    (G, m, n/2) int8, two's-complement nibbles two a byte along columns
    (the even column in the low nibble), and the exception sidecar
    exc_idx, exc_val (REL4_EXC_CAP,) int32: the first outlier of each
    segment, then the last of each that holds two or more (-1 and 0 in
    unused slots).

    ``c`` may be the window of columns ``col0`` .. ``col0 + n`` of a block
    ``n_whole`` columns wide (one device's part of a split block): the
    segments and the sidecar's flat indices are then the whole (G, m,
    n_whole) block's, so that ``merge_rel4_sidecars`` of the parts gives
    the whole block's sidecar."""
    res = _residual(c, rb, cb, cc, mask)
    sat = res.abs() > 7
    nib = (torch.where(sat, REL4_SAT, res) & 0xF).to(torch.uint8)
    lanes = (nib[..., 0::2] | (nib[..., 1::2] << 4)).view(torch.int8)
    g, m, n = res.shape
    n_whole = n if n_whole is None else n_whole
    _check_window(n, col0, n_whole)
    exc_idx = torch.full((REL4_EXC_CAP,), -1, dtype=torch.int32,
                         device=c.device)
    exc_val = torch.zeros(REL4_EXC_CAP, dtype=torch.int32, device=c.device)
    out = torch.nonzero(sat.reshape(-1)).squeeze(1)
    if not out.numel():
        return lanes, exc_idx, exc_val
    seg_len = -(-(g * m * n_whole) // REL4_SEGMENTS)
    # the outliers' flat indices in the whole block, ascending
    flat = out // n * n_whole + col0 + out % n
    vals = res.reshape(-1)[out]
    segs, count = torch.unique_consecutive(flat // seg_len,
                                           return_counts=True)
    end = torch.cumsum(count, 0)
    first = end - count
    exc_idx[segs] = flat[first].to(torch.int32)
    exc_val[segs] = vals[first]
    two = count >= 2
    exc_idx[REL4_SEGMENTS + segs[two]] = flat[end[two] - 1].to(torch.int32)
    exc_val[REL4_SEGMENTS + segs[two]] = vals[end[two] - 1]
    return lanes, exc_idx, exc_val


def _check_window(n: int, col0: int, n_whole: int) -> None:
    if col0 < 0 or n_whole < n or col0 > n_whole - n:
        raise ValueError(f"columns {col0} .. {col0 + n} are no window of a"
                         f" block {n_whole} columns wide")


def merge_rel4_sidecars(exc_idx: torch.Tensor, exc_val: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole block's rel4 sidecar from its parts' (torch glue): the
    parts' windowed sidecars stacked on the first axis, (k, ..., CAP)
    int32 each, merged segment by segment into (..., CAP).  A segment's
    first outlier is the least of its parts' firsts, and its last the
    greatest of its parts' lasts (a part's last is its second slot, or its
    first where the second is empty), kept only where the parts hold two
    or more outliers in all; each value comes from the part whose index
    won."""
    s = REL4_SEGMENTS
    i1, i2 = exc_idx[..., :s], exc_idx[..., s:]
    v1, v2 = exc_val[..., :s], exc_val[..., s:]
    has1 = i1 >= 0
    first, at_first = torch.where(has1, i1, torch.iinfo(torch.int32).max
                                  ).min(dim=0)
    last_i = torch.where(i2 >= 0, i2, i1)
    last, at_last = last_i.max(dim=0)
    one = has1.any(dim=0)
    two = (has1.sum(dim=0) >= 2) | (i2 >= 0).any(dim=0)
    val1 = torch.gather(v1, 0, at_first[None])[0]
    val2 = torch.gather(torch.where(i2 >= 0, v2, v1), 0, at_last[None])[0]
    return (torch.cat([torch.where(one, first, -1),
                       torch.where(two, last, -1)], dim=-1),
            torch.cat([torch.where(one, val1, 0), torch.where(two, val2, 0)],
                      dim=-1))


def _check(c, rb, cb, cc) -> None:
    if c.dim() != 3 or rb.dim() != 2 or cb.dim() != 2 or cc.dim() != 1:
        raise ValueError(
            f"expected c (G, m, n), rb (G, m), cb (G, n), cc (G,); got"
            f" {tuple(c.shape)}, {tuple(rb.shape)}, {tuple(cb.shape)},"
            f" {tuple(cc.shape)}"
        )
    g, m, n = c.shape
    if rb.shape != (g, m) or cb.shape != (g, n) or cc.shape != (g,):
        raise ValueError(
            f"baselines {tuple(rb.shape)}, {tuple(cb.shape)},"
            f" {tuple(cc.shape)} do not fit counters {tuple(c.shape)}"
        )
    for t in (c, rb, cb, cc):
        if t.dtype != torch.int32:
            raise ValueError(f"counters and baselines must be int32, got"
                             f" {t.dtype}")
        if t.device != c.device:
            raise ValueError(f"tensors on {c.device} and {t.device}")


def _kernel_lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = _build.load("packing")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.dt_pack_rel4_launch.argtypes = [
            vp, vp, ll, vp, ll, vp, ll, ll, ll, ll, ll, ll, ll, i, ll, ll,
            ll, vp, vp, vp,
        ]
        lib.dt_pack_rel4_launch.restype = ctypes.c_int
        lib.dt_pack_rel_launch.argtypes = [
            vp, vp, ll, vp, ll, vp, ll, ll, ll, ll, ll, i, ll, vp, vp,
        ]
        lib.dt_pack_rel_launch.restype = ctypes.c_int
        lib.dt_pack_narrow_launch.argtypes = [vp, ll, ll, ll, vp, vp]
        lib.dt_pack_narrow_launch.restype = ctypes.c_int
        lib.dt_pack_wide_launch.argtypes = [vp, ll, ll, vp, vp]
        lib.dt_pack_wide_launch.restype = ctypes.c_int
        _bound = lib
    return _bound


def _lane_launch(entry: str, c: torch.Tensor, out_shape, dtype: torch.dtype,
                 *width: int) -> torch.Tensor:
    """Launch the narrow or wide entry of the kernel on the current stream
    of the (G, m, n) counters' device, into a new (P, m, n) tensor."""
    if c.device.type != "cuda":
        raise ValueError(f"the pack kernel needs CUDA tensors, got {c.device}")
    c = c.contiguous()
    out = torch.empty(out_shape, dtype=dtype, device=c.device)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):
        rc = getattr(_kernel_lib(), entry)(
            c.data_ptr(), c.shape[0], c.shape[1] * c.shape[2], *width,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    return out


def pack_narrow_cuda(measure: str, c: torch.Tensor,
                     width: int) -> torch.Tensor:
    """Launch the narrow kernel: ``pack_narrow_torch`` on the card."""
    global LAUNCHES_NARROW
    _check_lanes(measure, c)
    if not -(1 << 31) <= width < 1 << 31:
        raise ValueError(f"width {width} is not an int32")
    out = _lane_launch("dt_pack_narrow_launch", c, c.shape, torch.int8, width)
    LAUNCHES_NARROW += 1
    return out


def pack_wide_cuda(measure: str, c: torch.Tensor) -> torch.Tensor:
    """Launch the wide kernel: ``pack_wide_torch`` on the card."""
    global LAUNCHES_WIDE
    g = _check_lanes(measure, c)
    out = _lane_launch("dt_pack_wide_launch", c,
                       ((g + 1) // 2, c.shape[1], c.shape[2]),
                       torch.int16 if g == 1 else torch.int32)
    LAUNCHES_WIDE += 1
    return out


def pack_narrow(measure: str, c: torch.Tensor, width: int) -> torch.Tensor:
    """Narrow lanes of a block: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if c.device.type != "cpu":
        return pack_narrow_cuda(measure, c, width)
    _check_lanes(measure, c)
    return pack_narrow_torch(measure, c, width)


def pack_wide(measure: str, c: torch.Tensor) -> torch.Tensor:
    """Wide words of a block: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if c.device.type != "cpu":
        return pack_wide_cuda(measure, c)
    _check_lanes(measure, c)
    return pack_wide_torch(measure, c)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A baseline whose rows the kernel reads in place (each contiguous,
    at any row stride), copied only when they are not."""
    return t if t.stride(1) == 1 or t.shape[1] <= 1 else t.contiguous()


def _launch_rel(entry: str, c, rb, cb, cc, shape, *args):
    """Launch a rel-family entry of the kernel on the current stream of
    the counters' device into a new int8 tensor of ``shape``; ``args``
    follow the shape arguments, and the output tensor (and for rel4 the
    sidecar ``exc``) follow them."""
    if c.device.type != "cuda":
        raise ValueError(f"the pack kernel needs CUDA tensors, got {c.device}")
    if c.numel() > MAX_CELLS:
        raise ValueError(
            f"the pack kernel takes fewer than 2^31 cells, got"
            f" {tuple(c.shape)}")
    c, rb, cb, cc = c.contiguous(), _rows(rb), _rows(cb), cc.contiguous()
    if c.data_ptr() % 16:
        raise ValueError("the pack kernel reads counters in 16-byte vectors:"
                         " c must be 16-byte aligned")
    lanes = torch.empty(shape, dtype=torch.int8, device=c.device)
    exc = (torch.empty((2, REL4_EXC_CAP), dtype=torch.int32, device=c.device)
           if entry == "dt_pack_rel4_launch" else None)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):
        rc = getattr(_kernel_lib(), entry)(
            c.data_ptr(), rb.data_ptr(), rb.stride(0), cb.data_ptr(),
            cb.stride(0), cc.data_ptr(), *c.shape, *args, lanes.data_ptr(),
            *([exc.data_ptr()] if exc is not None else []), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    return lanes, exc


def pack_rel4_cuda(c: torch.Tensor, rb: torch.Tensor, cb: torch.Tensor,
                   cc: torch.Tensor, i0: int = 0, j0: int = 0,
                   nv: Optional[Tuple[int, int]] = None,
                   diag_off: Optional[int] = None, col0: int = 0,
                   n_whole: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the rel4 kernel on the current stream of the counters'
    device: ``pack_rel4_torch`` of the cells ``block_mask`` names, ``c``
    the window at ``col0`` of a block ``n_whole`` columns wide.  One
    launch; the sidecar is one (2, REL4_EXC_CAP) allocation, exc_idx and
    exc_val its rows."""
    global LAUNCHES_REL4
    _check(c, rb, cb, cc)
    g, m, n = c.shape
    if n % 2:
        raise ValueError(f"rel4 packs columns two a byte: {n} is odd")
    n_whole = n if n_whole is None else n_whole
    _check_window(n, col0, n_whole)
    if g * m * n_whole > MAX_CELLS:
        raise ValueError(f"the pack kernel takes blocks of fewer than 2^31"
                         f" cells, got {(g, m, n_whole)}")
    nv1, nv2 = nv if nv is not None else (i0 + m, j0 + n)
    lanes, exc = _launch_rel(
        "dt_pack_rel4_launch", c, rb, cb, cc, (g, m, n // 2), i0, j0, nv1,
        nv2, int(diag_off is not None), diag_off or 0, col0, n_whole)
    LAUNCHES_REL4 += 1
    return lanes, exc[0], exc[1]


def pack_rel_cuda(c: torch.Tensor, rb: torch.Tensor, cb: torch.Tensor,
                  cc: torch.Tensor, i0: int = 0, j0: int = 0,
                  diag_off: Optional[int] = None) -> torch.Tensor:
    """Launch the rel kernel on the current stream of the counters'
    device: ``pack_rel_torch`` with the self-pair diagonal masked."""
    global LAUNCHES_REL
    _check(c, rb, cb, cc)
    lanes, _ = _launch_rel("dt_pack_rel_launch", c, rb, cb, cc, c.shape, i0,
                           j0, int(diag_off is not None), diag_off or 0)
    LAUNCHES_REL += 1
    return lanes


def pack_rel4(c: torch.Tensor, rb: torch.Tensor, cb: torch.Tensor,
              cc: torch.Tensor, i0: int = 0, j0: int = 0,
              nv: Optional[Tuple[int, int]] = None,
              diag_off: Optional[int] = None, col0: int = 0,
              n_whole: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rel4 lanes and sidecar of a block whose rows are records i0.. and
    columns j0.. of their sides, masked as ``block_mask`` says, or of the
    window at ``col0`` of a block ``n_whole`` columns wide: the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if c.device.type != "cpu":
        return pack_rel4_cuda(c, rb, cb, cc, i0, j0, nv, diag_off, col0,
                              n_whole)
    _check(c, rb, cb, cc)
    if c.shape[2] % 2:
        raise ValueError(f"rel4 packs columns two a byte: {c.shape[2]} is odd")
    mask = block_mask(c.shape[1], c.shape[2], i0, j0, nv, diag_off)
    return pack_rel4_torch(c, rb, cb, cc, mask, col0, n_whole)


def pack_rel(c: torch.Tensor, rb: torch.Tensor, cb: torch.Tensor,
             cc: torch.Tensor, i0: int = 0, j0: int = 0,
             diag_off: Optional[int] = None) -> torch.Tensor:
    """rel lanes of a block, its self-pair diagonal masked (``diag_off``):
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    if c.device.type != "cpu":
        return pack_rel_cuda(c, rb, cb, cc, i0, j0, diag_off)
    _check(c, rb, cb, cc)
    mask = block_mask(c.shape[1], c.shape[2], i0, j0, None, diag_off)
    return pack_rel_torch(c, rb, cb, cc, mask)


_headers: Dict[tuple, torch.Tensor] = {}


def bundle_sidecars(cb: torch.Tensor, rb_cc: torch.Tensor,
                    exc_idx: Optional[torch.Tensor] = None,
                    exc_val: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The small rel-family arrays fused into one 1-D int32 vector on
    their device, laid out as the JAX ``bundle_sidecars`` lays them out:
    the header [magic, G, ti, span, exc_b, cap], ``cb`` (G, span),
    ``rb_cc`` (G, ti + 1) and, under rel4, the sidecar ``exc_idx`` and
    ``exc_val`` ((CAP,) or block-stacked (B, CAP); a (CAP,) sidecar is
    recorded as B = 1)."""
    g, span = cb.shape
    ti = rb_cc.shape[1] - 1
    if exc_idx is None:
        exc_b = cap = 0
        tail = []
    else:
        exc_b = 1 if exc_idx.dim() == 1 else int(exc_idx.shape[0])
        cap = int(exc_idx.shape[-1])
        tail = [exc_idx.reshape(-1), exc_val.reshape(-1)]
    key = (cb.device, g, ti, span, exc_b, cap)
    header = _headers.get(key)
    if header is None:
        header = _headers[key] = torch.tensor(
            [SIDECAR_MAGIC, g, ti, span, exc_b, cap], dtype=torch.int32,
            device=cb.device)
    return torch.cat([header, cb.reshape(-1), rb_cc.reshape(-1), *tail])


def unpack_host(measure: str, packed: np.ndarray) -> np.ndarray:
    """Packed host array -> (G, ...) int32 counters (same order as the
    measure's CounterPlan)."""
    if measure in ("n", "n_high"):
        return packed.view(np.uint16).astype(np.int32)
    p = packed.view(np.uint32)
    hi0 = (p[0] >> 16).astype(np.int32)
    lo0 = (p[0] & 0xFFFF).astype(np.int32)
    if measure in ("raw", "jc69"):
        return np.stack([hi0, lo0])
    if measure == "k80":
        return np.stack([hi0, lo0, p[1].astype(np.int32)])
    if measure == "tn93":
        hi1 = (p[1] >> 16).astype(np.int32)
        lo1 = (p[1] & 0xFFFF).astype(np.int32)
        return np.stack([hi0, lo0, hi1, lo1])
    raise ValueError(measure)


def unpack_host_narrow(
    measure: str, packed: np.ndarray, width: int
) -> Optional[np.ndarray]:
    """Narrow lanes -> (G, ...) int32 counters, or None if any lane
    saturated (caller must refetch wide)."""
    a = packed.view(np.uint8)
    if (a == NARROW_SAT).any():
        return None
    a = a.astype(np.int32)
    if measure in ("n", "n_high"):
        return a
    if measure in ("raw", "jc69"):
        diff = a[0]
        same = (width - a[1]) - diff
        return np.stack([diff, same])
    if measure == "k80":
        count_l = width - a[0]
        same = count_l - a[1] - a[2]
        return np.stack([same, a[1], a[2]])
    if measure == "tn93":
        kk = width - a[0]
        same = kk - a[1]
        return np.stack([same, kk, a[2], a[3]])
    raise ValueError(measure)


def unpack_host_rel(
    packed: np.ndarray, rb: np.ndarray, cb: np.ndarray, cc: np.ndarray
) -> Optional[np.ndarray]:
    """Residual lanes + baselines -> (G, m, n) int32 counters, or None
    if any lane saturated (caller must refetch wide).

    The saturation scan runs BEFORE the int32 widening: a saturated
    strip (the case this function exists to detect) must not pay a
    4x-size allocation it immediately discards."""
    if (packed == REL_SAT).any():
        return None
    a = packed.astype(np.int32)
    return a + rb[:, :, None] + cb[:, None, :] - cc[:, None, None]


def unpack_rel4_nibbles(packed: np.ndarray) -> np.ndarray:
    """(..., n/2) int8 packed bytes -> (..., n) int32 residuals
    (sign-extended; REL4_SAT marks saturation — caller checks after
    cropping away padding columns)."""
    b = packed.view(np.uint8)
    nib = np.empty(b.shape[:-1] + (b.shape[-1] * 2,), dtype=np.uint8)
    nib[..., 0::2] = b & 0xF
    nib[..., 1::2] = b >> 4
    val = nib.astype(np.int32)
    val -= (val > 7) * 16
    return val


def finish_host_rel4(
    res: np.ndarray,
    rb: np.ndarray,
    cb: np.ndarray,
    cc: np.ndarray,
    bad: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Cropped int32 nibble residuals + baselines -> counters, or None
    on saturation.  ``bad`` marks cells whose -8 is an UNPATCHED
    sentinel (callers that patched the exception sidecar clear patched
    positions first — a patched value may legitimately be -8); without
    it any -8 counts as saturation."""
    if bad is None:
        bad = res == REL4_SAT
    if bad.any():
        return None
    return res + rb[:, :, None] + cb[:, None, :] - cc[:, None, None]


def unbundle_sidecars(flat: np.ndarray):
    """Split a fetched bundle back into (cb, rb_cc, exc_idx, exc_val);
    the exception entries are None for plain rel."""
    h = flat[:_HDR]
    if int(h[0]) != SIDECAR_MAGIC:
        raise ValueError("not a sidecar bundle")
    g, ti, span, exc_b, cap = (int(v) for v in h[1:])
    o = _HDR
    cb = flat[o : o + g * span].reshape(g, span)
    o += g * span
    rb_cc = flat[o : o + g * (ti + 1)].reshape(g, ti + 1)
    o += g * (ti + 1)
    if not exc_b:
        return cb, rb_cc, None, None
    exc_idx = flat[o : o + exc_b * cap].reshape(exc_b, cap)
    o += exc_b * cap
    exc_val = flat[o : o + exc_b * cap].reshape(exc_b, cap)
    return cb, rb_cc, exc_idx, exc_val
