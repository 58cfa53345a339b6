"""A measure's counter plan in the form the counter kernel consumes.

The JAX package has no learned parameters: its state is the
``CounterPlan`` of ``ops/features.py`` (channel LUTs plus how channels
combine into counters).  ``plan_to_torch`` carries that plan over, folded
so that every counter is one contraction of its own channels:

    counter[g] = (sum_{k in bounds[g]:bounds[g+1]} sum_sites f_k(x) g_k(y))
                 // den[g]

A per-counter plan already has that form (its channel slices, ``den``
1).  A shared plan (k80, tn93) mixes shared channels with integer
weights; folding gives counter g the channels k with ``mix[g][k] != 0``,
its g-side feature scaled by ``mix[g][k]`` (weights in {-1, 1, 2}, so the
features stay int8), and the plan's ``den[g]``.  Every numerator is even
per site, so the division is exact.  The fold costs MACs (k80 6 -> 10
channel contractions, tn93 5 -> 9), which the tensor cores afford.

For every Paradis code the candidacy nibble (bits 7..4) decides every
feature: the known bit (bit 3) is set exactly on the single-candidate
nibbles, and no primitive of ``ops/features.py`` reads bits 2..0 beyond
"code != 0", which the nibble decides as well.  So each channel also
carries its two features as 16-entry nibble tables, which the CUDA kernel
looks up four codes at a time with byte permutes.

``cached_plan_to_torch`` carries the same plan over unfolded, for the
cached-feature path (``ops/cached.py``): the JAX plan's own R channels
(raw and jc69 18, n and n_high 14, k80 6, tn93 5), each feature built
once per matrix or strip, then contracted as the JAX package's
``contract_features`` does: one product per counter over its channel
slice, or for a shared plan one product per channel followed by the
exact integer mix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from distance_tpu_torch.encoding import ALL_CODES

# Limits the CUDA kernel is compiled for (csrc/counters.cu).
MAX_CHANNELS = 32
MAX_COUNTERS = 4


@dataclass(frozen=True, eq=False)
class KernelPlan:
    """Folded device tables and nibble tables of one measure."""

    f_lut: torch.Tensor  # (R, 256) int8: x-side feature of each code
    g_lut: torch.Tensor  # (R, 256) int8: y-side feature, weight folded in
    bounds: Tuple[int, ...]  # (G + 1,) channel range of each counter
    den: Tuple[int, ...]  # (G,) exact divisor of each counter
    f_nib: np.ndarray  # (R, 16) int8: x-side feature of each nibble
    g_nib: np.ndarray  # (R, 16) int8: y-side feature of each nibble

    @property
    def channels(self) -> int:
        return self.f_lut.shape[0]

    @property
    def counters(self) -> int:
        return len(self.den)


def nibble_tables(lut: np.ndarray) -> np.ndarray:
    """(R, 16) features by candidacy nibble of an (R, 256) LUT; raises if
    two Paradis codes (or code 0) of one nibble have different features."""
    codes = np.concatenate([[0], ALL_CODES]).astype(np.int64)
    out = np.zeros((lut.shape[0], 16), dtype=np.int8)
    out[:, codes >> 4] = lut[:, codes]
    if not np.array_equal(out[:, codes >> 4], lut[:, codes]):
        raise ValueError("features differ within one candidacy nibble")
    return out


def plan_to_torch(plan, device) -> KernelPlan:
    """Folded KernelPlan of a ``CounterPlan`` from either package, with
    its LUTs on ``device``."""
    if plan.mix_num is not None:
        terms = [[(k, int(w)) for k, w in enumerate(row) if w]
                 for row in plan.mix_num]
        den = tuple(int(d) for d in plan.mix_den)
    else:
        terms = [[(k, 1) for k in range(lo, hi)] for _, lo, hi in plan.slices]
        den = (1,) * len(terms)
    f_rows, g_rows, bounds = [], [], [0]
    for row in terms:
        for k, w in row:
            f_rows.append(plan.f_luts[k])
            g_rows.append(plan.g_luts[k].astype(np.int16) * w)
        bounds.append(len(f_rows))
    f_lut, g_lut = np.stack(f_rows), np.stack(g_rows)
    if np.abs(g_lut).max() > 127:
        raise ValueError(f"folded plan for {plan.measure!r} leaves int8")
    f_lut, g_lut = f_lut.astype(np.int8), g_lut.astype(np.int8)
    kp = KernelPlan(
        f_lut=torch.from_numpy(f_lut).to(device),
        g_lut=torch.from_numpy(g_lut).to(device),
        bounds=tuple(bounds),
        den=den,
        f_nib=nibble_tables(f_lut),
        g_nib=nibble_tables(g_lut),
    )
    if not (kp.channels <= MAX_CHANNELS and kp.counters <= MAX_COUNTERS
            and all(d > 0 for d in den)):
        raise ValueError(
            f"plan for {plan.measure!r} exceeds the counter kernel's limits"
        )
    return kp


@dataclass(frozen=True, eq=False)
class CachedPlan:
    """Unfolded device tables of one measure for the cached-feature path.

    The product contracts plane p over channels ``bounds[p]..bounds[p+1]``
    and all sites, divided exactly by ``den[p]``.  A per-counter plan has
    one plane a counter (its channel slice, ``den`` 1) and no mix; a
    shared plan one plane a channel, and counter g is then
    ``sum_k mix_num[g][k] * plane[k] // mix_den[g]``, exact because every
    numerator is even."""

    f_lut: torch.Tensor  # (R, 256) int8: x-side feature, sign included
    g_lut: torch.Tensor  # (R, 256) int8: y-side feature
    bounds: Tuple[int, ...]  # (P + 1,) channel range of each plane
    den: Tuple[int, ...]  # (P,) exact divisor of each plane
    mix_num: Optional[Tuple[Tuple[int, ...], ...]]  # (G, P), shared plans
    mix_den: Optional[Tuple[int, ...]]  # (G,)
    f_nib: np.ndarray  # (R, 16) int8: x-side feature of each nibble
    g_nib: np.ndarray  # (R, 16) int8: y-side feature of each nibble

    @property
    def channels(self) -> int:
        return self.f_lut.shape[0]

    @property
    def planes(self) -> int:
        return len(self.den)

    @property
    def counters(self) -> int:
        return self.planes if self.mix_num is None else len(self.mix_num)


def cached_plan_to_torch(plan, device) -> CachedPlan:
    """The unfolded CachedPlan of a ``CounterPlan`` from either package,
    with its LUTs on ``device``."""
    r = len(plan.f_luts)
    if plan.mix_num is not None:
        bounds = tuple(range(r + 1))
        mix_num = tuple(tuple(int(w) for w in row) for row in plan.mix_num)
        mix_den = tuple(int(d) for d in plan.mix_den)
    else:
        bounds = (0,) + tuple(hi for _, _, hi in plan.slices)
        if [lo for _, lo, _ in plan.slices] != list(bounds[:-1]):
            raise ValueError(f"plan for {plan.measure!r}: slices not in order")
        mix_num = mix_den = None
    f_lut = np.ascontiguousarray(plan.f_luts, dtype=np.int8)
    g_lut = np.ascontiguousarray(plan.g_luts, dtype=np.int8)
    cp = CachedPlan(
        f_lut=torch.from_numpy(f_lut).to(device),
        g_lut=torch.from_numpy(g_lut).to(device),
        bounds=bounds,
        den=(1,) * (len(bounds) - 1),
        mix_num=mix_num,
        mix_den=mix_den,
        f_nib=nibble_tables(f_lut),
        g_nib=nibble_tables(g_lut),
    )
    if not (cp.channels <= MAX_CHANNELS and bounds[-1] == r
            and cp.counters <= MAX_COUNTERS
            and all(d > 0 for d in mix_den or (1,))):
        raise ValueError(
            f"plan for {plan.measure!r} exceeds the cached path's limits"
        )
    return cp


def fold_cached(plan, device) -> CachedPlan:
    """The folded form of a plan as a CachedPlan: K1's channels
    (``plan_to_torch``: k80 10, tn93 9, the mix weight in the g side), one
    plane a counter with its exact divisor, and no mix.  The same counters
    as ``cached_plan_to_torch``'s form, by other products."""
    kp = plan_to_torch(plan, device)
    return CachedPlan(
        f_lut=kp.f_lut, g_lut=kp.g_lut, bounds=kp.bounds, den=kp.den,
        mix_num=None, mix_den=None, f_nib=kp.f_nib, g_nib=kp.g_nib,
    )
