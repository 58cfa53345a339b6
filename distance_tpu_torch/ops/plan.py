"""A measure's counter plan in the form the counter kernel consumes.

The JAX package has no learned parameters: its state is the
``CounterPlan`` of ``ops/features.py`` (channel LUTs plus how channels
combine into counters).  ``plan_to_torch`` carries that plan over.

Both plan kinds reduce to one shape.  Channels are summed into
accumulators over contiguous channel ranges, and each counter is an
exact integer mix of the accumulators:

    acc[a]     = sum_{k in bounds[a]:bounds[a+1]} sum_sites f_k(x) g_k(y)
    counter[g] = (sum_a mix[g][a] * acc[a]) // den[g]

A per-counter plan has one accumulator per counter (its channel slice),
an identity mix and ``den`` 1.  A shared plan (k80, tn93) has one
accumulator per channel and the plan's integer ``mix_num``/``mix_den``;
every numerator is even per site, so the division is exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

# Limits the CUDA kernel is compiled for (csrc/counters.cu).
MAX_CHANNELS = 32
MAX_ACCUMULATORS = 6
MAX_COUNTERS = 4


@dataclass(frozen=True, eq=False)
class KernelPlan:
    """Device tables and integer mix of one measure's counters."""

    f_lut: torch.Tensor  # (R, 256) int8: x-side feature of each code
    g_lut: torch.Tensor  # (R, 256) int8: y-side feature of each code
    bounds: Tuple[int, ...]  # (A + 1,) channel range of each accumulator
    mix: Tuple[Tuple[int, ...], ...]  # (G, A)
    den: Tuple[int, ...]  # (G,)

    @property
    def channels(self) -> int:
        return self.f_lut.shape[0]

    @property
    def accumulators(self) -> int:
        return len(self.bounds) - 1

    @property
    def counters(self) -> int:
        return len(self.den)


def plan_to_torch(plan, device) -> KernelPlan:
    """KernelPlan of a ``CounterPlan`` from either package, with its LUTs
    on ``device``."""
    r = plan.f_luts.shape[0]
    if plan.mix_num is not None:
        bounds = tuple(range(r + 1))
        mix = tuple(tuple(int(w) for w in row) for row in plan.mix_num)
        den = tuple(int(d) for d in plan.mix_den)
    else:
        bounds = (0,) + tuple(hi for _, _, hi in plan.slices)
        if tuple(lo for _, lo, _ in plan.slices) != bounds[:-1]:
            raise ValueError(f"channel slices of {plan.measure!r} are not"
                             " contiguous")
        g = len(plan.slices)
        mix = tuple(tuple(int(a == b) for b in range(g)) for a in range(g))
        den = (1,) * g
    kp = KernelPlan(
        f_lut=torch.from_numpy(plan.f_luts.copy()).to(device),
        g_lut=torch.from_numpy(plan.g_luts.copy()).to(device),
        bounds=bounds,
        mix=mix,
        den=den,
    )
    if not (
        kp.channels <= MAX_CHANNELS
        and kp.accumulators <= MAX_ACCUMULATORS
        and kp.counters <= MAX_COUNTERS
    ):
        raise ValueError(
            f"plan for {plan.measure!r} exceeds the counter kernel's limits"
        )
    return kp
