"""(dp, sp) grids of torch devices for the pairwise counters.

The port of ``distance_tpu/parallel/mesh.py``'s ``make_mesh`` and
``sharded_counters_fn``: pair-data parallelism ("dp", the y rows split
over the grid's rows of devices) and site parallelism ("sp", the sites
split over each row's devices).  Every counter is a sum over sites, so a
device's counters over its sites are exact int32 partials, and their sum
over a grid row (the JAX ``psum`` over "sp") gives the totals of its y
rows; the rows' totals join in canonical order.  One process drives every
device of the grid, as the JAX function's single controller does: a
partial reaches its row's first device by a copy, and the sum is an int32
add there.  ``sharded_step`` is the JAX module's step: the same partials,
summed with the float32 estimate in one pass (``ops/estimate.py``, K8 on
the card) on each row's first device, without the (G, m, n) total; the
dry run (``distance_tpu_torch/dryrun.py``) calls it.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from distance_tpu_torch.ops import cached as cached_ops
from distance_tpu_torch.ops import counters as kernels
from distance_tpu_torch.ops import estimate as estimate_ops
from distance_tpu_torch.ops.features import CounterPlan, get_plan
from distance_tpu_torch.ops.plan import cached_plan_to_torch, plan_to_torch

# Sites of an "sp" shard are a multiple of this (the padded site unit of
# the kernels' inputs).
SITE_UNIT = 128

BACKENDS = ("cached", "k1")


def make_mesh(devices: Sequence[torch.device],
              sp: int = 1) -> List[List[torch.device]]:
    """A (dp, sp) grid of ``devices``, row-major: dp = len(devices) / sp
    rows of sp devices each (the JAX ``make_mesh``)."""
    devices = list(devices)
    if sp < 1 or len(devices) % sp:
        raise ValueError(f"{len(devices)} devices do not divide into rows"
                         f" of sp {sp}")
    return [devices[r : r + sp] for r in range(0, len(devices), sp)]


def site_shards(width: int, sp: int) -> List[tuple]:
    """The (first, end) sites of each of ``sp`` site shards of ``width``
    sites: equal multiples of SITE_UNIT, the last one the rest (empty
    where the sites run out)."""
    step = -(-max(width, 1) // (sp * SITE_UNIT)) * SITE_UNIT
    return [(min(b * step, width), min((b + 1) * step, width))
            for b in range(sp)]


def _on(a, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a
    return t.to(device).contiguous()


def _row_partials(x, y, plan: CounterPlan, row: List[torch.device],
                  r: int, rows: int, shards: List[tuple], backend: str):
    """Grid row r's int32 site partials, (device, (G, m, rows) counters)
    of each of its devices that has sites: x's and y rows r rows .. (r +
    1) rows' codes of the device's sites, counted there by K5 and K6
    (``cached``) or by K1 (``k1``), or their plain versions on the CPU."""
    for dev, (s0, s1) in zip(row, shards):
        if s0 == s1:
            continue  # no sites, nothing to add
        xs = _on(x[:, s0:s1], dev)
        ys = _on(y[r * rows : (r + 1) * rows, s0:s1], dev)
        if backend == "cached":
            cplan = cached_plan_to_torch(plan, dev)
            part = cached_ops.contract(
                cached_ops.features(xs, cplan, "f"),
                cached_ops.features(ys, cplan, "g"), cplan)
        else:
            part = kernels.counters(xs, ys, plan_to_torch(plan, dev))
        yield dev, part


def _grid_rows(y, mesh: List[List[torch.device]], backend: str) -> tuple:
    """(rows a grid row, the site shards); raises on what the grid does
    not take."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of"
                         f" {BACKENDS}")
    dp, sp = len(mesh), len(mesh[0])
    n, width = y.shape
    if n % dp:
        raise ValueError(f"{n} y rows do not divide over dp {dp}")
    return n // dp, site_shards(width, sp)


def sharded_counters(x, y, plan: CounterPlan,
                     mesh: List[List[torch.device]],
                     backend: str = "cached") -> torch.Tensor:
    """(G, m, n) int32 counters of every (x, y) pair, on the grid's first
    device: x (m, L) and y (n, L) uint8 codes (arrays or tensors).  Grid
    row r takes y rows r n/dp .. (r + 1) n/dp (n must divide over the dp
    rows), its device s the sites of ``site_shards(L, sp)[s]``; each
    device counts its x and y slices, by K5 and K6 (``cached``, the JAX
    function's default ``counters_xla``) or by K1 (``k1``, for its
    ``pallas``), or their plain versions on the CPU; a row's partials are
    summed on its first device, and the rows joined along y."""
    rows, shards = _grid_rows(y, mesh, backend)
    totals = []
    for r, row in enumerate(mesh):
        total = torch.zeros((len(plan.counters), x.shape[0], rows),
                            dtype=torch.int32, device=row[0])
        for _, part in _row_partials(x, y, plan, row, r, rows, shards,
                                     backend):
            total += part.to(row[0])
        totals.append(total.to(mesh[0][0]))
    return torch.cat(totals, dim=2)


def sharded_step(measure: str, mesh: List[List[torch.device]],
                 backend: str = "cached") -> Callable:
    """One sharded step (the JAX ``sharded_step``): a function of (x, y)
    that gives the (m, n) float32 estimate of ``measure``'s counters of
    every (x, y) pair on the grid's first device, with the partials of
    ``sharded_counters`` (``_row_partials``) and no (G, m, n) total: each
    grid row's partials reach its first device (the rows the form reads,
    as the JAX ``psum`` moves them), where one K8 (its plain version on
    the CPU) sums them and writes the estimate of the row's y window;
    straight into the output where that device holds it, else into an
    (m, rows) float32 copied there.  The exact float64 distances stay the
    host finalizer's."""
    plan = get_plan(measure)
    n_rows = len(estimate_ops.FORMS[measure][1])

    def step(x, y) -> torch.Tensor:
        rows, shards = _grid_rows(y, mesh, backend)
        m = x.shape[0]
        out = torch.empty((m, y.shape[0]), dtype=torch.float32,
                          device=mesh[0][0])
        for r, row in enumerate(mesh):
            parts = [part if dev == row[0] else
                     estimate_ops.form_rows(part, measure, row[0])
                     for dev, part in _row_partials(x, y, plan, row, r, rows,
                                                    shards, backend)]
            if not parts:  # no sites: every counter 0
                parts = [torch.zeros((n_rows, m, rows), dtype=torch.int32,
                                     device=row[0])]
            if row[0] == out.device:
                estimate_ops.estimate_partials(parts, measure, out, r * rows)
            else:
                out[:, r * rows : (r + 1) * rows].copy_(
                    estimate_ops.estimate_partials(parts, measure))
        return out

    return step
