"""K8's plain version (``ops/estimate.py::estimate_partials_torch``) and
the fused sharded step (``parallel/mesh.py::sharded_step``) on the CPU.

The estimate of the int32 sum of site partials, written into a window of
an output, must equal ``estimate_torch`` of the summed counters bit for
bit (NaN cells alike) and leave the cells outside the window as they
were; the step must give the plain counters' estimate without building a
(G, m, n) total.  Inputs come from a numpy seed.  The JAX ``sharded_step``
itself is held against the port in ``tests/test_torch_dryrun.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu_torch import dryrun  # noqa: E402
from distance_tpu_torch.ops import estimate as estimate_ops  # noqa: E402
from distance_tpu_torch.ops.counters import counters_torch  # noqa: E402
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
from distance_tpu_torch.ops.plan import plan_to_torch  # noqa: E402
from distance_tpu_torch.parallel import mesh  # noqa: E402

CPU = torch.device("cpu")
MEASURES = ["n", "n_high", "raw", "jc69", "k80", "tn93"]

# Counters of the form's rows (FORMS order) whose estimates are NaN or
# inf: all zero (0 / 0), jc69's p = 0.75 (1 - 4/3 p rounded once is
# -2^-25: NaN), k80's p = 1 (a log of -1) and p = 0.5 (a log of 0), and
# tn93's kk = 0.
EDGES = {
    "n": [(0,)],
    "n_high": [(0,)],
    "raw": [(0, 0), (3, 1)],
    "jc69": [(0, 0), (3, 1)],
    "k80": [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 1)],
    "tn93": [(0, 0), (0, 5), (4, 4)],
}


def counters_with_edges(measure: str, m: int, n: int,
                        seed: int) -> np.ndarray:
    """(G, m, n) int32 plan counters: small and large counts, the first
    cells set to the measure's ``EDGES``."""
    g = len(get_plan(measure).counters)
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 5, size=(g, m, n))
    large = rng.integers(0, 30000, size=(g, m, n))
    c = np.where(rng.random((1, m, n)) < 0.5, small, large).astype(np.int32)
    _, rows, _ = estimate_ops._layout(measure)
    flat = c.reshape(g, -1)
    for cell, values in enumerate(EDGES[measure]):
        for row, value in zip(rows, values):
            flat[row, cell] = value
    return c


def split(total: np.ndarray, sp: int, rng) -> list:
    """``sp`` int32 partials whose sum is ``total``."""
    left = total.astype(np.int64)
    parts = []
    for _ in range(sp - 1):
        part = rng.integers(0, left + 1)
        parts.append(part.astype(np.int32))
        left = left - part
    parts.append(left.astype(np.int32))
    return [torch.from_numpy(p) for p in parts]


def assert_bit_equal(got: torch.Tensor, want: torch.Tensor) -> None:
    nan = want.isnan()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


@pytest.mark.parametrize("col0", [0, 1, 5])
@pytest.mark.parametrize("sp", [1, 2, 3, 4])
@pytest.mark.parametrize("measure", MEASURES)
def test_partials_estimate_equals_estimate_of_their_sum(measure, sp, col0):
    """Into a window at col0 of an output wider by 7 columns (or a new
    output at col0 = 0), every cell of the window equals the summed
    counters' estimate, every other cell is left as it was; a tn93
    partial may hold just the rows its form reads."""
    m, n = 9, 13
    total = counters_with_edges(measure, m, n, seed=sp * 10 + col0)
    parts = split(total, sp, np.random.default_rng(col0 + sp))
    if measure == "tn93" and sp > 1:
        parts[1] = estimate_ops.form_rows(parts[1], measure)
        assert parts[1].shape[0] == 2
    want = estimate_ops.estimate_torch(torch.from_numpy(total), measure)
    if measure != "n" and measure != "n_high":
        assert want.isnan().any()
    if measure in ("jc69", "k80"):
        assert want.isnan().flatten()[1] or want.isinf().flatten()[2]
    if col0 == 0:
        assert_bit_equal(estimate_ops.estimate_partials(parts, measure), want)
    sentinel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (m, n + 7)).astype(np.float32))
    out = sentinel.clone()
    got = estimate_ops.estimate_partials_torch(parts, measure, out, col0)
    assert got is out
    assert_bit_equal(out[:, col0 : col0 + n], want)
    outside = torch.ones_like(out, dtype=torch.bool)
    outside[:, col0 : col0 + n] = False
    assert torch.equal(out[outside], sentinel[outside])


def test_edges_fall_where_jax_puts_them():
    """jc69's p = 0.75 is NaN (XLA's fused 1 - 4/3 p), k80's p = 0.5 is
    +inf and p = 1 NaN, 0 / 0 NaN, tn93's same > 0 = kk ... as the JAX
    expression gives them."""
    def est(measure, values):
        c = np.zeros((len(get_plan(measure).counters), 1, 1), np.int32)
        for row, value in zip(estimate_ops._layout(measure)[1], values):
            c[row, 0, 0] = value
        return float(estimate_ops.estimate_partials_torch(
            [torch.from_numpy(c)], measure)[0, 0])

    assert np.isnan(est("raw", (0, 0)))
    assert np.isnan(est("jc69", (3, 1)))
    assert np.isnan(est("k80", (0, 1, 0)))
    assert np.isposinf(est("k80", (1, 1, 0)))
    assert np.isneginf(est("tn93", (0, 5)))
    assert est("tn93", (4, 4)) == 0.0


def _part(g=2, m=3, n=4, dtype=torch.int32, device="cpu"):
    return torch.zeros((g, m, n), dtype=dtype, device=device)


# One case each of what K8's wrappers refuse: (partials, measure, out,
# col0, the message).
BAD = {
    "no partials": (lambda: [], "raw", None, 0, "0 partials"),
    "more than SP_MAX": (lambda: [_part()] * 9, "raw", None, 0,
                         "9 partials"),
    "dtype": (lambda: [_part(dtype=torch.int64)], "raw", None, 0, "int32"),
    "plan rows": (lambda: [_part(g=3)], "raw", None, 0, "int32"),
    "tn93 rows": (lambda: [_part(g=3)], "tn93", None, 0, "int32"),
    "two dims": (lambda: [torch.zeros((3, 4), dtype=torch.int32)], "n",
                 None, 0, "int32"),
    "cells differ": (lambda: [_part(), _part(n=5)], "raw", None, 0,
                     "cells"),
    "a partial on another device": (
        lambda: [_part(), _part(device="meta")], "raw", None, 0,
        "partials on"),
    "unknown measure": (lambda: [_part()], "p-distance", None, 0,
                        "unknown measure"),
    "a window without an output": (lambda: [_part()], "raw", None, 1,
                                   "needs an output"),
    "output dtype": (lambda: [_part()], "raw",
                     torch.zeros((3, 4), dtype=torch.float64), 0, "float32"),
    "output rows": (lambda: [_part()], "raw", torch.zeros((2, 4)), 0,
                    "float32"),
    "output strided": (lambda: [_part()], "raw", torch.zeros((4, 3)).t(), 0,
                       "contiguous"),
    "window past ld": (lambda: [_part()], "raw", torch.zeros((3, 6)), 3,
                       "past ld"),
    "negative col0": (lambda: [_part()], "raw", torch.zeros((3, 6)), -1,
                      "past ld"),
    "output on another device": (
        lambda: [_part()], "raw", torch.zeros((3, 4), device="meta"), 0,
        "output on"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_partials_arguments_are_checked(case):
    make, measure, out, col0, match = BAD[case]
    with pytest.raises(ValueError, match=match):
        estimate_ops.estimate_partials_torch(make(), measure, out, col0)
    with pytest.raises(ValueError, match=match if case == "no partials"
                       else "CUDA"):
        estimate_ops.estimate_partials_cuda(make(), measure, out, col0)


def test_empty_blocks():
    for shape in ((2, 0, 4), (2, 3, 0)):
        got = estimate_ops.estimate_partials([torch.zeros(
            shape, dtype=torch.int32)] * 2, "raw")
        assert got.shape == shape[1:] and got.dtype == torch.float32


@pytest.mark.parametrize("measure", MEASURES)
def test_form_rows(measure):
    c = torch.from_numpy(counters_with_edges(measure, 5, 6, seed=3))
    rows = estimate_ops.form_rows(c, measure)
    idx = estimate_ops._layout(measure)[1]
    assert torch.equal(rows, c[list(idx)])
    assert (rows is c) == (idx == tuple(range(c.shape[0])))
    assert torch.equal(estimate_ops.form_rows(c, measure, CPU), rows)


@pytest.mark.parametrize("dp, sp", [(1, 1), (1, 2), (2, 2), (3, 1), (1, 3)])
@pytest.mark.parametrize("measure", MEASURES)
def test_sharded_step_builds_no_total(measure, dp, sp, monkeypatch):
    """With ``sharded_counters`` made to raise, the step on a (dp, sp) grid
    of CPU devices still gives the plain counters' estimate, NaN cells
    and all: it sums the partials itself, a row's y window at a time."""
    x, y = dryrun._example_data(m=12, n=8 * dp, width=200 * sp, seed=dp + sp)

    def refuse(*args, **kwargs):
        raise AssertionError("sharded_step built the (G, m, n) total")

    want = estimate_ops.estimate_torch(
        counters_torch(torch.from_numpy(x), torch.from_numpy(y),
                       plan_to_torch(get_plan(measure), CPU)), measure)
    monkeypatch.setattr(mesh, "sharded_counters", refuse)
    grid = mesh.make_mesh([CPU] * (dp * sp), sp=sp)
    for backend in mesh.BACKENDS:
        got = mesh.sharded_step(measure, grid, backend)(x, y)
        assert_bit_equal(got, want)


def test_sharded_step_without_sites():
    """Width 0: no device has sites; every counter is 0, so the estimate
    is 0 / 0 (NaN) for raw."""
    grid = mesh.make_mesh([CPU] * 2, sp=2)
    x = np.zeros((3, 0), np.uint8)
    y = np.zeros((4, 0), np.uint8)
    got = mesh.sharded_step("raw", grid)(x, y)
    assert got.shape == (3, 4) and got.isnan().all()
