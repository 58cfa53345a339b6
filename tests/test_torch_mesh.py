"""The port's (dp, sp) device grid (``distance_tpu_torch/parallel/mesh.py``)
against the JAX ``sharded_counters_fn`` on its 8-device CPU mesh, and
K2's windowed rel4 pack (each part of a split block packed as a window
of it) with the merge of its parts' sidecars against the whole block's
pack.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from distance_tpu.ops.packing import pack_device_rel4  # noqa: E402
from distance_tpu.parallel import mesh as jax_mesh  # noqa: E402
from distance_tpu_torch.ops import packing  # noqa: E402
from distance_tpu_torch.ops.counters import counters_torch  # noqa: E402
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
from distance_tpu_torch.ops.plan import plan_to_torch  # noqa: E402
from distance_tpu_torch.parallel import mesh  # noqa: E402
from tests.conftest import random_seqs  # noqa: E402
from tests.test_parallel import encode_padded  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("backend", ["cached", "k1"])
@pytest.mark.parametrize("measure", ["n_high", "raw", "k80", "tn93"])
def test_sharded_counters_equal_jax(measure, backend):
    """``tests/test_parallel.py::test_sharded_counters_exact``'s inputs on
    a (4, 2) grid of 8 CPU devices equal the JAX function on
    ``make_mesh(8, sp=2)``, and the one-device counters."""
    assert jax.device_count() == 8
    rng = np.random.default_rng(5)
    x = encode_padded(random_seqs(rng, 14, 250, amb_frac=0.25), 16, 256)
    y = encode_padded(random_seqs(rng, 15, 250, amb_frac=0.25), 16, 256)
    jm = jax_mesh.make_mesh(8, sp=2)
    want = np.asarray(jax_mesh.sharded_counters_fn(measure, jm)(
        jax.device_put(x, NamedSharding(jm, P(None, "sp"))),
        jax.device_put(y, NamedSharding(jm, P("dp", "sp")))))
    grid = mesh.make_mesh([CPU] * 8, sp=2)
    assert [len(row) for row in grid] == [2] * 4
    got = mesh.sharded_counters(x, y, get_plan(measure), grid, backend)
    np.testing.assert_array_equal(got.numpy(), want)
    plan = plan_to_torch(get_plan(measure), CPU)
    np.testing.assert_array_equal(got.numpy(), counters_torch(
        torch.from_numpy(x), torch.from_numpy(y), plan).numpy())


@pytest.mark.parametrize("width, sp", [(256, 2), (300, 2), (100, 4),
                                       (29904, 3)])
def test_site_shards_cover_the_sites_in_units(width, sp):
    shards = mesh.site_shards(width, sp)
    assert len(shards) == sp and shards[0][0] == 0 and shards[-1][1] == width
    for (a, b), (c, _) in zip(shards, shards[1:]):
        assert b == c and ((b - a) % mesh.SITE_UNIT == 0 or b == width)


def test_sharded_counters_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="sp 3"):
        mesh.make_mesh([CPU] * 8, sp=3)
    x = np.zeros((4, 128), dtype=np.uint8)
    with pytest.raises(ValueError, match="dp 4"):
        mesh.sharded_counters(x, np.zeros((6, 128), dtype=np.uint8),
                              get_plan("raw"), mesh.make_mesh([CPU] * 8, 2))
    with pytest.raises(ValueError, match="backend"):
        mesh.sharded_counters(x, x, get_plan("raw"), [[CPU]], "pallas")


def window_case(rng, g, m, n, w):
    """Residuals in [-7, 7] with outliers: segments holding two or three
    (a segment's first and last cell, or three at random), and where a
    segment straddles a boundary of the parts of width ``w``, the cells on
    either side of it (the segment's first and last outliers in two
    parts); and whether one does."""
    c = rng.integers(-7, 8, size=(g, m, n)).astype(np.int32)
    flat = c.reshape(-1)
    seg = -(-flat.size // packing.REL4_SEGMENTS)
    for s in range(0, min(packing.REL4_SEGMENTS, -(-flat.size // seg)), 3):
        lo, hi = s * seg, min((s + 1) * seg, flat.size)
        cells = {lo, hi - 1} if s % 2 else set(
            rng.choice(np.arange(lo, hi), size=min(3, hi - lo),
                       replace=False))
        for cell in cells:
            flat[cell] = rng.choice([-8, 8, 100, -300])
    straddled = False
    for b in range(w, n, w):
        for f in range(flat.size - n + b - 1, 0, -n):
            if f // seg == (f + 1) // seg:
                flat[f : f + 2] = 50
                straddled = True
                break
    rb = rng.integers(-3, 4, (g, m)).astype(np.int32)
    cb = rng.integers(-3, 4, (g, n)).astype(np.int32)
    cc = rng.integers(-3, 4, g).astype(np.int32)
    return (c + rb[:, :, None] + cb[:, None, :] - cc[:, None, None], rb, cb,
            cc, straddled)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("g, m, n", [(1, 8, 16), (4, 33, 64), (2, 100, 24),
                                     (4, 64, 2048), (3, 2048, 40),
                                     (1, 100, 200)])
def test_windowed_rel4_parts_merge_into_the_whole_block(g, m, n, k):
    """Each part of a block split over k devices packed as a window of it
    (its first column and the block's width), the parts' lanes joined and
    their sidecars merged: the whole block's plain pack and the JAX
    ``pack_device_rel4``, with segments whose first and last outliers
    fall in different parts."""
    rng = np.random.default_rng(g * 1000 + m + n + k)
    w = n // k
    c, rb, cb, cc, straddled = window_case(rng, g, m, n, w)
    t = torch.from_numpy
    whole = packing.pack_rel4_torch(t(c), t(rb), t(cb), t(cc))
    want = pack_device_rel4(c, rb, cb, cc, np)
    for a, b in zip(whole, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    parts = [packing.pack_rel4(t(c[:, :, d * w:(d + 1) * w].copy()), t(rb),
                               t(cb[:, d * w:(d + 1) * w].copy()), t(cc),
                               col0=d * w, n_whole=n)
             for d in range(k)]
    lanes = torch.cat([p[0] for p in parts], dim=-1)
    idx, val = packing.merge_rel4_sidecars(
        torch.stack([p[1] for p in parts]), torch.stack([p[2] for p in parts]))
    np.testing.assert_array_equal(lanes.numpy(), whole[0].numpy())
    np.testing.assert_array_equal(idx.numpy(), whole[1].numpy())
    np.testing.assert_array_equal(val.numpy(), whole[2].numpy())
    if straddled:
        # some segment's first and last outliers lie in different parts
        first, last = whole[1][: packing.REL4_SEGMENTS], whole[1][
            packing.REL4_SEGMENTS:]
        both = (first >= 0) & (last >= 0)
        assert ((first[both] % n) // w != (last[both] % n) // w).any()


def test_windows_refuse_what_is_no_window():
    c = torch.zeros((1, 4, 8), dtype=torch.int32)
    rb, cb, cc = (torch.zeros((1, 4), dtype=torch.int32),
                  torch.zeros((1, 8), dtype=torch.int32),
                  torch.zeros(1, dtype=torch.int32))
    for col0, n_whole in ((-2, 16), (10, 16), (0, 6)):
        with pytest.raises(ValueError, match="window"):
            packing.pack_rel4(c, rb, cb, cc, col0=col0, n_whole=n_whole)
