"""The port's cached-feature counter path against the JAX package's.

The plain versions of K5 (``features_torch``) and K6 (``contract_torch``)
equal ``features_device``, ``contract_features`` and ``counters_xla`` of
``distance_tpu`` exactly (every counter is an integer), on inputs made
from a numpy seed.  The port's square and rectangle with the cache
engaged, in core and out of core at small budgets, write the bytes of
``distance --backend numpy``; engine counters show which path ran.  With
the cache off (``DISTANCE_TPU_FEATCACHE_BUDGET=0``) or too small, the
bytes are the same through K1's plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distance_tpu import engine as jax_engine  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu.ops import features as jax_features  # noqa: E402
from distance_tpu.ops import pairwise_xla  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.encoding import ALL_CODES  # noqa: E402
from distance_tpu_torch.ops import cached  # noqa: E402
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
from distance_tpu_torch.ops.plan import cached_plan_to_torch  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402
from tests.test_torch_outofcore import (  # noqa: E402
    jax_numpy_tsv,
    lower_budgets,
    port_tsv,
)
from tests.test_torch_rect_stream import write  # noqa: E402

CPU = torch.device("cpu")
CODES = np.concatenate([[0], ALL_CODES]).astype(np.uint8)
# Ragged small shapes (x rows, y rows, sites).
SHAPES = [(1, 1, 1), (7, 5, 45), (13, 31, 130), (0, 4, 16), (3, 0, 16)]


@pytest.fixture(autouse=True)
def _no_jit_cache(monkeypatch):
    # the JAX CLI would otherwise keep a compilation cache under $HOME
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")
    monkeypatch.delenv("DISTANCE_TPU_FEATCACHE_BUDGET", raising=False)


def codes(rng, rows, width):
    return rng.choice(CODES, size=(rows, width)).astype(np.uint8)


@pytest.mark.parametrize("side", ["f", "g"])
@pytest.mark.parametrize("measure", MEASURES)
def test_features_equal_jax_features_device(measure, side):
    """Code 0 and every Paradis code at every site offset, and a random
    ragged matrix."""
    rng = np.random.default_rng(71)
    jplan = jax_features.get_plan(measure)
    plan = cached_plan_to_torch(get_plan(measure), CPU)
    truth = np.stack([np.roll(CODES, s) for s in range(CODES.size)])
    for c in (truth, codes(rng, 9, 37)):
        want = np.asarray(jax_features.features_device(
            jnp.asarray(c), jplan, side, jnp, jnp.int8))
        got = cached.features(torch.from_numpy(c), plan, side)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("measure", MEASURES)
def test_contract_equals_jax_contract_features(measure):
    """contract_torch == contract_features, and counters_cached ==
    counters_xla == the JAX engine's numpy counters, exactly."""
    rng = np.random.default_rng(72)
    jplan = jax_features.get_plan(measure)
    plan = cached_plan_to_torch(get_plan(measure), CPU)
    g = len(jplan.counters)
    for m, n, width in SHAPES:
        x, y = codes(rng, m, width), codes(rng, n, width)
        fx = cached.features(torch.from_numpy(x), plan, "f")
        gy = cached.features(torch.from_numpy(y), plan, "g")
        got = cached.contract(fx, gy, plan)
        assert got.dtype == torch.int32 and got.shape == (g, m, n)
        want = np.asarray(pairwise_xla.contract_features(
            jnp.asarray(fx.numpy()), jnp.asarray(gy.numpy()), jplan))
        np.testing.assert_array_equal(got.numpy(), want)
        both = cached.counters_cached(torch.from_numpy(x),
                                      torch.from_numpy(y), plan).numpy()
        np.testing.assert_array_equal(both, want)
        if m and n:
            np.testing.assert_array_equal(both, np.asarray(
                pairwise_xla.counters_xla(jnp.asarray(x), jnp.asarray(y),
                                          jplan)))
            np.testing.assert_array_equal(
                both, jax_engine._counters_numpy(x, y, jplan))


def test_contract_reads_cache_slices():
    """A strip of an f cache against a block of a g cache, both strided
    views, as the engine slices them."""
    rng = np.random.default_rng(73)
    plan = cached_plan_to_torch(get_plan("tn93"), CPU)
    c = torch.from_numpy(codes(rng, 60, 50))
    fcache, gcache = (cached.features(c, plan, s) for s in ("f", "g"))
    got = cached.contract(fcache[:, 8:24], gcache[:, 32:48], plan)
    want = cached.counters_cached(c[8:24], c[32:48], plan)
    assert torch.equal(got, want)


def test_cached_wrappers_refuse_what_they_do_not_take():
    plan = cached_plan_to_torch(get_plan("raw"), CPU)
    c = torch.zeros((4, 16), dtype=torch.uint8)
    fx = cached.features(c, plan, "f")
    with pytest.raises(ValueError, match="side"):
        cached.features(c, plan, "h")
    with pytest.raises(ValueError, match="uint8"):
        cached.features(c.to(torch.int32), plan, "f")
    with pytest.raises(ValueError, match="channels"):
        cached.contract(fx[:5], fx[:5], plan)
    with pytest.raises(ValueError, match="widths"):
        cached.contract(fx, fx[:, :, :8], plan)
    with pytest.raises(ValueError, match="CUDA"):
        cached.contract_cuda(fx, fx, plan)
    with pytest.raises(ValueError, match="CUDA"):
        cached.features_cuda(c, plan, "f")


@pytest.fixture(scope="module")
def fastas():
    rng = np.random.default_rng(74)
    return {
        "square": make_fasta(random_seqs(rng, 40, 90, amb_frac=0.2)),
        "file1": make_fasta(random_seqs(rng, 37, 90, amb_frac=0.2)),
        "file2": make_fasta(random_seqs(rng, 23, 90, amb_frac=0.2)),
    }


def args_of(tmp_path, fastas, mode, measure):
    files = ([fastas["square"]] if mode == "square"
             else [fastas["file1"], fastas["file2"]])
    return write(tmp_path, *files) + ["-m", measure]


class Counts:
    """The engine's launch accounting of one run, from zero."""

    NAMES = ("K1_BLOCKS", "BASELINES", "K6_BLOCKS", "K6_BASELINES")

    def __init__(self, monkeypatch):
        for name in self.NAMES:
            monkeypatch.setattr(port_engine, name, 0)
        monkeypatch.setattr(port_engine, "FEATURE_BUILDS",
                            dict.fromkeys(port_engine.FEATURE_BUILDS, 0))

    def __getattr__(self, name):
        if name == "builds":
            return port_engine.FEATURE_BUILDS
        return getattr(port_engine, name.upper())


def cache_every_measure(monkeypatch):
    monkeypatch.setattr(port_engine, "CACHED_MEASURES", frozenset(MEASURES))


@pytest.mark.parametrize("mode", ["square", "rectangle"])
@pytest.mark.parametrize("measure", MEASURES)
def test_cached_sweep_in_core_equals_numpy(tmp_path, monkeypatch, fastas,
                                           measure, mode):
    """Every block and baseline through K6, no K1: the g cache built once
    on the column side, a strip's f features once, the reference row's
    f and g features once."""
    args = args_of(tmp_path, fastas, mode, measure)
    want = jax_numpy_tsv(tmp_path, args)
    cache_every_measure(monkeypatch)
    monkeypatch.setattr(port_engine, "TILE_I", 16)
    monkeypatch.setattr(port_engine, "TILE_J", 8)
    n = Counts(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    strips = -(-(39 if mode == "square" else 37) // 16)
    assert n.k6_blocks >= strips and n.k1_blocks == 0
    assert n.baselines == n.k6_baselines
    assert n.builds == {"g": 1, "f": 0, "strip": strips, "ref": 2,
                        "group": 0}
    # a row baseline a strip, the column side's, and the self-counter
    assert n.k6_baselines == strips + 2


@pytest.mark.parametrize("mode", ["square", "rectangle"])
@pytest.mark.parametrize("measure", MEASURES)
def test_cached_sweep_out_of_core_equals_numpy(tmp_path, monkeypatch, fastas,
                                               measure, mode):
    """Out of core at small budgets: each X group with its f cache, each
    super-row with its g cache, every block through K6."""
    args = args_of(tmp_path, fastas, mode, measure)
    want = jax_numpy_tsv(tmp_path, args)
    cache_every_measure(monkeypatch)
    lower_budgets(monkeypatch, mode)
    # room for the caches beside the floor layout's rel4 sidecars (3.8 MB
    # at these tiles), below the in-core footprint (5.5-9.2 MB)
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET", 4_000_000)
    n = Counts(monkeypatch)
    blocked, spans = [], []
    real = port_engine._sweep_blocked
    monkeypatch.setattr(port_engine, "_sweep_blocked",
                        lambda *a: blocked.append(1) or real(*a))
    real_get = port_engine._StagedSide.get
    monkeypatch.setattr(port_engine._StagedSide, "get",
                        lambda side, q0, q1: spans.append((q0, q1))
                        or real_get(side, q0, q1))
    assert port_tsv(tmp_path, args) == want
    assert blocked and len(set(spans)) >= 2
    assert n.k6_blocks > 0 and n.k1_blocks == 0
    assert n.builds["f"] >= 1 and n.builds["g"] >= 2
    assert n.builds["strip"] == 0 and n.builds["ref"] == 2
    # a row baseline an X group (over its f cache), a column baseline a
    # super-row (kept when it is staged again), and the self-counter
    assert n.baselines == n.k6_baselines == (
        n.builds["f"] + len(set(spans)) + 1)


@pytest.mark.parametrize("budget", ["0", "3000"])
@pytest.mark.parametrize("mode", ["square", "rectangle"])
@pytest.mark.parametrize("measure", ["k80", "tn93", "raw"])
def test_cache_off_or_too_small_takes_k1(tmp_path, monkeypatch, fastas,
                                         measure, mode, budget):
    """DISTANCE_TPU_FEATCACHE_BUDGET=0 turns the cache off, and a budget
    smaller than the column side's features does not engage it: the same
    bytes through K1, no feature built."""
    args = args_of(tmp_path, fastas, mode, measure)
    want = jax_numpy_tsv(tmp_path, args)
    cache_every_measure(monkeypatch)
    monkeypatch.setenv("DISTANCE_TPU_FEATCACHE_BUDGET", budget)
    n = Counts(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    assert n.k1_blocks > 0 and n.k6_blocks == n.k6_baselines == 0
    assert n.baselines > 0 and sum(n.builds.values()) == 0


@pytest.mark.parametrize("measure", MEASURES)
def test_measures_outside_the_set_take_k1(tmp_path, monkeypatch, fastas,
                                          measure):
    """The engine's measure set decides: a measure in it takes K6, any
    other K1, with the same bytes."""
    args = args_of(tmp_path, fastas, "square", measure)
    n = Counts(monkeypatch)
    port_tsv(tmp_path, args)
    if measure in port_engine.CACHED_MEASURES:
        assert n.k6_blocks > 0 and n.k1_blocks == 0
    else:
        assert n.k1_blocks > 0 and n.k6_blocks == 0


@pytest.mark.parametrize("measure, crossover", [("raw", 65536),
                                                ("tn93", 32768)])
def test_cache_never_moves_the_in_core_crossover(monkeypatch, measure,
                                                 crossover):
    """At 29904 sites and 8192-row tiles on an H100 80GB HBM3's auto
    budget, the cache engages where it fits beside the in-core sweep and
    not at the crossover, which stays where the footprint without a
    cache puts it."""
    monkeypatch.setattr(port_engine, "CACHED_MEASURES", frozenset(MEASURES))
    budget = 84_465_090_560 // 2
    plan = get_plan(measure)
    g = len(plan.counters)

    def fits(n):
        rows = port_engine._padded_shape(n, 29904, 8192, 8192)[0]
        fp = port_engine._blocked_footprint(0, rows, 29904, g, 8192, 8192)
        return fp <= budget, port_engine._cache_fits(
            plan, rows, 29904, 8192, 8192, fp, budget)

    assert fits(8192) == (True, True)
    assert fits(crossover) == (True, False)
    assert fits(crossover + 1)[0] is False


def test_footprint_counts_an_engaged_cache(tmp_path, monkeypatch, fastas):
    """A device budget of the sweep's footprint keeps it in core without
    the cache; with the cache's bytes on top it engages."""
    args = args_of(tmp_path, fastas, "square", "tn93")
    want = jax_numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "TILE_I", 16)
    monkeypatch.setattr(port_engine, "TILE_J", 16)
    seen = []
    real = port_engine._cache_fits

    def spy(plan, rows, width, ti, tj, footprint, budget):
        seen.append((footprint, port_engine._cache_bytes(plan, rows, width,
                                                         ti, tj)))
        return real(plan, rows, width, ti, tj, footprint, budget)

    monkeypatch.setattr(port_engine, "_cache_fits", spy)
    port_tsv(tmp_path, args)
    footprint, extra = seen[0]
    l_pad = 128
    assert extra >= get_plan("tn93").total_channels * 48 * l_pad
    for budget, cached_path in ((footprint, False),
                                (footprint + extra, True)):
        monkeypatch.setattr(port_engine, "DEVICE_BUDGET", budget)
        n = Counts(monkeypatch)
        assert port_tsv(tmp_path, args, f"{budget}.tsv") == want
        assert (n.k6_blocks > 0) == cached_path
        assert (n.k1_blocks > 0) != cached_path


def test_out_of_core_layout_counts_the_caches():
    """With the cache, an X row costs its R features too and a super-row
    keeps its g cache within FEATCACHE_BUDGET: the layout's footprint,
    caches included, stays within the device budget."""
    plan = get_plan("tn93")
    width, ti, tj, budget, n = 29904, 1024, 1024, 2 << 30, 20_000
    g = len(plan.counters)
    base = port_engine._blocked_layout(n, n, width, g, ti, tj, budget)
    group, rows = port_engine._blocked_layout(n, n, width, g, ti, tj, budget,
                                              plan)
    assert group < base[0] and rows < base[1] and rows % tj == 0
    l_pad = port_engine._padded_shape(1, width, 1, 1)[1]
    pad = max(ti, tj)
    assert plan.total_channels * (rows + pad) * l_pad <= (
        port_engine.FEATCACHE_BUDGET)
    x_rows = port_engine._x_cache_rows(plan, group, width, ti)
    assert x_rows > 0
    kept = n + -(-n // tj) * pad
    fp = (port_engine._blocked_footprint(group, rows + pad, width, g, ti, tj,
                                         kept)
          + port_engine._cache_bytes(plan, x_rows + rows + pad, width, ti,
                                     tj))
    assert fp == port_engine._layout_footprint(group, rows, n, width, g, ti,
                                               tj, plan) <= budget
