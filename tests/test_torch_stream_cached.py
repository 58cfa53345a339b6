"""The port's stream in its cached-feature form against the JAX package's.

The JAX engine's default stream (``_jit_stream_fn`` with the ``xla``
backend) counts each group with ``counters_xla``: the f features of the
loaded rows and the g features of the group, then their contraction, and
the rel baselines the same way against the reference row.  The port
builds the loaded rows' f cache once (K5), each group's g features once
(K5), and contracts them with K6; on the CPU through their plain
versions.  On inputs made from a numpy seed the counters, the baselines
and the packed lanes equal the JAX function's exactly, and whole runs (in
core, staged, sharded and merged, across a retarget) write the bytes of
``distance --backend numpy``.  A stream whose caches do not fit takes K1,
decided before any launch, and the caches never move the group size or
the choice between in core and staged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distance_tpu import engine as jax_engine  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu.ops import features as jax_features  # noqa: E402
from distance_tpu.ops import pairwise_xla  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.encoding import ALL_CODES  # noqa: E402
from distance_tpu_torch.ops import packing  # noqa: E402
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402
from tests.test_torch_cuda import staged_stream_budget  # noqa: E402
from tests.test_torch_diffup import lineage  # noqa: E402
from tests.test_torch_featcache import Counts  # noqa: E402
from tests.test_torch_outofcore import jax_numpy_tsv, port_tsv  # noqa: E402
from tests.test_torch_rect_stream import write  # noqa: E402

CPU = torch.device("cpu")
# (loaded rows, group rows, real sites) of the group checks; the JAX
# function sweeps the loaded rows in strips of JAX_TI
N1, BN, WIDTH = 40, 26, 300
L_PAD = 384
JAX_TI = 8
# 33 loaded records against 41 streamed ones in batches of 5: groups of
# at most 10 records (GROUP_SIZES), of which 10 is even (rel4) and 1 odd
N_LOADED, N_STREAMED, BATCH, GROUP = 33, 41, 5, 10
GROUP_SIZES = [10, 10, 10, 10, 1]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # the JAX CLI would otherwise keep a compilation cache under $HOME
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")
    for name in ("DISTANCE_TPU_FEATCACHE_BUDGET", "DISTANCE_TPU_STREAM_GROUP",
                 "DISTANCE_TPU_HBM_BUDGET", "DISTANCE_TPU_NO_REL_PACK",
                 "DISTANCE_TPU_NO_DIFF_UPLOAD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(port_engine, "CACHED_MEASURES", frozenset(MEASURES))


def group_inputs(seed):
    """(loaded codes, group codes), padded to L_PAD sites: a low-diversity
    set around one ancestor, so that rel4 holds most residuals, with
    ambiguity codes and a few outliers."""
    rng = np.random.default_rng(seed)
    anc = rng.choice(ALL_CODES[:4], size=WIDTH).astype(np.uint8)
    mat = np.repeat(anc[None], N1 + BN, axis=0)
    hits = rng.random(mat.shape) < 0.02
    mat[hits] = rng.choice(ALL_CODES, size=int(hits.sum()))
    mat[3, :40] = rng.choice(ALL_CODES, size=40)  # an outlier row
    padded = np.zeros((N1 + BN, L_PAD), dtype=np.uint8)
    padded[:, :WIDTH] = mat
    return padded[:N1], padded[N1:]


def cached_group(measure, loaded, rel):
    """An engine with the loaded rows prepared with their f cache."""
    eng = port_engine._BlockEngine(measure, [CPU], 1, WIDTH, rel=rel,
                                   tj=BN)
    m1 = eng.prepare(loaded[:, :WIDTH], 1, cache_f=True,
                     diff_ref=loaded[0, :WIDTH] if rel else None)
    return eng, m1


@pytest.mark.parametrize("measure", MEASURES)
def test_group_counters_equal_jax_stream_fn(monkeypatch, measure):
    """One group's int32 counters ("none") through the port's cached
    dispatch equal the JAX ``_jit_stream_fn`` in its xla form, which
    sweeps the loaded rows in strips of JAX_TI through ``lax.map``."""
    loaded, group = group_inputs(81)
    n = Counts(monkeypatch)
    eng, m1 = cached_group(measure, loaded, rel=False)
    codes = torch.from_numpy(group)
    eng.cache_group(codes, m1)
    strip = port_engine._Strip(eng, m1, codes, 0, [0], N1, BN, (N1, BN))
    got = strip("none").numpy()
    eng.drop_group(codes)
    fn = jax_engine._jit_stream_fn(measure, "xla", JAX_TI, BN, N1, "none",
                                   WIDTH, L_PAD, None, False)
    want = np.asarray(fn(jnp.asarray(loaded), jnp.asarray(group)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (n.k6_blocks, n.k1_blocks, n.baselines) == (1, 0, 0)
    assert n.builds == {"g": 0, "f": 1, "strip": 0, "ref": 0, "group": 1}
    # the group's features went with the dispatch; its counters stay
    assert eng.gfeat_of(codes) is None
    np.testing.assert_array_equal(strip("wide"), packing.pack_wide_torch(
        measure, torch.from_numpy(want)).numpy())


@pytest.mark.parametrize("measure", MEASURES)
def test_group_rel4_and_baselines_equal_jax_stream_fn(monkeypatch, measure):
    """At rel4 against a reference row: the lanes and the sidecar bundle
    equal the JAX function's, and rb, cb and cc equal ``counters_xla`` of
    (loaded, ref), (ref, group) and (ref, ref), all through K6."""
    loaded, group = group_inputs(82)
    n = Counts(monkeypatch)
    eng, m1 = cached_group(measure, loaded, rel=True)
    ref = eng.rel_ref
    codes = torch.from_numpy(group)
    eng.cache_group(codes, m1)
    strip = port_engine._Strip(eng, m1, codes, 0, [0], N1, BN, (N1, BN),
                               None, ref)
    lanes, bundle = strip("rel4")
    eng.drop_group(codes)
    fn = jax_engine._jit_stream_fn(measure, "xla", JAX_TI, BN, N1, "rel4",
                                   WIDTH, L_PAD, None, False)
    jref = jnp.asarray(ref.numpy())
    jlanes, jbundle = fn(jnp.asarray(loaded), jref, jnp.asarray(group),
                         N1, BN)
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(jlanes))
    parts = packing.unbundle_sidecars(bundle.numpy())
    jparts = packing.unbundle_sidecars(np.asarray(jbundle))
    for got, want in zip(parts, jparts):
        np.testing.assert_array_equal(got.reshape(-1), want.reshape(-1))
    cb, rb_cc = parts[:2]
    plan = jax_features.get_plan(measure)
    r = jref[None]
    np.testing.assert_array_equal(rb_cc[:, :N1], np.asarray(
        pairwise_xla.counters_xla(jnp.asarray(loaded), r, plan))[:, :, 0])
    np.testing.assert_array_equal(cb, np.asarray(
        pairwise_xla.counters_xla(r, jnp.asarray(group), plan))[:, 0, :])
    np.testing.assert_array_equal(rb_cc[:, N1], np.asarray(
        pairwise_xla.counters_xla(r, r, plan))[:, 0, 0])
    # the block and the three baselines by K6, none by K1
    assert (n.k6_blocks, n.k6_baselines, n.baselines, n.k1_blocks) == (
        1, 3, 3, 0)
    assert n.builds == {"g": 0, "f": 1, "strip": 0, "ref": 2, "group": 1}


def test_stream_never_builds_the_loaded_sides_features_whole():
    """Without an f cache the loaded side's features are never built in
    one temporary (as ``fx_strip`` would for a strip), and a group is
    never given g features against it."""
    loaded, group = group_inputs(83)
    eng = port_engine._BlockEngine("raw", [CPU], 1, WIDTH, tj=BN)
    m1 = eng.prepare(loaded[:, :WIDTH], 1)
    codes = torch.from_numpy(group)
    with pytest.raises(ValueError, match="f cache"):
        eng.cache_group(codes, m1)
    with pytest.raises(ValueError, match="without an f cache"):
        eng.fx_strip(m1, 0, N1)


@pytest.fixture(scope="module")
def fastas():
    rng = np.random.default_rng(84)
    return (make_fasta(random_seqs(rng, N_LOADED, 90, amb_frac=0.2)),
            make_fasta(random_seqs(rng, N_STREAMED, 90, amb_frac=0.2)))


def stream_args(tmp_path, fastas, measure, batch=BATCH):
    loaded, streamed = write(tmp_path, *fastas)
    return [loaded, "-s", streamed, "-b", str(batch), "-m", measure]


def spy_groups(monkeypatch):
    """The records of each group the stream dispatches through a block."""
    bns = []
    real = port_engine._Strip.__init__

    def init(self, eng, m1, m2, *args, **kwargs):
        bns.append(m2.shape[0])
        real(self, eng, m1, m2, *args, **kwargs)

    monkeypatch.setattr(port_engine._Strip, "__init__", init)
    return bns


@pytest.mark.parametrize("measure", MEASURES)
def test_in_core_stream_equals_numpy_through_k6(tmp_path, monkeypatch,
                                                fastas, measure):
    """Every group one K6 block against the loaded f cache and one K5
    build; the baselines K6 too: the loaded rows' rb once (kept), each
    group's cb, and cc once.  K1 never launches."""
    args = stream_args(tmp_path, fastas, measure)
    want = jax_numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", GROUP)
    bns = spy_groups(monkeypatch)
    n = Counts(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    groups = len(GROUP_SIZES)
    assert bns == GROUP_SIZES
    assert n.k1_blocks == 0 and n.k6_blocks == groups
    assert n.baselines == n.k6_baselines == groups + 2
    assert n.builds == {"g": 0, "f": 1, "strip": 0, "ref": 2,
                        "group": groups}


@pytest.mark.parametrize("measure", ["raw", "tn93"])
def test_dense_stream_without_reference_row_takes_k6(tmp_path, monkeypatch,
                                                     fastas, measure):
    """Dense uploads and no reference row (narrow -> wide): the blocks
    through K6, no baseline, no reference features."""
    args = stream_args(tmp_path, fastas, measure)
    want = jax_numpy_tsv(tmp_path, args)
    monkeypatch.setenv("DISTANCE_TPU_NO_DIFF_UPLOAD", "1")
    monkeypatch.setenv("DISTANCE_TPU_NO_REL_PACK", "1")
    monkeypatch.setattr(port_engine, "STREAM_GROUP", GROUP)
    n = Counts(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    assert (n.k6_blocks, n.k1_blocks, n.baselines) == (len(GROUP_SIZES), 0,
                                                       0)
    assert n.builds == {"g": 0, "f": 1, "strip": 0, "ref": 0,
                        "group": len(GROUP_SIZES)}


@pytest.mark.parametrize("measure", MEASURES)
def test_staged_stream_equals_numpy_through_k6(tmp_path, monkeypatch, fastas,
                                               measure):
    """Staged with the caches: each super-row with its f cache built at
    each staging, each group's g features built once for every
    super-row, each part one K6 block; a super-row's rb once however
    often it is staged, each group's cb once, cc once."""
    args = stream_args(tmp_path, fastas, measure)
    want = jax_numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", GROUP)
    monkeypatch.setattr(port_engine, "TILE_I", 8)
    monkeypatch.setattr(port_engine, "PRUNE_MIN_FRACTION", 2.0)
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET", staged_stream_budget(
        measure, N_LOADED, GROUP, 90, 16, 8))
    spans, stagings = [], []
    real_get = port_engine._StagedSide.get

    def get(side, q0, q1):
        spans.append((q0, q1))
        stagings.append(side._key != (q0, q1))
        return real_get(side, q0, q1)

    monkeypatch.setattr(port_engine._StagedSide, "get", get)
    n = Counts(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    groups = len(GROUP_SIZES)
    assert sorted(set(spans)) == [(0, 16), (16, 32), (32, 33)]
    assert n.k1_blocks == 0 and n.k6_blocks == len(spans) == 3 * groups
    assert n.builds == {"g": 0, "f": sum(stagings), "strip": 0, "ref": 2,
                        "group": groups}
    assert n.baselines == n.k6_baselines == 3 + groups + 1


@pytest.mark.parametrize("measure", ["raw", "k80", "tn93"])
def test_sharded_stream_merges_to_numpy_through_k6(tmp_path, monkeypatch,
                                                   fastas, measure):
    """--shard 0/2 and 1/2 through K6, merged: the unsharded bytes."""
    args = stream_args(tmp_path, fastas, measure)
    want = jax_numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", GROUP)
    n = Counts(monkeypatch)
    parts = []
    for k in range(2):
        parts.append(str(tmp_path / f"p{k}"))
        assert port_cli.main([*args, "--backend", "torch", "--shard",
                              f"{k}/2", "-o", parts[-1]]) == 0
    merged = tmp_path / "merged.tsv"
    assert port_cli.main(["--merge", *parts, "-o", str(merged)]) == 0
    assert merged.read_bytes() == want
    assert n.k1_blocks == 0 and n.k6_blocks == len(GROUP_SIZES)
    assert n.builds["group"] == len(GROUP_SIZES) and n.builds["f"] == 2


@pytest.mark.parametrize("staged", [False, True])
def test_retargeted_stream_equals_numpy_through_k6(tmp_path, monkeypatch,
                                                   staged):
    """A stream of two lineages, neither the loaded one's, retargets the
    reference row at its first group and at the switch: each new row's f
    and g features are built, the loaded rows' rb (each super-row's,
    staged) and cc are taken again against it, and the bytes do not
    change."""
    rng = np.random.default_rng(85)
    width = 384
    ancs = [rng.choice(list("ACGT"), size=width) for _ in range(3)]
    f1 = make_fasta(lineage(rng, ancs[0], 20, "a", width))
    f2 = make_fasta(lineage(rng, ancs[1], 12, "b", width)
                    + lineage(rng, ancs[2], 12, "c", width))
    a, b = write(tmp_path, f1, f2)
    args = [a, "-s", b, "-b", "3", "-m", "n_high"]
    want = jax_numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 6)
    # every site on the device (no variant split), as the budget counts
    monkeypatch.setattr(port_engine, "PRUNE_MIN_FRACTION", 2.0)
    if staged:
        monkeypatch.setattr(port_engine, "TILE_I", 8)
        monkeypatch.setattr(port_engine, "DEVICE_BUDGET",
                            staged_stream_budget("n_high", 20, 6, width, 8,
                                                 8))
    n = Counts(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    assert n.k1_blocks == 0 and n.builds["ref"] == 4
    # two reference rows: a row baseline (staged: of each of the
    # super-rows of 8, 8 and 4 rows) and cc each, and a cb a group
    rows_bases = 3 if staged else 1
    assert n.baselines == n.k6_baselines == 2 * (rows_bases + 1) + 4


@pytest.mark.parametrize("measure", ["raw", "tn93"])
@pytest.mark.parametrize("why", ["budget zero", "half budget"])
def test_stream_takes_k1_when_the_caches_do_not_fit(tmp_path, monkeypatch,
                                                    fastas, measure, why):
    """DISTANCE_TPU_FEATCACHE_BUDGET=0, or a budget whose half is a row
    short of the loaded f cache: the same bytes through K1, no feature
    built, decided before any launch."""
    args = stream_args(tmp_path, fastas, measure)
    want = jax_numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", GROUP)
    if why == "budget zero":
        monkeypatch.setenv("DISTANCE_TPU_FEATCACHE_BUDGET", "0")
    else:
        r_l = get_plan(measure).total_channels * 128
        monkeypatch.setattr(port_engine, "FEATCACHE_BUDGET",
                            2 * r_l * (N_LOADED - 1))
    n = Counts(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    assert n.k1_blocks == len(GROUP_SIZES) and n.k6_blocks == 0
    assert n.k6_baselines == 0 and n.baselines == len(GROUP_SIZES) + 2
    assert sum(n.builds.values()) == 0


# The card of the footprint checks: an H100 80GB HBM3 as the engine sees
# it at process start (free, total bytes).
H100 = (84_465_090_560, 85_017_493_504)
CUDA = torch.device("cuda", 0)


def layouts(monkeypatch, n1, width, measure, sharded=False):
    """The stream layout with the caches on and off."""
    out = []
    for measures in (frozenset(MEASURES), frozenset()):
        monkeypatch.setattr(port_engine, "CACHED_MEASURES", measures)
        out.append(port_engine._stream_layout(n1, width, measure, CUDA, 2048,
                                              sharded))
    return out


@pytest.mark.parametrize("n1, width, measure, cached", [
    (2000, 29904, "raw", True),       # chip_smoke's stream
    (2000, 29904, "tn93", True),
    (8192, 29904, "raw", False),      # the f cache passes half the budget
    (8192, 29904, "tn93", True),
    (4_194_305, 64, "raw", False),    # the long loaded side: 9.66 GB
    (200_000, 29904, "tn93", False),  # in core: a 30 GB f cache
    (1_000_000, 29904, "tn93", True),  # staged: super-rows of 28672
])
@pytest.mark.parametrize("sharded", [False, True])
def test_caches_never_move_the_group_or_the_staging(monkeypatch, n1, width,
                                                    measure, cached,
                                                    sharded):
    """On an H100's auto budget the group size, the groups in flight and
    the choice between in core and staged are the same with the caches
    on and off; only ``cached`` and a staged super-row differ."""
    monkeypatch.setattr(port_engine, "_card_memory", lambda device: H100)
    monkeypatch.setattr(port_engine, "_strip_ram_budget",
                        lambda deterministic=False: 32 << 30)
    on, off = layouts(monkeypatch, n1, width, measure, sharded)
    assert (on.group, on.pending, on.sr_rows > 0) == (
        off.group, off.pending, off.sr_rows > 0)
    assert on.cached is cached and off.cached is False
    if not on.cached:
        assert on == off


@pytest.mark.parametrize("measure, n1, seen_want", [
    # in core, and staged with and without the caches (raw's f cache of
    # 60000 rows passes half of FEATCACHE_BUDGET in core)
    ("raw", 60000, {(False, False), (True, False), (True, True)}),
    # in core with and without the caches, and staged (a staged group's
    # g features pass what the loaded side leaves)
    ("tn93", 3000, {(False, False), (False, True), (True, False)}),
])
def test_caches_never_move_the_staging_at_any_budget(monkeypatch, measure,
                                                     n1, seen_want):
    """Over device budgets from a tenth to ten times the in-core
    footprint of a 29904-site stream, the caches change neither the
    group nor in core against staged."""
    width = 29904
    g = len(get_plan(measure).counters)
    fp = port_engine._stream_footprint(2048, n1, width, g, 4)
    seen = set()
    for budget in np.geomspace(fp / 10, fp * 10, 200).astype(np.int64):
        monkeypatch.setattr(port_engine, "DEVICE_BUDGET", int(budget))
        on, off = layouts(monkeypatch, n1, width, measure)
        assert (on.group, on.pending, on.sr_rows > 0) == (
            off.group, off.pending, off.sr_rows > 0)
        seen.add((on.sr_rows > 0, on.cached))
    # (staged, cached)
    assert seen == seen_want


def test_footprint_counts_an_engaged_cache(tmp_path, monkeypatch, fastas):
    """A device budget of the in-core footprint keeps the stream in core
    through K1; with the cached form's bytes on top it takes K6."""
    args = stream_args(tmp_path, fastas, "tn93")
    want = jax_numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", GROUP)
    seen = []
    real = port_engine._stream_cache_fits

    def spy(plan, rows, grows, width, footprint, budget):
        seen.append((footprint, port_engine._cache_bytes(
            plan, grows, width, rows, grows)))
        return real(plan, rows, grows, width, footprint, budget)

    monkeypatch.setattr(port_engine, "_stream_cache_fits", spy)
    port_tsv(tmp_path, args)
    footprint, extra = seen[0]
    plan = get_plan("tn93")
    # the loaded f cache, a group's g features, the reference row's and a
    # group's per-channel products
    assert extra == plan.total_channels * 128 * (N_LOADED + GROUP + 2) + (
        4 * plan.total_channels * N_LOADED * GROUP)
    for budget, cached in ((footprint, False), (footprint + extra, True)):
        monkeypatch.setattr(port_engine, "DEVICE_BUDGET", budget)
        bns = spy_groups(monkeypatch)
        n = Counts(monkeypatch)
        assert port_tsv(tmp_path, args, f"{budget}.tsv") == want
        assert bns == GROUP_SIZES  # in core: a block a group
        assert (n.k6_blocks > 0) == cached and (n.k1_blocks > 0) != cached
