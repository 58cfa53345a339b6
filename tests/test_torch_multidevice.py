"""The port's multi-device runs (the JAX engine's column split of every
block and stream group over a process's devices) on the CPU.

``engine.devices_of`` is replaced by a list of k CPU devices, as the JAX
tests pin ``jax.device_count``; every part then runs the kernels' plain
versions.  The TSVs of a split run equal ``distance --backend numpy``'s,
the port's one-device run's and the JAX engine's on its 8 virtual
devices, in core and out of core, with diffs on, forced and off and on
the saturating fixture through every rung; one split strip, stream
group, g cache and rebuild equal the JAX ``sharded=True`` functions'
outputs exactly; the split engages, rounds its tiles and falls to rel
where the JAX engine does; and ``--launch`` gives each worker a card.
"""

import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import distance_tpu.engine as jax_engine  # noqa: E402
from distance_tpu.engine import Setup as JaxSetup  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu.ops import diffup as jax_diffup  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.parallel import multihost  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402
from tests.test_golden import run_engine  # noqa: E402
from tests.test_stream_split import low_diversity_fastas  # noqa: E402
from tests.test_torch_diffup import lineage  # noqa: E402
from tests.test_torch_env_knobs import fake_cards  # noqa: E402
from tests.test_torch_outofcore import Seen, lower_budgets  # noqa: E402
from tests.test_torch_outofcore_packed import (  # noqa: E402
    SETTINGS,
    args_of,
    delta,
    diverse_fastas,
    numpy_tsv,
    port_tsv,
    rungs,
)
from tests.test_torch_packing import low_diversity  # noqa: E402
from tests.test_torch_stream_cached import (  # noqa: E402
    BN,
    JAX_TI,
    L_PAD,
    N1,
    WIDTH,
    group_inputs,
)

CPU = torch.device("cpu")
KS = (2, 3, 4, 8)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # the JAX CLI would otherwise keep a compilation cache under $HOME
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")
    for name in ("DISTANCE_TPU_FEATCACHE_BUDGET", "DISTANCE_TPU_STREAM_GROUP",
                 "DISTANCE_TPU_HBM_BUDGET", "DISTANCE_TPU_NO_REL_PACK",
                 "DISTANCE_TPU_NO_DIFF_UPLOAD", "DISTANCE_TPU_DIFF_UPLOAD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(port_engine, "CACHED_MEASURES", frozenset(MEASURES))


def on_devices(monkeypatch, k):
    """Runs of the port see k CPU devices; returns the devices counts of
    the engines they build."""
    monkeypatch.setattr(port_engine, "devices_of", lambda backend: [CPU] * k)
    made = []
    real = port_engine._BlockEngine.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        made.append(self.k)

    monkeypatch.setattr(port_engine._BlockEngine, "__init__", init)
    return made


def stream_group(k):
    """A stream group size that k devices divide, with rel4's halved
    columns."""
    return math.lcm(2 * k, 4)


@pytest.fixture(scope="module")
def fastas():
    rng = np.random.default_rng(1212)
    return {
        "a": make_fasta(random_seqs(rng, 37, 150, amb_frac=0.2)),
        "b": make_fasta(random_seqs(rng, 50, 150, amb_frac=0.2)),
    }


def mode_args(tmp_path, fastas, mode, measure):
    return args_of(tmp_path, mode, fastas["a"], fastas["b"], 7) + [
        "-m", measure]


_ONE_DEVICE = {}


def one_device(tmp_path, args, key):
    """numpy's bytes, held equal to the port's one-device run once a
    case."""
    if key not in _ONE_DEVICE:
        want = numpy_tsv(tmp_path, args)
        assert port_tsv(tmp_path, args, "one.tsv") == want
        _ONE_DEVICE[key] = want
    return _ONE_DEVICE[key]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
@pytest.mark.parametrize("measure", MEASURES)
def test_split_run_equals_numpy_and_one_device(tmp_path, monkeypatch, fastas,
                                               measure, mode, k):
    """In core, tiles of 8 (rounded to lcm(2k, 8)) and stream groups that
    k divides: the bytes of numpy and of the one-device run."""
    monkeypatch.setattr(port_engine, "TILE_I", 8)
    monkeypatch.setattr(port_engine, "TILE_J", 8)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", stream_group(k))
    args = mode_args(tmp_path, fastas, mode, measure)
    want = one_device(tmp_path, args, (measure, mode, stream_group(k)
                                       if mode == "stream" else None))
    made = on_devices(monkeypatch, k)
    assert port_tsv(tmp_path, args, "split.tsv") == want
    assert made == [k]


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
@pytest.mark.parametrize("measure", ["raw", "tn93", "k80"])
def test_split_run_equals_jax_engine_on_eight_devices(tmp_path, monkeypatch,
                                                      fastas, measure, mode):
    """The port on 8 devices writes the JAX engine's bytes at --backend xla
    on its 8 virtual CPU devices (its blocks sharded over them), with the
    same tiles."""
    assert jax.device_count() == 8
    monkeypatch.setattr(port_engine, "TILE_I", 8)
    monkeypatch.setattr(port_engine, "TILE_J", 16)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 16)
    monkeypatch.setenv("DISTANCE_TPU_STREAM_GROUP", "16")
    f1, f2 = fastas["a"], fastas["b"]
    want = run_engine(measure, f1, None if mode == "square" else f2,
                      stream=f2 if mode == "stream" else None,
                      backend="xla", tile_i=8, tile_j=16, batchsize=7)[0]
    monkeypatch.delenv("DISTANCE_TPU_STREAM_GROUP")
    made = on_devices(monkeypatch, 8)
    got = port_tsv(tmp_path, mode_args(tmp_path, fastas, mode, measure),
                   "split.tsv")
    assert got == want
    assert made == [8]


# measures x device counts out of core: all six at 2, two at the others
OOC_CASES = [(m, 2) for m in MEASURES] + [
    (m, k) for m in ("raw", "tn93") for k in (3, 4, 8)]


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
@pytest.mark.parametrize("measure, k", OOC_CASES)
def test_split_out_of_core_equals_numpy(tmp_path, monkeypatch, fastas,
                                        measure, k, mode):
    """Under ``lower_budgets`` the blocked square and rectangle and the
    staged stream run split, with several X groups (stream groups) and
    super-rows: numpy's bytes."""
    args = mode_args(tmp_path, fastas, mode, measure)
    want = numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, mode, group=stream_group(k))
    made = on_devices(monkeypatch, k)
    seen = Seen(monkeypatch)
    assert port_tsv(tmp_path, args, "split.tsv") == want
    assert made == [k]
    if mode == "stream":
        assert seen.staged >= 2
    else:
        assert seen.blocked == 1 and seen.x_groups >= 2
    assert len(seen.super_rows) >= 2


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_split_diff_settings_out_of_core(tmp_path, monkeypatch, mode, setting,
                                         k):
    """Low-diversity inputs out of core on k devices: diffs and rel4 by
    default and forced, dense and narrow without a reference row; the
    bytes are numpy's."""
    for name, value in SETTINGS[setting].items():
        monkeypatch.setenv(name, value)
    f1, f2 = low_diversity_fastas(seed=5, n1=40, n2=45, width=400, nmut=6)
    args = args_of(tmp_path, mode, f1, f2, batch=2) + ["-m", "raw"]
    want = numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, mode, group=stream_group(k))
    made = on_devices(monkeypatch, k)
    before = rungs()
    assert port_tsv(tmp_path, args, "split.tsv") == want
    assert made == [k]
    d = delta(before)
    if setting == "off":
        assert d["rel4"] == d["rel"] == 0 and d["narrow"] >= 1
    else:
        assert d["rel4"] >= 1 and d["narrow"] == 0


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_split_saturating_walks_every_packed_rung(tmp_path, monkeypatch, mode,
                                                  k):
    """The diverse fixture out of core in blocks of 64 x 256 on k devices:
    blocks saturate rel4 (the parts' merged sidecars) and rel and go
    wide, later ones narrow, then wide; numpy's bytes."""
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 256)
    f1, f2 = diverse_fastas(n1=130 if mode == "stream" else 300, n2=260,
                            width=600)
    args = args_of(tmp_path, mode, f1, f2, batch=256) + ["-m", "raw"]
    want = numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET",
                        150_000 if mode == "stream" else 250_000)
    monkeypatch.setattr(port_engine, "TILE_I", 64)
    monkeypatch.setattr(port_engine, "TILE_J", 256)
    made = on_devices(monkeypatch, k)
    before = rungs()
    assert port_tsv(tmp_path, args, "split.tsv") == want
    assert made == [k]
    d = delta(before)
    assert min(d["rel4"], d["rel"], d["narrow"], d["wide"]) >= 1, d


@pytest.mark.parametrize("staged", [False, True])
def test_split_stream_retarget_equals_numpy(tmp_path, monkeypatch, staged):
    """A stream of two lineages, neither the loaded one's, retargets the
    reference row of every part at its first group and at the switch; in
    core and staged, the bytes are numpy's."""
    rng = np.random.default_rng(85)
    width = 384
    ancs = [rng.choice(list("ACGT"), size=width) for _ in range(3)]
    f1 = make_fasta(lineage(rng, ancs[0], 20, "a", width))
    f2 = make_fasta(lineage(rng, ancs[1], 12, "b", width)
                    + lineage(rng, ancs[2], 12, "c", width))
    args = args_of(tmp_path, "stream", f1, f2, 3) + ["-m", "n_high"]
    want = numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 8)
    monkeypatch.setattr(port_engine, "PRUNE_MIN_FRACTION", 2.0)
    if staged:
        monkeypatch.setattr(port_engine, "TILE_I", 8)
        monkeypatch.setattr(port_engine, "DEVICE_BUDGET", 60_000)
    seen = Seen(monkeypatch)
    retargets = []
    real = port_engine._BlockEngine._uploaders

    def uploaders(self, up):
        retargets.append(up)
        return real(self, up)

    monkeypatch.setattr(port_engine._BlockEngine, "_uploaders", uploaders)
    on_devices(monkeypatch, 2)
    assert port_tsv(tmp_path, args, "split.tsv") == want
    assert (seen.staged >= 2) == staged
    assert len(retargets) >= 3  # the loaded rows' reference, two retargets


@pytest.mark.parametrize("k", [2, 4])
def test_split_launches_scale_by_part(tmp_path, monkeypatch, fastas, k):
    """A cached square whose strips lie on the block grid: k times the
    one-device run's K6 blocks, g caches, strip features and diff
    rebuilds; the reference row's features, the row baselines and the
    self-counter once; the column baseline a part."""
    monkeypatch.setattr(port_engine, "TILE_I", 16)
    monkeypatch.setattr(port_engine, "TILE_J", 16)
    monkeypatch.setenv("DISTANCE_TPU_DIFF_UPLOAD", "force")
    uploads = []
    real = port_engine.DiffUploader.upload_encoded
    monkeypatch.setattr(port_engine.DiffUploader, "upload_encoded",
                        lambda up, enc, rows: uploads.append(rows)
                        or real(up, enc, rows))
    args = mode_args(tmp_path, fastas, "square", "tn93")

    def counts(devices):
        made = on_devices(monkeypatch, devices)
        uploads.clear()
        before = (port_engine.K6_BLOCKS, port_engine.K1_BLOCKS,
                  port_engine.BASELINES, dict(port_engine.FEATURE_BUILDS))
        tsv = port_tsv(tmp_path, args, f"k{devices}.tsv")
        assert made == [devices]
        return tsv, {
            "k6": port_engine.K6_BLOCKS - before[0],
            "k1": port_engine.K1_BLOCKS - before[1],
            "baselines": port_engine.BASELINES - before[2],
            "builds": {kind: n - before[3][kind]
                       for kind, n in port_engine.FEATURE_BUILDS.items()},
            "uploads": len(uploads)}

    tsv1, one = counts(1)
    tsvk, split = counts(k)
    assert tsvk == tsv1
    assert one["k1"] == split["k1"] == 0
    assert split["k6"] == k * one["k6"]
    assert split["uploads"] == k * one["uploads"]
    assert split["builds"] == {**one["builds"], "g": k * one["builds"]["g"],
                               "strip": k * one["builds"]["strip"]}
    assert split["baselines"] == one["baselines"] + k - 1


# -- the block and stream functions against the JAX sharded functions -----

@pytest.mark.parametrize("cache", ["g cache", "no cache"])
@pytest.mark.parametrize("diff", ["on", "off"])
@pytest.mark.parametrize("mode", ["square", "rectangle"])
@pytest.mark.parametrize("measure", ["raw", "tn93", "n", "k80"])
def test_split_strip_equals_jax_sharded_block_fn(measure, mode, diff, cache,
                                                 monkeypatch):
    """One strip on 8 devices (blocks of 32 columns, 4 a device) equals the
    JAX engine's on its 8-device mesh (``_jit_block_fn_feat`` or
    ``_jit_block_fn`` with ``sharded=True``): lanes, cb, rb||cc and the
    rel4 sidecar at rel4, and packed again from the kept counters at rel,
    narrow and wide, byte for byte."""
    if diff == "off":
        monkeypatch.setenv("DISTANCE_TPU_NO_DIFF_UPLOAD", "1")
    rng = np.random.default_rng(17)
    n1, n2, width, ti, tj = 50, 70, 300, 32, 32
    src1 = low_diversity(rng, n1, width)
    src2 = src1 if mode == "square" else low_diversity(rng, n2, width)
    n2 = src2.shape[0]
    jeng = jax_engine._BlockEngine(measure, "xla", ti, tj, width)
    assert jeng.sharded
    peng = port_engine._BlockEngine(measure, [CPU] * 8, ti, width, rel=True,
                                    tj=tj)
    assert peng.k == 8
    g = cache == "g cache"
    dref, pref = jeng.diff_ref_for(src1), peng.diff_ref_for(src1)
    if mode == "square":
        jm1 = jm2 = jeng.prepare(src1, tj, diff_ref=dref, cache_g=g)
        pm1 = pm2 = peng.prepare(src1, tj, diff_ref=pref, cache_g=g)
        diag = 0
    else:
        jm1 = jeng.prepare(src1, ti, diff_ref=dref, cache_g=False)
        jm2 = jeng.prepare(src2, tj, diff_ref=dref, cache_g=g)
        pm1 = peng.prepare(src1, ti, diff_ref=pref)
        pm2 = peng.prepare(src2, tj, diff_ref=pref, cache_g=g)
        diag = None
    assert (jeng.gfeat_of(jm2) is not None) == g
    assert (peng.gfeat_of(pm2) is not None) == g
    for i0 in (0, 32):
        col_starts = list(range(i0 if mode == "square" else 0, n2, tj))
        strip = port_engine._Strip(peng, pm1, pm2, i0, col_starts, ti, tj,
                                   (n1, n2), diag)
        for rung in ("rel4", "rel", "narrow", "wide"):
            want = jax_engine._dispatch_strip(
                jeng, jm1, jm2, i0, col_starts, ti, tj, rung, nv=(n1, n2))
            got = strip(rung)
            if rung in ("narrow", "wide"):
                got, want = (got,), (want,)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def split_group(eng, group):
    """A stream group's codes placed on every part, as dispatch_stream
    places them."""
    return eng._register([torch.from_numpy(group.copy())
                          for _ in range(eng.k)])


@pytest.mark.parametrize("measure", MEASURES)
def test_split_stream_group_equals_jax_sharded_stream_fn(monkeypatch,
                                                         measure):
    """A 32-record group on 8 devices (4 records a device): the counters,
    and at rel4 the lanes and the bundle (cb joined, rb||cc, the merged
    sidecar) equal the JAX ``_jit_stream_fn(..., sharded=True)``'s."""
    loaded, group = group_inputs(81)
    group = np.concatenate([group, group_inputs(83)[1][: 32 - BN]])
    bn = group.shape[0]
    for rel, mode in ((False, "none"), (True, "rel4")):
        eng = port_engine._BlockEngine(measure, [CPU] * 8, 1, WIDTH,
                                       rel=rel, tj=bn)
        assert eng.k == 8
        m1 = eng.prepare(loaded[:, :WIDTH], 1, cache_f=True,
                         diff_ref=loaded[0, :WIDTH] if rel else None)
        codes = split_group(eng, group)
        eng.cache_group(codes, m1)
        strip = port_engine._Strip(eng, m1, codes, 0, [0], N1, bn, (N1, bn),
                                   None, eng.rel_ref)
        got = strip(mode)
        eng.drop_group(codes)
        fn = jax_engine._jit_stream_fn(measure, "xla", JAX_TI, bn, N1, mode,
                                       WIDTH, L_PAD, None, True)
        if not rel:
            want = fn(jnp.asarray(loaded), jnp.asarray(group))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            continue
        want = fn(jnp.asarray(loaded), jnp.asarray(eng.rel_ref.numpy()),
                  jnp.asarray(group), N1, bn)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("measure", MEASURES)
def test_part_features_equal_jax_blocked_builder(measure):
    """Each part's g cache is its columns of every block of the JAX
    ``_jit_feat_builder_blocked`` output (zero features past the rows)."""
    rng = np.random.default_rng(7)
    tj, k = 32, 8
    src = low_diversity(rng, 45, 200)
    eng = port_engine._BlockEngine(measure, [CPU] * k, 16, 200, tj=tj)
    m = eng.prepare(src, tj, cache_g=True)
    want = np.asarray(jax_engine._jit_feat_builder_blocked(measure, tj)(
        jnp.asarray(m.numpy())))
    nb, r, _, l_pad = want.shape
    w = tj // k
    for d, rep in enumerate(eng.reps(m)):
        got = eng.gfeat_of(rep).numpy().reshape(r, nb, w, l_pad)
        np.testing.assert_array_equal(
            got.transpose(1, 0, 2, 3), want[:, :, d * w:(d + 1) * w])


def test_split_rebuild_equals_jax_sharded_build():
    """A diff upload on 8 devices: every part's rebuilt codes equal the
    JAX ``_build_fn(sharded=True)`` of the same diffs."""
    rng = np.random.default_rng(9)
    src = low_diversity(rng, 40, 300)
    eng = port_engine._BlockEngine("raw", [CPU] * 8, 8, 300, rel=True, tj=16)
    m = eng.prepare(src, 16, diff_ref=eng.diff_ref_for(src))
    enc = eng.diff_up.encode(np.pad(src, ((0, m.shape[0] - 40),
                                          (0, m.shape[1] - 300))), n_real=40)
    assert enc is not None
    fn = jax_diffup._build_fn(m.shape[0], m.shape[1], enc[0].shape[0],
                              sharded=True)
    want = np.asarray(fn(jnp.asarray(eng.diff_up.ref), jnp.asarray(enc[0]),
                         jnp.asarray(enc[1])))
    reps = eng.reps(m)
    assert len(reps) == 8 and len({id(r) for r in reps}) == 8
    for rep in reps:
        np.testing.assert_array_equal(rep.numpy(), want)


# -- when the split engages, tiles, rungs ----------------------------------

@pytest.mark.parametrize("k", KS)
def test_split_and_rel4_follow_the_jax_engine(monkeypatch, k):
    """For tiles that k does and does not divide: the engine splits where
    the JAX engine's ``_device_mesh`` shards, and starts at rel where its
    ``_rel4_shard_ok`` refuses rel4 (k = 3 with tj = 6, k = 2 with
    tj = 6)."""
    monkeypatch.setattr(jax, "device_count", lambda: k)
    for tj in (6, 8, 10, 12, 16, 24, 48):
        jeng = jax_engine._BlockEngine("raw", "xla", 8, tj, 300)
        peng = port_engine._BlockEngine("raw", [CPU] * k, 8, 300, rel=True,
                                        tj=tj)
        assert (peng.k > 1) == jeng.sharded, tj
        assert peng._rel4_ok == jeng._rel4_shard_ok, tj
        if peng.k > 1:
            peng.rel_ref = torch.zeros(384, dtype=torch.uint8)
            assert peng.pack_mode == ("rel4" if jeng._rel4_shard_ok
                                      else "rel")


@pytest.mark.parametrize("k", [2, 3, 6, 8])
@pytest.mark.parametrize("tiles", [(8, 8 * 12 + 1), (1024, 4096), (8, 16)])
def test_tile_note_equals_jax(monkeypatch, capsys, k, tiles):
    """``_choose_tiles`` on k devices gives the JAX engine's tiles and its
    stderr note word for word."""
    monkeypatch.setattr(jax, "device_count", lambda: k)
    jsetup = JaxSetup(loaded=[], streamed=None, writer=None, measure="raw",
                      n_threads=1, batchsize=1, tile_i=tiles[0],
                      tile_j=tiles[1])
    want = jax_engine._choose_tiles(10_000, 10_000, jsetup, "xla")
    jerr = capsys.readouterr().err
    psetup = port_engine.Setup(loaded=[], streamed=None, writer=None,
                               measure="raw", n_threads=1, batchsize=1,
                               tile_i=tiles[0], tile_j=tiles[1])
    got = port_engine._choose_tiles(10_000, 10_000, psetup, CPU, k)
    assert got == want
    assert capsys.readouterr().err == jerr
    assert got[1] % math.lcm(2 * k, got[0]) == 0


def test_a_group_size_k_does_not_divide_runs_on_one_device(tmp_path,
                                                           monkeypatch,
                                                           fastas):
    """A stream whose group size 3 devices do not divide (the JAX
    ``_device_mesh(rows_pad)``) runs on the first device alone."""
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 4)
    args = mode_args(tmp_path, fastas, "stream", "raw")
    want = numpy_tsv(tmp_path, args)
    made = on_devices(monkeypatch, 3)
    assert port_tsv(tmp_path, args, "split.tsv") == want
    assert made == [1]


@pytest.mark.parametrize("cards, want", [(2, [0, 1]), (1, [0, 0]),
                                         (4, [0, 1])])
def test_launch_gives_each_worker_its_card(tmp_path, fastas, monkeypatch,
                                           cards, want):
    """``--launch 2`` tells worker k its index: it takes card k mod the
    card count, alone on it unless the cards run out; a lone process
    takes every card."""
    launched = []

    class Worker:
        def __init__(self, argv, env):
            launched.append(env)
            Path(argv[argv.index("-o") + 1]).write_bytes(b"")

        def poll(self):
            return 0

    monkeypatch.setattr(multihost.subprocess, "Popen", Worker)
    a = tmp_path / "a.fasta"
    a.write_bytes(fastas["a"])
    from distance_tpu_torch import cli as port_cli

    assert port_cli.main([str(a), "--launch", "2", "-o",
                          str(tmp_path / "o.tsv")]) == 0
    assert [env[multihost.CARD_SHARE_ENV] for env in launched] == [
        "0/2", "1/2"]
    fake_cards(monkeypatch, cards)
    assert port_engine.devices_of("cuda") == [
        torch.device("cuda", c) for c in range(cards)]
    for env, card in zip(launched, want):
        monkeypatch.setenv(multihost.CARD_SHARE_ENV,
                           env[multihost.CARD_SHARE_ENV])
        assert port_engine.devices_of("cuda") == [torch.device("cuda", card)]
        assert port_engine._card_share() == (2 if cards == 1 else 1)
