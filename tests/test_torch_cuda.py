"""The CUDA kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one.  They import
neither jax nor ``tests.conftest`` (which loads jax), so on a GPU host
without jax they run as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu_torch import cli  # noqa: E402
from distance_tpu_torch import engine  # noqa: E402
from distance_tpu_torch.encoding import ALL_CODES, CODE_TO_CHAR  # noqa: E402
from distance_tpu_torch.measures import MEASURES  # noqa: E402
from distance_tpu_torch.ops import counters as kernels  # noqa: E402
from distance_tpu_torch.ops import cached, diffup, packing  # noqa: E402
from distance_tpu_torch.ops.features import (  # noqa: E402
    get_plan,
    reference_counter_matrix,
)
from distance_tpu_torch.ops.plan import (  # noqa: E402
    cached_plan_to_torch,
    fold_cached,
    plan_to_torch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(monkeypatch):
    """The first card; the engine's cuda runs on it alone, as on a host of
    one card (the launch counts below are one device's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    split_devices(monkeypatch, [card])
    return card


def random_codes(rng, rows: int, width: int) -> np.ndarray:
    return rng.choice(ALL_CODES, size=(rows, width)).astype(np.uint8)


def write_fasta(path, mat: np.ndarray) -> None:
    with open(path, "w") as f:
        for i, row in enumerate(mat):
            f.write(f">r{i}\n{''.join(CODE_TO_CHAR[c] for c in row)}\n")


@pytest.mark.parametrize("measure", MEASURES)
def test_kernel_matches_plain(dev, measure):
    rng = np.random.default_rng(21)
    plan = plan_to_torch(get_plan(measure), dev)
    for m, n, width in [(13, 7, 200), (130, 257, 1000), (64, 64, 16),
                        (65, 63, 17), (3, 4, 0), (0, 5, 128)]:
        x = torch.from_numpy(random_codes(rng, m, width)).to(dev)
        y = torch.from_numpy(random_codes(rng, n, width)).to(dev)
        got = kernels.counters_cuda(x, y, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.counters_torch(x, y, plan)), (
            m, n, width)


@pytest.mark.parametrize("measure", MEASURES)
def test_kernel_truth_table(dev, measure):
    """Code 0 and every Paradis code, each over 64 sites, on both sides:
    each counter is 64 times its predicate table at those codes."""
    codes = np.concatenate([[0], ALL_CODES]).astype(np.uint8)
    x = torch.from_numpy(np.repeat(codes[:, None], 64, axis=1)).to(dev)
    plan = get_plan(measure)
    kp = plan_to_torch(plan, dev)
    got = kernels.counters_cuda(x, x, kp)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.counters_torch(x, x, kp))
    for g, name in enumerate(plan.counters):
        want = 64 * reference_counter_matrix(name)[np.ix_(codes, codes)]
        np.testing.assert_array_equal(got[g].cpu().numpy(), want)


@pytest.mark.parametrize("width", [31, 32, 33, 4095])
@pytest.mark.parametrize("measure", MEASURES)
def test_kernel_matches_plain_at_tile_edges(dev, measure, width):
    """Rows on either side of the 128 x 256 tile, sites on either side of
    a 32-site k-step (and a 64-site chunk, at 4095)."""
    rng = np.random.default_rng(28)
    plan = plan_to_torch(get_plan(measure), dev)
    for m in (127, 128, 129):
        for n in (255, 256, 257):
            x = torch.from_numpy(random_codes(rng, m, width)).to(dev)
            y = torch.from_numpy(random_codes(rng, n, width)).to(dev)
            got = kernels.counters_cuda(x, y, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, kernels.counters_torch(x, y, plan)), (
                m, n)


def test_wrapper_pads_codes_to_16_sites(dev):
    """A width that is not a multiple of 16, or codes at an address off
    the 16-byte grid, are copied into 16-site rows of code 0 before the
    launch; the counters do not change."""
    rng = np.random.default_rng(29)
    plan = plan_to_torch(get_plan("tn93"), dev)
    x = torch.from_numpy(random_codes(rng, 40, 37)).to(dev)
    y = torch.from_numpy(random_codes(rng, 300, 37)).to(dev)
    assert kernels._site_aligned(x).shape == (40, 48)
    flat = torch.from_numpy(random_codes(rng, 1, 40 * 48 + 1)).to(dev)
    xs = flat.view(-1)[1:].view(40, 48)  # contiguous, 1 byte off the grid
    assert xs.data_ptr() % 16 and kernels._site_aligned(xs) is not xs
    # no sites: torch gives the rows a stride of 1, and nothing is read
    x0 = torch.zeros((3, 0), dtype=torch.uint8, device=dev)
    before = kernels.LAUNCHES
    for a, b in ((x, y), (xs, xs[:30]), (x0, x0[:2])):
        got = kernels.counters_cuda(a, b, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.counters_torch(a, b, plan))
    assert kernels.LAUNCHES == before + 3


def test_kernel_counts_launches_and_refuses_strided_codes(dev):
    plan = plan_to_torch(get_plan("raw"), dev)
    x = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    before = kernels.LAUNCHES
    kernels.counters(x, x, plan)
    assert kernels.LAUNCHES == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        kernels.counters_cuda(x[:, ::2], x[:, ::2], plan)
    with pytest.raises(ValueError, match="plan tables"):
        kernels.counters_cuda(x, x, plan_to_torch(get_plan("raw"), "cpu"))
    assert kernels.LAUNCHES == before + 1


def counter_launches() -> int:
    """Launches of the counter kernels: K1, and K6 on the cached-feature
    path."""
    return kernels.LAUNCHES + cached.LAUNCHES_CONTRACT


@pytest.mark.parametrize("measure", ["raw", "n", "k80", "tn93"])
def test_cli_cuda_equals_torch(dev, tmp_path, measure):
    rng = np.random.default_rng(22)
    anc = random_codes(rng, 1, 300)
    mat = np.repeat(anc, 45, axis=0)
    hits = rng.random(mat.shape) < 0.1
    mat[hits] = rng.choice(ALL_CODES, size=int(hits.sum()))
    fasta = tmp_path / "a.fasta"
    write_fasta(fasta, mat)
    outs = {}
    for backend in ("cuda", "torch"):
        outs[backend] = tmp_path / f"{backend}.tsv"
        before = counter_launches()
        rc = cli.main([str(fasta), "-m", measure, "--backend", backend,
                       "-o", str(outs[backend])])
        assert rc == 0
        assert (counter_launches() > before) == (backend == "cuda")
    assert outs["cuda"].read_bytes() == outs["torch"].read_bytes()


def test_small_tiles_on_card(dev, tmp_path):
    rng = np.random.default_rng(23)
    fasta = tmp_path / "a.fasta"
    write_fasta(fasta, random_codes(rng, 70, 90))
    outs = []
    for backend in ("cuda", "torch"):
        out = tmp_path / f"{backend}.tsv"
        args = cli.build_parser().parse_args(
            [str(fasta), "-m", "tn93", "--backend", backend, "-o", str(out)]
        )
        setup = engine.set_up(args)
        setup.tile_i = setup.tile_j = 16
        before, rel4 = counter_launches(), engine.RUNG_BLOCKS["rel4"]
        k1 = kernels.LAUNCHES
        engine.run(setup)
        setup.writer.close()
        if backend == "cuda":
            # 15 blocks at rel4 (no segment of 1 cell saturates), through
            # K6 (tn93 takes the cached-feature path), and the baselines:
            # each strip's rows (5), the matrix's columns and the reference
            assert engine.RUNG_BLOCKS["rel4"] - rel4 == 5 + 4 + 3 + 2 + 1
            assert counter_launches() - before == 5 + 4 + 3 + 2 + 1 + 5 + 2
            assert kernels.LAUNCHES == k1
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("width", [1, 3, 129])
@pytest.mark.parametrize("measure", MEASURES)
def test_kernel_matches_plain_at_stream_widths(dev, measure, width):
    """After the stream's variant split a group may keep very few sites;
    the last group and the last strip are ragged."""
    rng = np.random.default_rng(24)
    plan = plan_to_torch(get_plan(measure), dev)
    for m, n in [(1, 1), (2000, 383), (77, 1001), (129, 65)]:
        x = torch.from_numpy(random_codes(rng, m, width)).to(dev)
        y = torch.from_numpy(random_codes(rng, n, width)).to(dev)
        got = kernels.counters_cuda(x, y, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.counters_torch(x, y, plan)), (m, n)


@pytest.mark.parametrize("measure", ["raw", "tn93"])
def test_kernel_takes_millions_of_x_rows(dev, measure):
    """4,194,305 x rows need 65,537 row tiles, more than a grid's y axis
    holds: the row tiles are on its x axis."""
    rng = np.random.default_rng(26)
    plan = plan_to_torch(get_plan(measure), dev)
    x = torch.from_numpy(random_codes(rng, 4_194_305, 16)).to(dev)
    y = torch.from_numpy(random_codes(rng, 8, 16)).to(dev)
    got = kernels.counters_cuda(x, y, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.counters_torch(x, y, plan))


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_out_of_core_cuda_equals_torch(dev, tmp_path, monkeypatch, mode):
    """Budgets lowered so that each mode goes out of core in several groups
    and super-rows: a counter kernel runs every block (K6, or K1 where
    the caches do not fit the budget), and the bytes are the plain
    version's."""
    rng = np.random.default_rng(27)
    mat = random_codes(rng, 100, 300)
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    write_fasta(a, mat[:60])
    write_fasta(b, mat[60:])
    args = {"square": [str(a)], "rectangle": [str(a), str(b)],
            "stream": [str(a), "-s", str(b), "-b", "3"]}[mode]
    monkeypatch.setattr(engine, "DEVICE_BUDGET",
                        5000 if mode == "stream" else 30000)
    monkeypatch.setattr(engine, "HOST_BUF_BUDGET", 20000)
    monkeypatch.setattr(engine, "TILE_I", 8)
    monkeypatch.setattr(engine, "TILE_J", 16)
    monkeypatch.setattr(engine, "STREAM_GROUP", 6)
    outs = {}
    for backend in ("cuda", "torch"):
        outs[backend] = tmp_path / f"{backend}.tsv"
        before = counter_launches()
        rc = cli.main(args + ["-m", "tn93", "--backend", backend, "-o",
                              str(outs[backend])])
        assert rc == 0
        assert (counter_launches() > before) == (backend == "cuda")
    assert outs["cuda"].read_bytes() == outs["torch"].read_bytes()


@pytest.mark.parametrize("mode", ["rectangle", "stream"])
@pytest.mark.parametrize("measure", ["raw", "n", "k80", "tn93"])
def test_cli_cuda_equals_torch_rect_stream(dev, tmp_path, monkeypatch, mode,
                                           measure):
    """Batches of 7 records in groups of at most 4 give groups of 4 and 3
    rows, many more than the two pinned upload buffers: each buffer is
    refilled, over stale rows, while earlier copies and kernels are in
    flight."""
    rng = np.random.default_rng(25)
    anc = random_codes(rng, 1, 300)
    mat = np.repeat(anc, 110, axis=0)
    hits = rng.random(mat.shape) < 0.1
    mat[hits] = rng.choice(ALL_CODES, size=int(hits.sum()))
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    write_fasta(a, mat[:30])
    write_fasta(b, mat[30:])
    args = [str(a), str(b)] if mode == "rectangle" else [
        str(a), "-s", str(b), "-b", "7"]
    monkeypatch.setattr(engine, "STREAM_GROUP", 4)
    outs = {}
    for backend in ("cuda", "torch"):
        outs[backend] = tmp_path / f"{backend}.tsv"
        before = (kernels.LAUNCHES, counter_launches())
        rc = cli.main(args + ["-m", measure, "--backend", backend, "-o",
                              str(outs[backend])])
        assert rc == 0
        launched = counter_launches() - before[1]
        if backend == "torch":
            assert launched == 0
        elif mode == "stream":
            # 11 batches of 7, then 3: 23 groups, each a K6 block and its
            # column baseline; the loaded rows' and the reference's
            # baselines once; no K1
            assert launched == 2 * (11 * 2 + 1) + 2
            assert kernels.LAUNCHES == before[0]
    assert outs["cuda"].read_bytes() == outs["torch"].read_bytes()


@pytest.mark.parametrize("measure", MEASURES)
def test_stream_shards_on_card_merge_to_plain_bytes(dev, tmp_path,
                                                    monkeypatch, measure):
    """Two stream shards on the card (groups of 14 records: two -b 7
    batches, 22 groups in all, round-robin) merge to the plain version's
    unsharded bytes; each shard launches a K6 block per group it owns,
    and no K1."""
    rng = np.random.default_rng(30)
    anc = random_codes(rng, 1, 300)
    mat = np.repeat(anc, 428, axis=0)
    hits = rng.random(mat.shape) < 0.1
    mat[hits] = rng.choice(ALL_CODES, size=int(hits.sum()))
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    write_fasta(a, mat[:128])
    write_fasta(b, mat[128:])
    args = [str(a), "-s", str(b), "-b", "7", "-m", measure]
    monkeypatch.setattr(engine, "STREAM_GROUP", 16)
    parts, launched = [], []
    for k in range(2):
        parts.append(str(tmp_path / f"p{k}"))
        before = (engine.RUNG_BLOCKS["rel4"], counter_launches(),
                  kernels.LAUNCHES)
        rc = cli.main(args + ["--backend", "cuda", "--shard", f"{k}/2",
                              "-o", parts[-1]])
        assert rc == 0
        launched.append((engine.RUNG_BLOCKS["rel4"] - before[0],
                         counter_launches() - before[1],
                         kernels.LAUNCHES - before[2]))
    # a block and a column baseline a group, and two baselines a shard
    assert launched == [(11, 24, 0), (11, 24, 0)]
    merged, plain = tmp_path / "merged.tsv", tmp_path / "plain.tsv"
    assert cli.main(["--merge", *parts, "-o", str(merged)]) == 0
    assert cli.main(args + ["--backend", "torch", "-o", str(plain)]) == 0
    assert merged.read_bytes() == plain.read_bytes()


def staged_stream_budget(measure: str, n1: int, grows: int, width: int,
                         sr_rows: int, ti: int) -> int:
    """A device budget under which a stream of ``n1`` loaded rows of
    ``width`` sites on the device, in groups of ``grows`` records, is
    staged with its caches in super-rows of ``sr_rows`` rows (a multiple
    of the tile ``ti``): one group's footprint beside a super-row of
    ``sr_rows + ti`` rows with the cached form's bytes, less one byte."""
    plan = get_plan(measure)
    return (engine._stream_footprint(grows, sr_rows + ti, width,
                                     len(plan.counters), 1, kept=n1)
            + engine._cache_bytes(plan, grows, width, sr_rows + ti, grows)
            - 1)


@pytest.mark.parametrize("layout", ["in core", "staged", "shards"])
@pytest.mark.parametrize("measure", ["raw", "k80", "tn93"])
def test_cached_stream_on_card_equals_torch_and_k1(dev, tmp_path,
                                                   monkeypatch, layout,
                                                   measure):
    """The stream through K5 and K6 on the card (70 loaded records, 120
    streamed in -b 7 batches, groups of at most 16): in core, staged with
    its caches in super-rows of 32, 32 and 6 loaded rows, and as two
    shards merged, its bytes equal ``--backend torch``'s and those of the
    K1 run (the engine's measure set emptied)."""
    rng = np.random.default_rng(36)
    anc = random_codes(rng, 1, 300)
    mat = np.repeat(anc, 190, axis=0)
    hits = rng.random(mat.shape) < 0.1
    mat[hits] = rng.choice(ALL_CODES, size=int(hits.sum()))
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    write_fasta(a, mat[:70])
    write_fasta(b, mat[70:])
    args = [str(a), "-s", str(b), "-b", "7", "-m", measure]
    monkeypatch.setattr(engine, "STREAM_GROUP", 16)
    monkeypatch.setattr(engine, "TILE_I", 16)
    # every site on the device (no variant split), as the budget counts
    monkeypatch.setattr(engine, "PRUNE_MIN_FRACTION", 2.0)
    monkeypatch.setattr(engine, "CACHED_MEASURES", frozenset(MEASURES))
    if layout == "staged":
        monkeypatch.setattr(engine, "DEVICE_BUDGET", staged_stream_budget(
            measure, 70, 16, 300, 32, 16))

    def run(tag, backend):
        out = tmp_path / f"{tag}.tsv"
        if layout != "shards":
            assert cli.main(args + ["--backend", backend, "-o",
                                    str(out)]) == 0
            return out.read_bytes()
        parts = [str(tmp_path / f"{tag}{k}") for k in range(2)]
        for k, part in enumerate(parts):
            assert cli.main(args + ["--backend", backend, "--shard",
                                    f"{k}/2", "-o", part]) == 0
        assert cli.main(["--merge", *parts, "-o", str(out)]) == 0
        return out.read_bytes()

    before = (kernels.LAUNCHES, cached.LAUNCHES_CONTRACT,
              dict(engine.FEATURE_BUILDS))
    got = run("cached", "cuda")
    builds = {k: engine.FEATURE_BUILDS[k] - before[2][k]
              for k in before[2]}
    # 120 records in -b 7 batches: 8 groups of 14 and one of 8, each
    # with its g features
    assert kernels.LAUNCHES == before[0]
    assert cached.LAUNCHES_CONTRACT > before[1] and builds["group"] == 9
    assert builds["f"] >= (3 if layout == "staged" else 1)
    monkeypatch.setattr(engine, "CACHED_MEASURES", frozenset())
    before = (kernels.LAUNCHES, cached.LAUNCHES_CONTRACT)
    k1 = run("k1", "cuda")
    assert kernels.LAUNCHES > before[0]
    assert cached.LAUNCHES_CONTRACT == before[1]
    assert got == k1 == run("torch", "torch")


def lineage_codes(rng, anc: np.ndarray, n: int) -> np.ndarray:
    """``n`` records of the ancestor ``anc`` with 4 sites each moved to
    another base."""
    step = np.zeros(256, dtype=np.uint8)
    bases = ALL_CODES[:4]
    step[bases] = np.roll(bases, 1)
    mat = np.repeat(anc[None], n, axis=0)
    for row in mat:
        sites = rng.choice(anc.size, 4, replace=False)
        row[sites] = step[row[sites]]
    return mat


@pytest.mark.parametrize("staged", [False, True])
def test_cached_stream_retarget_on_card_equals_torch_and_k1(
        dev, tmp_path, monkeypatch, staged):
    """A stream of two lineages, neither the loaded one's, retargets the
    reference row at its first group and at the switch: on the card each
    new row's features are built and the baselines taken again through
    K6 (in core, and staged with its caches), and the bytes equal
    ``--backend torch``'s and the K1 run's."""
    rng = np.random.default_rng(37)
    ancs = [rng.choice(ALL_CODES[:4], size=384).astype(np.uint8)
            for _ in range(3)]
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    write_fasta(a, lineage_codes(rng, ancs[0], 40))
    write_fasta(b, np.concatenate([lineage_codes(rng, ancs[1], 24),
                                   lineage_codes(rng, ancs[2], 24)]))
    args = [str(a), "-s", str(b), "-b", "3", "-m", "n_high"]
    monkeypatch.setattr(engine, "STREAM_GROUP", 6)
    monkeypatch.setattr(engine, "TILE_I", 16)
    monkeypatch.setattr(engine, "PRUNE_MIN_FRACTION", 2.0)
    if staged:
        monkeypatch.setattr(engine, "DEVICE_BUDGET", staged_stream_budget(
            "n_high", 40, 6, 384, 16, 16))
    outs = {}
    for tag, backend, measures in (("cached", "cuda", MEASURES),
                                   ("k1", "cuda", ()),
                                   ("torch", "torch", MEASURES)):
        monkeypatch.setattr(engine, "CACHED_MEASURES", frozenset(measures))
        before = (kernels.LAUNCHES, engine.FEATURE_BUILDS["ref"])
        out = tmp_path / f"{tag}.tsv"
        assert cli.main(args + ["--backend", backend, "-o", str(out)]) == 0
        if tag == "cached":
            # two reference rows, each with its f and g features
            assert kernels.LAUNCHES == before[0]
            assert engine.FEATURE_BUILDS["ref"] - before[1] == 4
        outs[tag] = out.read_bytes()
    assert outs["cached"] == outs["k1"] == outs["torch"]


def test_counters_with_a_one_row_side(dev):
    """The rel baselines: every row against the reference row, it against
    every row, and it against itself."""
    rng = np.random.default_rng(31)
    rows = torch.from_numpy(random_codes(rng, 3000, 640)).to(dev)
    ref = torch.from_numpy(random_codes(rng, 1, 640)).to(dev)
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        for x, y in ((rows, ref), (ref, rows), (ref, ref)):
            got = kernels.counters_cuda(x, y, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, kernels.counters_torch(x, y, plan))


def outlier_counters(rng, g, m, n):
    """int32 counters whose residuals (zero baselines) lie in [-7, 7] but
    for segments holding 1, 2, 3 and every cell as outliers."""
    c = rng.integers(-7, 8, size=(g, m, n)).astype(np.int32)
    flat = c.reshape(-1)
    seg = -(-flat.size // packing.REL4_SEGMENTS)
    for s, k in ((1, 1), (3, 2), (5, 3), (8, seg)):
        lo = s * seg
        hi = min(lo + seg, flat.size)
        if lo < hi:
            cells = rng.choice(np.arange(lo, hi), size=min(k, hi - lo),
                               replace=False)
            flat[cells] = rng.choice([-8, 8, 127, -128, 300], size=cells.size)
    return c


@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 33, 64), (4, 129, 258),
                                   (3, 500, 1000), (2, 0, 8)])
def test_pack_kernels_match_plain(dev, shape):
    """K2 (rel4 and rel) against its plain version, exactly: random
    baselines, segments with 0, 1, 2, 3 and many outliers, with and
    without the self-pair diagonal and the padding masked."""
    rng = np.random.default_rng(sum(shape))
    g, m, n = shape
    c = torch.from_numpy(outlier_counters(rng, g, m, n)).to(dev)
    rb = torch.from_numpy(rng.integers(-3, 4, (g, m)).astype(np.int32)).to(dev)
    cb = torch.from_numpy(rng.integers(-3, 4, (g, n)).astype(np.int32)).to(dev)
    cc = torch.from_numpy(rng.integers(-3, 4, g).astype(np.int32)).to(dev)
    for i0, j0, nv, diag in ((0, 0, None, None), (3, 1, (m - 1, n - 3), 2),
                             (0, 0, (m, n), 0)):
        got = packing.pack_rel4_cuda(c, rb, cb, cc, i0, j0, nv, diag)
        torch.cuda.synchronize()
        mask = packing.block_mask(m, n, i0, j0, nv or (i0 + m, j0 + n),
                                  diag, dev)
        want = packing.pack_rel4_torch(c, rb, cb, cc, mask)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (i0, j0, nv, diag)
        got = packing.pack_rel_cuda(c, rb, cb, cc, i0, j0, diag)
        torch.cuda.synchronize()
        mask = packing.block_mask(m, n, i0, j0, None, diag, dev)
        assert torch.equal(got, packing.pack_rel_torch(c, rb, cb, cc, mask))


# (G, m, n) of rel4's segment edges: the flat tensor's 8192 segments are
# of L = ceil(G m n / 8192) cells, odd (7 at 2 x 100 x 246, 3 at 3 x 50 x
# 110), so that a byte straddles two segments, and even (8 at 4 x 64 x
# 256, 2 at 1 x 91 x 180); the last segment holding cells is partial.
REL4_EDGES = [(2, 100, 246), (4, 64, 256), (3, 50, 110), (1, 91, 180)]


def rel4_edge_counters(rng, g, m, n, every=False):
    """Counters and baselines whose residuals lie in [-7, 7] but for
    outliers on rel4's segment edges: a segment with one, one with two and
    one with every cell out, both cells of the first byte that straddles
    two segments (odd L), two cells of the last, partial, segment, and a
    residual of exactly -2^31 (numpy's int32 abs keeps it negative: no
    outlier, nibble 0); with ``every``, every cell out.  Returns numpy
    (c, rb, cb, cc)."""
    c = rng.integers(-4, 5, size=(g, m, n)).astype(np.int32)
    rb = rng.integers(-1, 2, (g, m)).astype(np.int32)
    cb = rng.integers(-1, 2, (g, n)).astype(np.int32)
    cc = rng.integers(-1, 2, g).astype(np.int32)
    flat = c.reshape(-1)
    size = flat.size
    seg = -(-size // packing.REL4_SEGMENTS)
    out = np.array([11, -11, 100, -300, 9000], dtype=np.int32)
    if every:
        flat[:] = rng.choice(out, size)
        return c, rb, cb, cc
    for s, k in ((1, 1), (2, 2), (3, seg)):
        cells = rng.choice(np.arange(s * seg, (s + 1) * seg), k,
                           replace=False)
        flat[cells] = rng.choice(out, k)
    s = 5 if seg % 2 else 4
    flat[[s * seg - 1, s * seg]] = rng.choice(out, 2)
    last = (size - 1) // seg * seg
    flat[[last, size - 1]] = rng.choice(out, 2)
    shift = int(rb[0, 0]) + int(cb[0, 0]) - int(cc[0])
    c[0, 0, 0] = np.int64(-(1 << 31) + shift).astype(np.int32)
    return c, rb, cb, cc


@pytest.mark.parametrize("every", [False, True])
@pytest.mark.parametrize("shape", REL4_EDGES + [(2, 2048, 2048),
                                                (2, 2000, 8000)])
def test_rel_kernels_at_segment_edges(dev, shape, every):
    """K2 (rel4 and rel) against its plain version, exactly, at rel4's
    segment edges (``rel4_edge_counters``) and at the main path's block
    and group shapes, masked and not, with the baselines read in place as
    row slices of wider tensors and contiguous; one launch a pack."""
    rng = np.random.default_rng(sum(shape) + every)
    g, m, n = shape
    c, rb, cb, cc = (torch.from_numpy(a).to(dev)
                     for a in rel4_edge_counters(rng, g, m, n, every))
    wide_rb = torch.zeros((g, m + 9), dtype=torch.int32, device=dev)
    wide_cb = torch.zeros((g, n + 5), dtype=torch.int32, device=dev)
    wide_rb[:, 4:4 + m] = rb
    wide_cb[:, 3:3 + n] = cb
    for rbs, cbs in ((rb, cb), (wide_rb[:, 4:4 + m], wide_cb[:, 3:3 + n])):
        for i0, j0, nv, diag in ((0, 0, None, None),
                                 (3, 1, (3 + m - 2, 1 + n - 3), 2)):
            before = (packing.LAUNCHES_REL4, packing.LAUNCHES_REL)
            got = packing.pack_rel4_cuda(c, rbs, cbs, cc, i0, j0, nv, diag)
            torch.cuda.synchronize()
            mask = packing.block_mask(m, n, i0, j0, nv or (i0 + m, j0 + n),
                                      diag, dev)
            want = packing.pack_rel4_torch(c, rb, cb, cc, mask)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (i0, j0, nv, diag)
            got = packing.pack_rel_cuda(c, rbs, cbs, cc, i0, j0, diag)
            torch.cuda.synchronize()
            mask = packing.block_mask(m, n, i0, j0, None, diag, dev)
            assert torch.equal(got, packing.pack_rel_torch(c, rb, cb, cc,
                                                           mask))
            assert (packing.LAUNCHES_REL4, packing.LAUNCHES_REL) == (
                before[0] + 1, before[1] + 1)


def test_pack_kernels_take_odd_columns_under_rel_only(dev):
    rng = np.random.default_rng(33)
    c = torch.from_numpy(outlier_counters(rng, 2, 31, 33)).to(dev)
    rb = torch.zeros((2, 31), dtype=torch.int32, device=dev)
    cb = torch.zeros((2, 33), dtype=torch.int32, device=dev)
    cc = torch.zeros(2, dtype=torch.int32, device=dev)
    got = packing.pack_rel(c, rb, cb, cc)
    torch.cuda.synchronize()
    assert torch.equal(got, packing.pack_rel_torch(c, rb, cb, cc))
    with pytest.raises(ValueError, match="odd"):
        packing.pack_rel4(c, rb, cb, cc)


def test_pack_kernels_count_launches(dev):
    z = torch.zeros((1, 4, 4), dtype=torch.int32, device=dev)
    b = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    cc = torch.zeros(1, dtype=torch.int32, device=dev)
    before = (packing.LAUNCHES_REL4, packing.LAUNCHES_REL)
    packing.pack_rel4(z, b, b, cc)
    packing.pack_rel(z, b, b, cc)
    assert (packing.LAUNCHES_REL4, packing.LAUNCHES_REL) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("n_diffs", [0, 1, 777, 4096])
def test_diff_rebuild_matches_plain(dev, n_diffs):
    """K3 against its plain version: no diffs, some, and as many as the
    capacity; pad rows hold the reference row, and the out-of-range tail
    is dropped."""
    rng = np.random.default_rng(n_diffs)
    rows, l_pad = 40, 384
    ref = torch.from_numpy(random_codes(rng, 1, l_pad)[0]).to(dev)
    cap = diffup._round_cap(n_diffs)
    idx = np.empty(cap, dtype=np.int32)
    idx[:n_diffs] = np.sort(rng.choice((rows - 3) * l_pad, n_diffs,
                                       replace=False))
    idx[n_diffs:] = np.arange(rows * l_pad, rows * l_pad + cap - n_diffs)
    vals = np.zeros(cap, dtype=np.uint8)
    vals[:n_diffs] = rng.choice(ALL_CODES, n_diffs)
    args = (ref, torch.from_numpy(idx).to(dev),
            torch.from_numpy(vals).to(dev), rows)
    before = diffup.LAUNCHES
    got = diffup.diff_rebuild_cuda(*args)
    torch.cuda.synchronize()
    assert diffup.LAUNCHES == before + 1
    want = diffup.diff_rebuild_torch(*args)
    assert torch.equal(got, want)
    assert bool((got[rows - 3:] == ref).all())


# The edges of K3 (``csrc/diffup.cu``): it cuts the flat output into
# parts of whole 128-byte lines, one a CTA, and a part into tiles of
# K3_TILE bytes from its start, so the diffs on the first and last byte of
# every 16-byte word of a row meet every part and tile edge in that row.
# ``tests/test_torch_diffup.py`` holds the plain version to the JAX
# ``_build_fn`` at the small ones.
K3_TILE = 16384
K3_EDGES = ("l_pad 128", "l_pad 29952", "l_pad 65664", "rows 0", "rows 1",
            "cap 0", "all tail", "full row", "first and last bytes",
            "empty tile beside full")
K3_CARD_EDGES = ("negative indices", "4194305 rows", "under 2^31")


def k3_encoding(rng, rows: int, l_pad: int, flat) -> tuple:
    """Sorted, unique int32 indices ``flat`` with random codes, padded to
    the encoder's capacity with its strictly increasing tail at and past
    rows * l_pad."""
    flat = np.unique(np.asarray(flat, dtype=np.int64))
    n = flat.size
    assert not n or 0 <= flat[0] <= flat[-1] < rows * l_pad
    cap = diffup._round_cap(n)
    idx = np.empty(cap, dtype=np.int32)
    idx[:n] = flat
    idx[n:] = np.arange(rows * l_pad, rows * l_pad + cap - n)
    vals = np.zeros(cap, dtype=np.uint8)
    vals[:n] = rng.choice(ALL_CODES, n)
    return idx, vals


def k3_edge_case(name: str, rng) -> tuple:
    """(ref, idx, vals, rows) of one of K3_EDGES or K3_CARD_EDGES."""
    rows, l_pad = {"l_pad 128": (37, 128), "l_pad 29952": (5, 29952),
                   "l_pad 65664": (3, 65664), "rows 0": (0, 256),
                   "rows 1": (1, 384), "cap 0": (9, 256),
                   "all tail": (11, 256), "full row": (4, 29952),
                   "first and last bytes": (6, 29952),
                   "empty tile beside full": (3, 29952),
                   "negative indices": (7, 384),
                   "4194305 rows": (4_194_305, 128),
                   "under 2^31": ((2**31 - 8192) // 29952, 29952)}[name]
    ref = random_codes(rng, 1, l_pad)[0]
    total = rows * l_pad

    def some():  # one flat index in 20 (small matrices only)
        return rng.choice(total, size=total // 20 + 1, replace=False)

    if name in ("rows 0", "all tail"):
        flat = []
    elif name == "cap 0":
        return (ref, np.zeros(0, np.int32), np.zeros(0, np.uint8), rows)
    elif name == "full row":
        flat = np.concatenate([some()[:40], 2 * l_pad + np.arange(l_pad)])
    elif name == "first and last bytes":
        starts = np.arange(rows) * l_pad
        cols = np.arange(K3_TILE, l_pad, K3_TILE)
        tiles = np.arange(K3_TILE, total, K3_TILE)
        words = 3 * l_pad + np.arange(0, l_pad, 16)
        flat = np.concatenate([starts, starts + l_pad - 1,
                               (starts[:, None] + cols).ravel(),
                               (starts[:, None] + cols - 1).ravel(),
                               tiles, tiles - 1, words, words + 15])
    elif name == "empty tile beside full":
        flat = np.concatenate([l_pad + np.arange(K3_TILE),
                               2 * l_pad + K3_TILE + np.arange(50)])
    elif name == "4194305 rows":
        flat = rng.choice(total, size=1 << 20, replace=False)
    elif name == "under 2^31":
        flat = np.concatenate([[0, l_pad - 1, total - l_pad, total - 1],
                               rng.choice(total, size=5000, replace=False)])
    else:
        flat = some()
    idx, vals = k3_encoding(rng, rows, l_pad, flat)
    if name == "negative indices":
        idx[:3] = (-(2**31), -5, -1)
    return ref, idx, vals, rows


@pytest.mark.parametrize("case", K3_EDGES + K3_CARD_EDGES)
def test_diff_rebuild_at_edges(dev, case):
    """K3 byte-equal to its plain version at its edges: widths of one
    partial tile, of the bench and of more than one tile and 48 KB; 0, 1
    and 4,194,305 rows (many rows a CTA); no diffs, a capacity all tail;
    a row all diffs; diffs on the first and last byte of every row, tile
    and 16-byte word; an empty tile beside a full one; negative indices
    (dropped); and a matrix just under 2^31 bytes, int32's limit."""
    ref, idx, vals, rows = k3_edge_case(case, np.random.default_rng(77))
    args = (torch.from_numpy(ref).to(dev), torch.from_numpy(idx).to(dev),
            torch.from_numpy(vals).to(dev), rows)
    got = diffup.diff_rebuild_cuda(*args)
    torch.cuda.synchronize()
    want = diffup.diff_rebuild_torch(*args)
    assert got.shape == want.shape == (rows, ref.size)
    assert torch.equal(got, want)


def test_diff_upload_on_card_equals_dense(dev, monkeypatch):
    """A low-diversity matrix sent diff-encoded to the card rebuilds to
    the dense matrix on its real rows."""
    monkeypatch.setenv("DISTANCE_TPU_DIFF_UPLOAD", "force")
    rng = np.random.default_rng(34)
    ref = random_codes(rng, 1, 512)[0]
    padded = np.repeat(ref[None], 700, axis=0)
    hits = rng.random(padded.shape) < 0.01
    padded[hits] = rng.choice(ALL_CODES, size=int(hits.sum()))
    padded[650:] = 0  # pad rows
    up = diffup.DiffUploader(ref, dev)
    enc = up.encode(padded, n_real=650)
    assert enc is not None
    got = up.upload_encoded(enc, 700).cpu().numpy()
    np.testing.assert_array_equal(got[:650], padded[:650])
    np.testing.assert_array_equal(got[650:], np.repeat(ref[None], 50, 0))


@pytest.mark.parametrize("mode", ["square", "stream"])
def test_ladder_on_card_equals_torch(dev, tmp_path, mode):
    """Random records whose residuals saturate: the card's blocks walk
    rel4 -> rel -> wide (400 sites) and the bytes are the plain
    version's."""
    rng = np.random.default_rng(35)
    mat = random_codes(rng, 300, 400)
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    write_fasta(a, mat[:150])
    write_fasta(b, mat[150:])
    args = [str(a)] + ([] if mode == "square" else ["-s", str(b)])
    outs = {}
    for backend in ("cuda", "torch"):
        outs[backend] = tmp_path / f"{backend}.tsv"
        before = dict(engine.RUNG_BLOCKS)
        assert cli.main(args + ["-m", "raw", "--backend", backend, "-o",
                                str(outs[backend])]) == 0
        assert all(engine.RUNG_BLOCKS[k] > before[k]
                   for k in ("rel4", "rel", "wide"))
        assert engine.RUNG_BLOCKS["none"] == before["none"]
    assert outs["cuda"].read_bytes() == outs["torch"].read_bytes()


def lane_counters(rng, g, m, n, width):
    """int32 counters whose narrow lanes fall on either side of 255, with
    a few cells far outside every lane (negative, past 2^16)."""
    c = rng.integers(0, min(width, 600) + 2, size=(g, m, n)).astype(np.int32)
    flat = c.reshape(g, -1)
    for k, v in enumerate([254, 255, 256, 0, width, width - 255, -1, 70000]):
        flat[:, k % flat.shape[1]] = v
    return c


@pytest.mark.parametrize("width", [1, 29904, 65535])
@pytest.mark.parametrize("shape", [(1, 1), (33, 65), (2048, 2048),
                                   (2000, 8000)])
@pytest.mark.parametrize("measure", MEASURES)
def test_narrow_and_wide_kernels_match_plain(dev, measure, shape, width):
    """K4 against its plain version, byte for byte: the square's block and
    the stream's group, ragged shapes, saturating cells."""
    rng = np.random.default_rng(sum(shape) + width)
    g = len(get_plan(measure).counters)
    c = torch.from_numpy(lane_counters(rng, g, *shape, width)).to(dev)
    before = (packing.LAUNCHES_NARROW, packing.LAUNCHES_WIDE)
    got = packing.pack_narrow(measure, c, width)
    torch.cuda.synchronize()
    want = packing.pack_narrow_torch(measure, c, width)
    assert got.dtype == want.dtype and torch.equal(got, want)
    got = packing.pack_wide(measure, c)
    torch.cuda.synchronize()
    want = packing.pack_wide_torch(measure, c)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert (packing.LAUNCHES_NARROW, packing.LAUNCHES_WIDE) == (
        before[0] + 1, before[1] + 1)


def test_out_of_core_packed_square_equals_in_core(dev, tmp_path,
                                                  monkeypatch):
    """A low-diversity square out of core on the card (diff uploads and
    rel4 on, several X groups and super-rows) writes the in-core run's
    sha256; its blocks were packed and its codes diff-encoded."""
    import hashlib

    rng = np.random.default_rng(36)
    anc = random_codes(rng, 1, 1000)
    mat = np.repeat(anc, 300, axis=0)
    hits = rng.random(mat.shape) < 0.01
    mat[hits] = rng.choice(ALL_CODES, size=int(hits.sum()))
    a = tmp_path / "a.fasta"
    write_fasta(a, mat)
    monkeypatch.setattr(engine, "TILE_I", 64)
    monkeypatch.setattr(engine, "TILE_J", 64)
    shas = []
    for budget in (0, 600_000):
        monkeypatch.setattr(engine, "DEVICE_BUDGET", budget)
        out = tmp_path / f"{budget}.tsv"
        before = (dict(engine.RUNG_BLOCKS), diffup.LAUNCHES)
        assert cli.main([str(a), "-m", "tn93", "--backend", "cuda", "-o",
                         str(out)]) == 0
        assert engine.RUNG_BLOCKS["rel4"] > before[0]["rel4"]
        assert diffup.LAUNCHES > before[1]
        shas.append(hashlib.sha256(out.read_bytes()).hexdigest())
    assert shas[0] == shas[1]


# The edges of K5 (``csrc/features.cu``), (rows, sites): 16-site pieces
# whole, ragged and at the bench width, no rows, one row.
K5_EDGES = [(37, 16), (37, 4095), (9, 29952), (0, 128), (1, 128),
            (1, 29952), (300, 31)]
# The edges of K6 (``csrc/contract.cu``), (x rows, y rows, sites): either
# side of its 128 x 256 tile at either side of a 32-site k-step and of a
# 64-site stage, an empty side, and the rel baselines' one-row sides.
K6_EDGES = ([(m, n, w) for m in (127, 128, 129) for n in (255, 256, 257)
             for w in (31, 32, 33, 4095)]
            + [(0, 5, 128), (6, 0, 128), (3000, 1, 640), (1, 3000, 640),
               (1, 1, 640), (13, 7, 200)])
# Both forms of a plan K6 contracts: the JAX plan's own channels (the
# engine's), and K1's folded channels (measured beside it).
CACHED_FORMS = {"jax": cached_plan_to_torch, "folded": fold_cached}


@pytest.mark.parametrize("measure", MEASURES)
def test_features_kernel_matches_plain(dev, measure):
    """K5 byte-equal to the LUT lookup on both sides: code 0 and every
    Paradis code in every position of a 16-site piece, and K5_EDGES."""
    rng = np.random.default_rng(41)
    plan = cached_plan_to_torch(get_plan(measure), dev)
    codes = np.concatenate([[0], ALL_CODES]).astype(np.uint8)
    truth = np.stack([np.roll(codes, s)[:16] for s in range(codes.size)])
    cases = [truth] + [random_codes(rng, m, w) for m, w in K5_EDGES]
    before = cached.LAUNCHES_FEATURES
    for c in cases:
        x = torch.from_numpy(c).to(dev)
        for side in ("f", "g"):
            got = cached.features_cuda(x, plan, side)
            torch.cuda.synchronize()
            assert torch.equal(got, cached.features_torch(x, plan, side)), (
                c.shape, side)
    assert cached.LAUNCHES_FEATURES == before + 2 * sum(
        1 for c in cases if c.size)


@pytest.mark.parametrize("form", sorted(CACHED_FORMS))
@pytest.mark.parametrize("measure", MEASURES)
def test_contract_kernel_matches_plain(dev, measure, form):
    """K6 equal to its plain version at K6_EDGES, and the counters equal
    K1's plain version of the same codes."""
    rng = np.random.default_rng(42)
    plan = CACHED_FORMS[form](get_plan(measure), dev)
    kp = plan_to_torch(get_plan(measure), dev)
    for m, n, width in K6_EDGES:
        x = torch.from_numpy(random_codes(rng, m, width)).to(dev)
        y = torch.from_numpy(random_codes(rng, n, width)).to(dev)
        fx = cached.features_torch(x, plan, "f")
        gy = cached.features_torch(y, plan, "g")
        got = cached.contract_cuda(fx, gy, plan)
        torch.cuda.synchronize()
        want = cached.contract_torch(fx, gy, plan)
        assert torch.equal(got, want), (m, n, width)
        assert torch.equal(want, kernels.counters_torch(x, y, kp)), (
            m, n, width)


@pytest.mark.parametrize("measure", MEASURES)
def test_contract_kernel_reads_cache_slices(dev, measure):
    """A strip of an f cache at i0 > 0 against a block of a g cache at
    j0 > 0, both read in place at their channel and row strides, and
    counters_cached: equal to the plain version on compact copies."""
    rng = np.random.default_rng(43)
    plan = cached_plan_to_torch(get_plan(measure), dev)
    codes = torch.from_numpy(random_codes(rng, 900, 640)).to(dev)
    f_cache = cached.features_cuda(codes, plan, "f")
    g_cache = cached.features_cuda(codes, plan, "g")
    fx, gy = f_cache[:, 128:384], g_cache[:, 512:768]
    assert not gy.is_contiguous()
    before = cached.LAUNCHES_CONTRACT
    got = cached.contract_cuda(fx, gy, plan)
    assert cached.LAUNCHES_CONTRACT == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, cached.contract_torch(fx.contiguous(),
                                                  gy.contiguous(), plan))
    both = cached.counters_cached(codes[128:384], codes[512:768], plan)
    assert torch.equal(both, got)


def test_cached_kernels_past_2_31_bytes(dev):
    """raw's g cache of 4096 x 29952 is 18 x 4096 x 29952 bytes, past
    2^31: K5 builds all of it, and K6 reads its last rows at offsets past
    2^31."""
    rng = np.random.default_rng(44)
    plan = cached_plan_to_torch(get_plan("raw"), dev)
    codes = torch.from_numpy(random_codes(rng, 4096, 29952)).to(dev)
    g = cached.features_cuda(codes, plan, "g")
    assert g.numel() > 1 << 31
    torch.cuda.synchronize()
    assert torch.equal(g, cached.features_torch(codes, plan, "g"))
    fx = cached.features_cuda(codes[:129], plan, "f")
    gy = g[:, 3800:]
    got = cached.contract_cuda(fx, gy, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, cached.contract_torch(fx, gy, plan))


def test_cached_wrappers_refuse_what_they_do_not_take(dev):
    plan = cached_plan_to_torch(get_plan("tn93"), dev)
    codes = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    fx = cached.features(codes, plan, "f")
    before = (cached.LAUNCHES_FEATURES, cached.LAUNCHES_CONTRACT)
    with pytest.raises(ValueError, match="plan tables"):
        cached.features_cuda(codes, cached_plan_to_torch(get_plan("tn93"),
                                                         "cpu"), "f")
    with pytest.raises(ValueError, match="int8"):
        cached.contract_cuda(fx.to(torch.int32), fx, plan)
    with pytest.raises(ValueError, match="channels"):
        cached.contract_cuda(fx[:3], fx[:3], plan)
    assert (cached.LAUNCHES_FEATURES, cached.LAUNCHES_CONTRACT) == before


# -- the split engine: K2's windows and the engine on several devices --------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("shape", [(2, 33, 64), (4, 129, 264), (1, 100, 200),
                                   (2, 2048, 2048), (1, 2000, 8000)])
def test_windowed_rel4_kernel_matches_plain(dev, shape, k):
    """K2 rel4 on each part of a block split over k devices (the window of
    its columns, with the block's width) against its plain version, with
    the self-pairs and padding masked; the parts' lanes joined and their
    sidecars merged equal the whole block's launch."""
    rng = np.random.default_rng(sum(shape) + k)
    g, m, n = shape
    w = n // k
    c = torch.from_numpy(outlier_counters(rng, g, m, n)).to(dev)
    rb = torch.from_numpy(rng.integers(-3, 4, (g, m)).astype(np.int32)).to(dev)
    cb = torch.from_numpy(rng.integers(-3, 4, (g, n)).astype(np.int32)).to(dev)
    cc = torch.from_numpy(rng.integers(-3, 4, g).astype(np.int32)).to(dev)
    nv = (m - 1, n - 3)
    whole = packing.pack_rel4_cuda(c, rb, cb, cc, 3, 1, nv, 2)
    parts = []
    for d in range(k):
        cs, cbs = c[:, :, d * w:(d + 1) * w].contiguous(), cb[:, d * w:]
        got = packing.pack_rel4_cuda(cs, rb, cbs[:, :w], cc, 3, 1 + d * w,
                                     nv, 2, d * w, n)
        torch.cuda.synchronize()
        mask = packing.block_mask(m, w, 3, 1 + d * w, nv, 2, dev)
        want = packing.pack_rel4_torch(cs, rb, cbs[:, :w], cc, mask, d * w,
                                       n)
        for a, b in zip(got, want):
            assert torch.equal(a, b), d
        parts.append(got)
    idx, val = packing.merge_rel4_sidecars(
        torch.stack([p[1] for p in parts]), torch.stack([p[2] for p in parts]))
    assert torch.equal(torch.cat([p[0] for p in parts], dim=-1), whole[0])
    assert torch.equal(idx, whole[1]) and torch.equal(val, whole[2])


def split_devices(monkeypatch, devices):
    """The engine's cuda runs on ``devices``; torch runs on the CPU."""
    real = engine.devices_of
    monkeypatch.setattr(engine, "devices_of", lambda backend: list(devices)
                        if backend == "cuda" else real(backend))


@pytest.mark.parametrize("budget", [0, 30000])
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
@pytest.mark.parametrize("measure", ["raw", "tn93"])
def test_split_engine_on_card_equals_torch(dev, tmp_path, monkeypatch,
                                           measure, mode, budget):
    """The engine on [cuda:0, cuda:0] (two logical devices, each on its
    own stream), in core and out of core: the plain version's bytes, with
    twice the one-device run's counter-kernel blocks."""
    rng = np.random.default_rng(28)
    mat = random_codes(rng, 100, 300)
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    write_fasta(a, mat[:60])
    write_fasta(b, mat[60:])
    args = {"square": [str(a)], "rectangle": [str(a), str(b)],
            "stream": [str(a), "-s", str(b), "-b", "4"]}[mode]
    if budget:
        monkeypatch.setattr(engine, "DEVICE_BUDGET",
                            5000 if mode == "stream" else budget)
        monkeypatch.setattr(engine, "HOST_BUF_BUDGET", 20000)
    monkeypatch.setattr(engine, "TILE_I", 16)
    monkeypatch.setattr(engine, "TILE_J", 16)
    monkeypatch.setattr(engine, "STREAM_GROUP", 8)
    outs, blocks = {}, {}
    for name, devices in (("one", [dev]), ("two", [dev, dev])):
        split_devices(monkeypatch, devices)
        outs[name] = tmp_path / f"{name}.tsv"
        before = engine.K1_BLOCKS + engine.K6_BLOCKS
        assert cli.main(args + ["-m", measure, "--backend", "cuda", "-o",
                                str(outs[name])]) == 0
        blocks[name] = engine.K1_BLOCKS + engine.K6_BLOCKS - before
    torch_out = tmp_path / "torch.tsv"
    assert cli.main(args + ["-m", measure, "--backend", "torch", "-o",
                            str(torch_out)]) == 0
    assert outs["one"].read_bytes() == torch_out.read_bytes()
    assert outs["two"].read_bytes() == torch_out.read_bytes()
    assert blocks["two"] == 2 * blocks["one"] > 0


def test_split_engine_on_two_cards_equals_torch(tmp_path):
    """A lone process on a host of two or more cards takes every card: the
    plain version's bytes for the square, the rectangle and the stream."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(29)
    mat = random_codes(rng, 300, 500)
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    write_fasta(a, mat[:180])
    write_fasta(b, mat[180:])
    assert len(engine.devices_of("cuda")) == torch.cuda.device_count()
    for args in ([str(a)], [str(a), str(b)], [str(a), "-s", str(b)]):
        outs = []
        for backend in ("cuda", "torch"):
            out = tmp_path / f"{backend}.tsv"
            assert cli.main(args + ["-m", "tn93", "--backend", backend, "-o",
                                    str(out)]) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1], args


# K7's edges: (rows, width, row stride, first column) of row slices of a
# (rows, stride) code matrix: widths about the 16-byte word, 0 and 1 rows,
# rows at a stride past their width and starting off any boundary, and
# the tn93 square's upload chunk of the engine (H2D_CHUNK_BYTES rows of
# 29904 sites).
K7_EDGES = [(0, 16, 16, 0), (1, 0, 0, 0), (4, 0, 7, 3), (1, 1, 1, 0),
            (3, 15, 15, 0), (3, 16, 16, 0), (3, 17, 17, 0),
            (1, 29904, 29904, 0),
            (7, 17, 40, 3), (7, 29, 40, 5), (9, 200, 333, 1),
            (2, 4097, 4113, 15), ((32 << 20) // 29904, 29904, 29904, 0)]


def k7_input(dev, rows, width, stride, col0, seed=0):
    """A (rows, width) slice of a (rows, stride) matrix of every code and
    0, on ``dev``."""
    codes = np.concatenate([[0], ALL_CODES]).astype(np.uint8)
    full = np.random.default_rng(seed).choice(codes, size=(rows, stride))
    t = torch.from_numpy(full.astype(np.uint8)).to(dev)
    return t[:, col0 : col0 + width]


@pytest.mark.parametrize("case", K7_EDGES)
def test_base_count_kernel_matches_plain(dev, case):
    from distance_tpu_torch.ops import basecount

    codes = k7_input(dev, *case, seed=sum(case))
    before = basecount.LAUNCHES
    got = basecount.base_counts_cuda(codes)
    torch.cuda.synchronize()
    assert basecount.LAUNCHES == before + (case[0] > 0)
    assert got.dtype == torch.int32 and got.shape == (case[0], 4)
    assert torch.equal(got, basecount.base_counts_torch(codes))


def k8_counters(dev, measure, m, n, seed):
    """(G, m, n) int32 counters of ``measure``: small counts, so that
    zero sums, p = 0.75 (jc69) and p = 0.5 (k80) occur, and large ones."""
    g = len(get_plan(measure).counters)
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 5, size=(g, m, n))
    large = rng.integers(0, 30000, size=(g, m, n))
    pick = rng.random((1, m, n)) < 0.5
    return torch.from_numpy(
        np.where(pick, small, large).astype(np.int32)).to(dev)


def assert_bit_equal(got, want):
    """Equal float32 bits, NaN cells alike (whatever their payload)."""
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


# K8's shapes: one cell, the dry run's (16, 16 dp) outputs, ragged, and
# the timed 2048 x 2048; the counter rows of (16, 16), (16, 32) and
# 2048 x 2048 start on 16-byte boundaries (the kernel's 16-byte loads),
# those of (1, 1) and (129, 257) do not (its 4-byte ones).
K8_SHAPES = [(1, 1), (16, 16), (16, 32), (129, 257), (2048, 2048)]


@pytest.mark.parametrize("shape", K8_SHAPES)
@pytest.mark.parametrize("measure", MEASURES)
def test_estimate_kernel_matches_plain(dev, measure, shape):
    from distance_tpu_torch.ops import estimate

    c = k8_counters(dev, measure, *shape, seed=shape[0] * 7 + shape[1])
    before = estimate.LAUNCHES
    got = estimate.estimate_cuda(c, measure)
    torch.cuda.synchronize()
    assert estimate.LAUNCHES == before + 1
    want = estimate.estimate_torch(c, measure)
    assert got.dtype == torch.float32 and got.shape == shape
    assert_bit_equal(got, want)
    if measure in ("raw", "jc69", "k80", "tn93") and shape[0] >= 16:
        assert want.isnan().any()
    # a strided view of the counters is taken as its contiguous copy
    assert_bit_equal(estimate.estimate(c.transpose(1, 2), measure),
                     estimate.estimate_torch(c.transpose(1, 2), measure))


# How the partials and the output of a K8 launch lie: fresh tensors;
# inputs a cell past a 16-byte boundary, the output on one (quads loaded
# whole, stored as cells); both a cell past (a head of three cells, quads,
# a tail); partial 0 a cell past and the others not (every cell with
# 4-byte loads); a window at col0 = 1 of an output 5 columns wider.
K8_LAYOUTS = ["aligned", "offset-in", "offset-both", "mixed", "window"]
K8_SP = [1, 2, 4]


def offset_copy(t, cells: int = 1):
    """A contiguous copy of ``t`` that starts ``cells`` cells past its
    buffer's start."""
    buf = torch.empty(t.numel() + cells, dtype=t.dtype, device=t.device)
    view = buf[cells:].view(t.shape)
    view.copy_(t)
    return view


def k8_case(total, sp, layout, seed):
    """(partials, out, col0, the output's cells before the launch) of one
    K8 launch: ``sp`` partials on ``total``'s device whose int32 sum is
    ``total`` (G, m, n), drawn on the card from ``seed``, laid out as
    ``layout`` says; out None for a new output."""
    dev = total.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    left = total.long()
    parts = []
    for _ in range(sp - 1):
        u = torch.rand(left.shape, generator=gen, device=dev)
        part = torch.minimum((u * (left + 1)).floor().long(), left)
        parts.append(part.int())
        left = left - part
    parts.append(left.int())
    out, col0 = None, 0
    if layout in ("offset-in", "offset-both"):
        parts = [offset_copy(p) for p in parts]
    elif layout == "mixed":
        parts[0] = offset_copy(parts[0])
    m, n = total.shape[1:]
    if layout == "offset-both":
        out = offset_copy(torch.full((m, n), 7.0, device=dev))
    elif layout == "window":
        out = torch.randn((m, n + 5), generator=gen, device=dev)
        col0 = 1
    return parts, out, col0, None if out is None else out.clone()


def check_k8_case(got, before, col0, want) -> bool:
    """Whether K8's output ``got`` holds ``want`` bit for bit (NaN cells
    alike) in its window and ``before`` outside it."""
    window = got[:, col0 : col0 + want.shape[1]]
    nan = want.isnan()
    if not (torch.equal(window.isnan(), nan) and torch.equal(
            window[~nan].view(torch.int32), want[~nan].view(torch.int32))):
        return False
    if before is None:
        return got.shape == want.shape
    outside = torch.ones_like(got, dtype=torch.bool)
    outside[:, col0 : col0 + want.shape[1]] = False
    return torch.equal(got[outside], before[outside])


@pytest.mark.parametrize("shape", K8_SHAPES)
@pytest.mark.parametrize("measure", MEASURES)
def test_estimate_partials_kernel_matches_plain(dev, measure, shape):
    """K8 over ``K8_SP`` partials in each of ``K8_LAYOUTS``: bit for bit
    the plain version's (the estimate of their sum), NaN cells alike, the
    cells outside a window untouched, one launch a call."""
    from distance_tpu_torch.ops import estimate

    seed = shape[0] * 7 + shape[1]
    total = k8_counters(dev, measure, *shape, seed=seed)
    for sp in K8_SP:
        for layout in K8_LAYOUTS:
            parts, out, col0, before = k8_case(total, sp, layout, seed + sp)
            launches = estimate.LAUNCHES
            got = estimate.estimate_partials_cuda(parts, measure, out, col0)
            torch.cuda.synchronize()
            assert estimate.LAUNCHES == launches + 1
            assert out is None or got is out
            assert torch.equal(sum(p.long() for p in parts), total.long())
            want = estimate.estimate_partials_torch(parts, measure)
            assert check_k8_case(got, before, col0, want), (sp, layout)


def test_dryrun_on_two_logical_devices(dev):
    """Both stages of the dry run on [cuda:0, cuda:0]: K5 + K6 on each
    device, K8 on the first, the split sweep's bytes the plain ones."""
    from distance_tpu_torch import dryrun
    from distance_tpu_torch.ops import estimate

    before = estimate.LAUNCHES
    dryrun.dryrun_multichip([dev, dev])
    assert estimate.LAUNCHES == before + 1
    fn, args = dryrun.entry(dev)
    got = fn(*args)
    assert torch.equal(got.cpu(), fn(*(a.cpu() for a in args)))


@pytest.mark.parametrize("dp, sp", [(1, 2), (2, 2), (3, 1)])
@pytest.mark.parametrize("measure", ["k80", "tn93"])
def test_sharded_step_on_card_one_k8_a_grid_row(dev, monkeypatch, measure,
                                                dp, sp):
    """The sharded step on a (dp, sp) grid of logical devices of the card,
    with ``sharded_counters`` made to raise: one K8 a grid row (windows
    of 18 columns, off any 16-byte boundary past the first), bit for bit
    the plain estimate of K1's counters."""
    from distance_tpu_torch import dryrun
    from distance_tpu_torch.ops import estimate
    from distance_tpu_torch.parallel import mesh

    x, y = dryrun._example_data(m=16, n=18 * dp, width=256 * sp, seed=dp)
    plan = plan_to_torch(get_plan(measure), dev)
    want = estimate.estimate_torch(kernels.counters_cuda(
        torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), plan),
        measure)

    def refuse(*args, **kwargs):
        raise AssertionError("sharded_step built the (G, m, n) total")

    monkeypatch.setattr(mesh, "sharded_counters", refuse)
    before = estimate.LAUNCHES
    got = mesh.sharded_step(measure, mesh.make_mesh([dev] * (dp * sp),
                                                    sp=sp))(x, y)
    torch.cuda.synchronize()
    assert estimate.LAUNCHES == before + dp
    assert check_k8_case(got, None, 0, want)


def test_tn93_device_base_count_on_card_equals_host(dev, tmp_path,
                                                    monkeypatch):
    """DISTANCE_TPU_BASECOUNT_DEVICE_MIN=0 counts the loaded rows by K7 (in
    uploads of a few rows), with the host count's bytes."""
    from distance_tpu_torch.ops import basecount

    rng = np.random.default_rng(30)
    a = tmp_path / "a.fasta"
    write_fasta(a, random_codes(rng, 77, 333))
    outs = {}
    for name, env in (("host", None), ("device", "0")):
        if env is not None:
            monkeypatch.setenv("DISTANCE_TPU_BASECOUNT_DEVICE_MIN", env)
            monkeypatch.setattr(engine, "H2D_CHUNK_BYTES", 333 * 10)
        before = basecount.LAUNCHES
        out = tmp_path / f"{name}.tsv"
        assert cli.main([str(a), "-m", "tn93", "-o", str(out)]) == 0
        outs[name] = out.read_bytes()
        assert basecount.LAUNCHES == before + (8 if env else 0)
    assert outs["host"] == outs["device"]


def test_fuzz_lattice_on_card_equals_torch(dev):
    """Twenty seeds of the fuzzer's lattice: --backend cuda under each
    configuration's knobs against --backend torch (phase 14 of
    chip_smoke.py runs 200)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / (
        "fuzz_differential_torch.py")
    spec = importlib.util.spec_from_file_location("fuzz_torch", path)
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    for seed in range(20):
        ok, cfg, detail = fuzz.fuzz_one(seed, "cuda")
        assert ok, (detail, cfg)
