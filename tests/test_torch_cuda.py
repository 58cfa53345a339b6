"""The CUDA counter kernel on the card, against its plain version.

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
from distance_tpu_torch.ops.features import (  # noqa: E402
    get_plan,
    reference_counter_matrix,
)
from distance_tpu_torch.ops.plan import plan_to_torch  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


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
        before = kernels.LAUNCHES
        rc = cli.main([str(fasta), "-m", measure, "--backend", backend,
                       "-o", str(outs[backend])])
        assert rc == 0
        assert (kernels.LAUNCHES > before) == (backend == "cuda")
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
        before = kernels.LAUNCHES
        engine.run(setup)
        setup.writer.close()
        if backend == "cuda":
            assert kernels.LAUNCHES - before == 5 + 4 + 3 + 2 + 1
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
    and super-rows: K1 runs every block, and the bytes are the plain
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
        before = kernels.LAUNCHES
        rc = cli.main(args + ["-m", "tn93", "--backend", backend, "-o",
                              str(outs[backend])])
        assert rc == 0
        assert (kernels.LAUNCHES > before) == (backend == "cuda")
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
        before = kernels.LAUNCHES
        rc = cli.main(args + ["-m", measure, "--backend", backend, "-o",
                              str(outs[backend])])
        assert rc == 0
        launched = kernels.LAUNCHES - before
        if backend == "torch":
            assert launched == 0
        elif mode == "stream":
            assert launched == 11 * 2 + 1  # 11 batches of 7, then 3
    assert outs["cuda"].read_bytes() == outs["torch"].read_bytes()


@pytest.mark.parametrize("measure", MEASURES)
def test_stream_shards_on_card_merge_to_plain_bytes(dev, tmp_path,
                                                    monkeypatch, measure):
    """Two stream shards on the card (groups of 14 records: two -b 7
    batches, 22 groups in all, round-robin) merge to the plain version's
    unsharded bytes; each shard launches K1 once per group it owns."""
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
        before = kernels.LAUNCHES
        rc = cli.main(args + ["--backend", "cuda", "--shard", f"{k}/2",
                              "-o", parts[-1]])
        assert rc == 0
        launched.append(kernels.LAUNCHES - before)
    assert launched == [11, 11]
    merged, plain = tmp_path / "merged.tsv", tmp_path / "plain.tsv"
    assert cli.main(["--merge", *parts, "-o", str(merged)]) == 0
    assert cli.main(args + ["--backend", "torch", "-o", str(plain)]) == 0
    assert merged.read_bytes() == plain.read_bytes()
