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
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
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
