"""The tn93 base count on the device (K7's plain version) against the JAX
``base_counts_device``, and the engine's device count against the host
tally and the numpy CLI.

Every comparison is exact: the tallies are integers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu.ops.pairwise_xla import base_counts_device  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.encoding import ALL_CODES  # noqa: E402
from distance_tpu_torch.fastaio import Alignment  # noqa: E402
from distance_tpu_torch.ops import basecount  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402

# every code and the padding code 0
CODES = np.concatenate([[0], ALL_CODES]).astype(np.uint8)


def codes_of(rows, width, seed=0):
    return np.random.default_rng(seed).choice(
        CODES, size=(rows, width)).astype(np.uint8)


@pytest.mark.parametrize("width", [0, 1, 15, 16, 17, 29904])
@pytest.mark.parametrize("rows", [0, 1, 5])
def test_plain_base_counts_equal_jax(rows, width):
    codes = codes_of(rows, width, seed=rows * 100_000 + width)
    if rows:
        # the codes in order at the start of the first row, as many as fit
        codes[0, : len(CODES)] = CODES[:width]
    got = basecount.base_counts_torch(torch.from_numpy(codes))
    want = np.asarray(base_counts_device(jnp.asarray(codes)))
    assert got.dtype == torch.int32 and got.shape == (rows, 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("col0, width", [(0, 29), (3, 17), (5, 16), (1, 0)])
def test_plain_base_counts_of_row_slices_equal_jax(col0, width):
    """Rows that are slices of a wider matrix (a row stride past their
    width, a start off any boundary)."""
    wide = codes_of(7, 40, seed=col0 + width)
    view = torch.from_numpy(wide)[1::2, col0 : col0 + width]
    want = np.asarray(base_counts_device(jnp.asarray(
        np.ascontiguousarray(wide[1::2, col0 : col0 + width]))))
    np.testing.assert_array_equal(basecount.base_counts(view).numpy(), want)


def test_known_tallies():
    """The JAX test's rows: ACGTacgtNN- and eleven As."""
    from tests.test_counters import encode_all

    x = encode_all([("a", "ACGTacgtNN-"), ("b", "AAAAAAAAAAA")])
    got = basecount.base_counts(torch.from_numpy(x)).numpy()
    assert got.tolist() == [[2, 2, 2, 2], [11, 0, 0, 0]]


def test_the_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        basecount.base_counts_cuda(torch.zeros((2, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        basecount.base_counts(torch.zeros((2, 3), dtype=torch.int32))


def test_count_bases_device_matches_host(monkeypatch):
    """The engine's device count, in uploads of a few rows, equals the
    host tally (``tests/test_counters.py``'s JAX test)."""
    rng = np.random.default_rng(5)
    mat = rng.choice(ALL_CODES, size=(37, 200)).astype(np.uint8)
    aln = Alignment(ids=[], descriptions=[], matrix=mat)
    host = aln.count_bases().copy()
    monkeypatch.setattr(port_engine, "H2D_CHUNK_BYTES", 2000)
    seen = []
    real = basecount.base_counts

    def spy(codes):
        seen.append(codes.shape[0])
        return real(codes)

    monkeypatch.setattr(basecount, "base_counts", spy)
    dev = port_engine._count_bases_device(mat, torch.device("cpu"))
    assert dev.dtype == np.int32 and seen == [10, 10, 10, 7]
    np.testing.assert_array_equal(dev, host)
    monkeypatch.setattr(port_engine, "BASE_COUNT_DEVICE_MIN_BYTES", 0)
    aln2 = Alignment(ids=[], descriptions=[], matrix=mat)
    port_engine._count_bases_maybe_device(aln2, "torch")
    np.testing.assert_array_equal(aln2.base_counts, host)
    assert len(seen) == 8
    empty = port_engine._count_bases_device(np.zeros((0, 5), np.uint8),
                                            torch.device("cpu"))
    assert empty.shape == (0, 4) and empty.dtype == np.int32


def test_default_threshold_counts_on_the_host(monkeypatch):
    """Unset, the threshold is the JAX CLI's default (off): the host's
    native pass counts."""
    assert port_engine.BASE_COUNT_DEVICE_MIN_BYTES == 1 << 62
    monkeypatch.setattr(port_engine, "_count_bases_device", None)
    mat = codes_of(4, 30)
    aln = Alignment(ids=[], descriptions=[], matrix=mat)
    port_engine._count_bases_maybe_device(aln, "cuda")
    np.testing.assert_array_equal(aln.base_counts,
                                  Alignment(ids=[], descriptions=[],
                                            matrix=mat).count_bases())


@pytest.fixture
def fastas(tmp_path):
    rng = np.random.default_rng(83)
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    a.write_bytes(make_fasta(random_seqs(rng, 21, 150, amb_frac=0.2)))
    # upper case only: the stream's tn93 tallies count upper-case bytes
    b.write_bytes(make_fasta(
        (f"t{i}", s.upper())
        for i, (_, s) in enumerate(random_seqs(rng, 13, 150))))
    return str(a), str(b)


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_tn93_cli_counting_on_the_device_equals_numpy(tmp_path, fastas,
                                                      monkeypatch, mode):
    """DISTANCE_TPU_BASECOUNT_DEVICE_MIN=0 sends every loaded alignment's
    tallies through the device count (the plain version on the CPU), and
    the TSV stays the numpy CLI's byte for byte."""
    a, b = fastas
    args = {"square": [a], "rectangle": [a, b],
            "stream": [a, "-s", b, "-b", "4"]}[mode] + ["-m", "tn93"]
    want = tmp_path / "numpy.tsv"
    assert jax_cli.main([*args, "--backend", "numpy", "-o", str(want)]) == 0
    counted = []
    real = port_engine._count_bases_device

    def spy(matrix, device):
        counted.append((matrix.shape, device))
        return real(matrix, device)

    monkeypatch.setattr(port_engine, "_count_bases_device", spy)
    monkeypatch.setenv("DISTANCE_TPU_BASECOUNT_DEVICE_MIN", "0")
    got = tmp_path / "port.tsv"
    assert port_cli.main([*args, "--backend", "torch", "-o", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    cpu = torch.device("cpu")
    assert counted == [((21, 150), cpu)] + (
        [((13, 150), cpu)] if mode == "rectangle" else [])
    assert port_engine.BASE_COUNT_DEVICE_MIN_BYTES == 1 << 62  # restored


def test_device_count_without_a_card_is_an_error(tmp_path, fastas,
                                                 monkeypatch, capsys):
    """``--backend cuda`` with the device count on and no card exits 1;
    nothing falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DISTANCE_TPU_BASECOUNT_DEVICE_MIN", "0")
    a, _ = fastas
    out = tmp_path / "x.tsv"
    assert port_cli.main([a, "-m", "tn93", "-o", str(out)]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
