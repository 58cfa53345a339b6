"""The plain reference against the port's own plain backend
(``--backend torch`` on the CPU), every line, at a tiny shape: six
measures, square, rectangle and stream.  The test may import the port;
the reference may not (test_bench_imports)."""

import os

import numpy as np
import pytest

from conftest import CELLS
from harness import inputs
from reference.distances import expected_lines, n_rows

MEASURES = ("n", "n_high", "raw", "jc69", "k80", "tn93")
IUPAC = np.frombuffer(b"ACGTACGTACGTRYKMSWBDHVN-?acgt", dtype=np.uint8)


def _alignment(n: int, sites: int, seed: int) -> np.ndarray:
    """An ancestor with mutations, ambiguity codes, N, gaps, '?' and lower
    case, so that every predicate of every measure is exercised."""
    rng = np.random.default_rng(seed)
    mat = np.tile(rng.choice(IUPAC[:4], size=sites), (n, 1))
    hits = rng.random((n, sites)) < 0.15
    mat[hits] = rng.choice(IUPAC, size=int(hits.sum()))
    return mat


def _port(argv, out):
    from distance_tpu_torch import cli

    assert cli.main(argv + ["-o", out, "--backend", "torch"]) == 0
    with open(out, "rb") as f:
        return f.read().split(b"\n")


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_reference_equals_port_every_line(tmp_path, mode, measure):
    n1, n2, sites = 23, 17, 211
    chars = _alignment(n1 + n2, sites, 4)
    ids = inputs.make_ids({"id_prefix": "EPI_ISL_", "id_digits": 7},
                          n1 + n2, 4)
    a, b = str(tmp_path / "a.fasta"), str(tmp_path / "b.fasta")
    if mode == "square":
        inputs.write_fasta(a, ids, chars)
        paths, argv, n2 = [a], [a], n1 + n2
        n1 = n2
    else:
        inputs.write_fasta(a, ids[:n1], chars[:n1])
        inputs.write_fasta(b, ids[n1:], chars[n1:])
        paths = [a, b]
        argv = [a, "-s", b] if mode == "stream" else [a, b]
    rows = n_rows(mode, n1, n2)
    got = _port(argv + ["-m", measure], str(tmp_path / "out.tsv"))
    assert got[-1] == b"" and len(got) == rows + 2
    want = expected_lines(measure, mode, paths, list(range(rows + 1)))
    assert [want[k] for k in range(rows + 1)] == got[:-1]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_port_on_the_cells_recipe(tiny, tmp_path, cell):
    tmp = tmp_path / "in"
    tmp.mkdir()
    job = inputs.build(tiny, tiny.cell(cell), 31, str(tmp))
    got = _port(job.argv, str(tmp_path / "out.tsv"))
    want = expected_lines(job.measure, job.mode, job.paths,
                          list(range(job.rows + 1)))
    assert [want[k] for k in range(job.rows + 1)] == got[:-1]
    assert os.path.getsize(job.paths[0]) > 0
