"""The HIV-1 pol configuration: its recipe's determinism, alphabet and
diversity; the port's plain backend against the NumPy reference on it,
through the pack's refetch and the tn93 memo's bail-out; the readers of
the refetch span and of the unkeyed emission."""

import json
import os

import numpy as np
import pytest

from conftest import tiny_copy
from harness import inputs, layout
from reference import measures
from reference.distances import counters, expected_lines, n_rows, tallies
from reference.encoding import ENCODE

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CONFIG = "hivpol-8k"
CELL = "hivpol-tn93"
# Enough records for two strips at the CPU's tile, so that the sweep
# pipelines strips and every block's rel4 pack saturates.
RECORDS = 640


def _recipe():
    lay = layout.Layout()
    cfg = lay.config(CONFIG)
    return lay.recipe(cfg["recipe"]), cfg


def _tn93(chars, i, j):
    c = counters(ENCODE[chars[i]], ENCODE[chars[j]])
    qt, tt = tallies(chars[i], True), tallies(chars[j], True)
    return np.array([measures.tn93(int(c["same"][k]), int(c["kk"][k]),
                                   int(c["p1"][k]), int(c["p2"][k]),
                                   qt[k], tt[k]) for k in range(len(i))])


def test_same_seed_same_matrix():
    recipe, cfg = _recipe()
    a = recipe.make(cfg, 200, 2 ** 31 + 9)
    np.testing.assert_array_equal(a, recipe.make(cfg, 200, 2 ** 31 + 9))
    assert not np.array_equal(a, recipe.make(cfg, 200, 2 ** 31 + 10))
    ids = inputs.make_ids(cfg, 200, 9)
    assert len(set(ids)) == 200
    assert all(len(i) == 8 and i.startswith(b"MN") for i in ids)


def test_shape_alphabet_and_mixtures():
    recipe, cfg = _recipe()
    chars = recipe.make(cfg, 2048, 41)
    assert chars.shape == (2048, 1302) and chars.dtype == np.uint8
    assert set(np.unique(chars).tobytes()) <= set(b"ACGTRYKMSWN-")
    share = {ch: float(np.mean(chars == ord(ch))) for ch in "ACGTRYN-"}
    assert 0.0035 < np.isin(chars, np.frombuffer(b"RYKMSW", np.uint8)
                            ).mean() < 0.0065
    assert share["R"] + share["Y"] > 0.0035
    assert 0 < share["N"] < 0.001 and 0 < share["-"] < 0.003
    assert share["A"] > max(share["C"], share["G"], share["T"])
    # gaps come in whole codons
    rows, cols = np.nonzero(chars == ord("-"))
    first = cols % 3 == 0
    assert 3 * first.sum() == len(cols)
    for d in (1, 2):
        assert np.all(chars[rows[first], cols[first] + d] == ord("-"))


def test_median_tn93_is_within_subtype_pol():
    """A median pairwise TN93 of 0.04-0.07, and a small share of pairs
    under HIV-TRACE's 0.015 link threshold."""
    recipe, cfg = _recipe()
    chars = recipe.make(cfg, 1024, 2 ** 31 + 3)
    rng = np.random.default_rng(0)
    i, j = rng.integers(0, 1024, (2, 3000))
    keep = i != j
    d = _tn93(chars, i[keep], j[keep])
    assert 0.04 <= np.median(d) <= 0.07
    assert 0 < np.mean(d < 0.015) < 0.05


@pytest.mark.parametrize("measure", ["tn93", "raw"])
def test_port_equals_reference_through_refetch_and_bail(tmp_path, measure):
    """Every line of the port's plain backend equals the reference's; the
    run took rel4's refetch at rel and, under tn93, the memo's bail-out,
    so that the test fails if the recipe stops reaching either."""
    from distance_tpu_torch import cli, engine
    from distance_tpu_torch.utils import timing

    recipe, cfg = _recipe()
    chars = recipe.make(cfg, RECORDS, 2 ** 31 + 24)
    path = str(tmp_path / "pol.fasta")
    inputs.write_fasta(path, inputs.make_ids(cfg, RECORDS, 24), chars)
    out = str(tmp_path / "out.tsv")
    before = engine.RUNG_BLOCKS["rel"]
    timing.reset()
    assert cli.main([path, "-m", measure, "-o", out,
                     "--backend", "torch"]) == 0
    assert engine.RUNG_BLOCKS["rel"] > before
    totals = timing.totals()
    assert totals["refetch"] > 0
    assert ("keys-bail" in totals) == (measure == "tn93")
    rows = n_rows("square", RECORDS, RECORDS)
    with open(out, "rb") as f:
        got = f.read().split(b"\n")
    assert got[-1] == b"" and len(got) == rows + 2
    want = expected_lines(measure, "square", [path], list(range(rows + 1)))
    assert [want[k] for k in range(rows + 1)] == got[:-1]


def _read(name, sample):
    with open(os.path.join(DATA, sample)) as f:
        return layout.Layout().metric(name).read(json.load(f))


@pytest.mark.parametrize("name, want", [
    ("sweep.refetch_s", (0.5 + 0.3) / 2),
    ("emit.unkeyed_s", (0.2 + 1.2 + 4.5 + 0.3 + 1.4 + 4.7) / 2),
])
def test_reader(name, want):
    assert _read(name, "unkeyed_record_sample.json") == pytest.approx(want)


@pytest.mark.parametrize("name", ["sweep.refetch_s", "emit.unkeyed_s"])
@pytest.mark.parametrize("sample", ["record_sample.json",
                                    "phase_record_sample.json"])
def test_reader_finds_nothing_without_them(name, sample):
    """Records of programs without the span and the total (the second
    has ``finalize`` and ``write:format`` but no ``keys-bail``) give
    nothing, and raise nothing."""
    assert _read(name, sample) is None


def test_the_metrics_are_listed_for_the_cell():
    spec = layout.Layout().spec
    for name, lay in (("sweep.refetch_s", "sweep"),
                      ("emit.unkeyed_s", "emission")):
        entry, = (m for m in spec["per_layer"] if m["name"] == name)
        assert entry["workloads"] == [CELL]
        assert (entry["layer"], entry["moves"]) == (lay, "pairs_per_s")
    cell, = (w for w in spec["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "square-tn93", 1)


def test_a_traced_run_reports_them(tmp_path):
    """run.py's traced run of the cell on the CPU, cut to two strips of
    records: correct, with both metrics read above 0."""
    import run

    bench = tiny_copy(str(tmp_path))
    path = os.path.join(bench, "configs", f"{CONFIG}.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(cfg, records=RECORDS, sites=1302), f)
    lay = layout.Layout(bench, str(tmp_path))
    result = run.run(lay, CELL, 2 ** 31 + 13, 0.5, True, backend="torch")
    assert result["correct"]
    for name in ("sweep.refetch_s", "emit.unkeyed_s"):
        assert result["metrics"][name]["value"] > 0
