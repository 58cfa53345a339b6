"""The in-core square past the g cache, and the load sweep's fill.

A square whose g cache does not fit ``FEATCACHE_BUDGET`` takes K1 for
every block, as a SARS-CoV-2 square of more than 14,336 genomes does at
the default budget, and writes the cached path's bytes; on a card its
auto tile stays 2048, whose blocks rel4's sidecar is sized for.
``_sweep_load`` adds one ``load-fill`` total a job (its start to the
job's first hand-off to the emitter; no span); an out-of-core sweep adds
none.  Every run here is the port's CLI on ``--backend torch``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu_torch import cli  # noqa: E402
from distance_tpu_torch import engine  # noqa: E402
from distance_tpu_torch.ops import packing  # noqa: E402
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
from distance_tpu_torch.utils import timing  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402

N, N2, SITES = 40, 23, 90
# 8-row tiles: the square's 40 records make 5 strips, the rectangle's 5
TILE = 8
MODES = ["square", "rectangle"]
PATHS = ["cached", "k1"]


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    rng = np.random.default_rng(2020)
    d = tmp_path_factory.mktemp("fill")
    a, b = d / "a.fasta", d / "b.fasta"
    a.write_bytes(make_fasta(random_seqs(rng, N, SITES, amb_frac=0.2)))
    b.write_bytes(make_fasta(random_seqs(rng, N2, SITES, amb_frac=0.2)))
    return str(a), str(b)


@pytest.fixture(autouse=True)
def _tiles(monkeypatch):
    monkeypatch.setattr(engine, "TILE_I", TILE)
    monkeypatch.setattr(engine, "TILE_J", TILE)
    monkeypatch.delenv("DISTANCE_TPU_FEATCACHE_BUDGET", raising=False)


def take_path(monkeypatch, path):
    """K1 with a feature budget below the g cache (18 channels x 40 rows x
    128 padded sites), else the cached path's default budget."""
    if path == "k1":
        monkeypatch.setattr(engine, "FEATCACHE_BUDGET", 1000)


def job(tmp_path, fastas, mode, name="out.tsv"):
    """One raw job: (its TSV, its phase totals, its phase counts, the K1
    and K6 blocks it launched)."""
    a, b = fastas
    out = tmp_path / name
    k1, k6 = engine.K1_BLOCKS, engine.K6_BLOCKS
    timing.reset()
    argv = [a] + ([b] if mode == "rectangle" else [])
    assert cli.main(argv + ["-m", "raw", "--backend", "torch",
                            "-o", str(out)]) == 0
    return (out.read_bytes(), timing.totals(), dict(timing._COUNTS),
            engine.K1_BLOCKS - k1, engine.K6_BLOCKS - k6)


@pytest.mark.parametrize("mode", MODES)
def test_past_the_g_cache_k1_writes_the_cached_paths_bytes(
        tmp_path, monkeypatch, fastas, mode):
    cached, *_, c_k1, c_k6 = job(tmp_path, fastas, mode, "cached.tsv")
    assert c_k6 > 0
    take_path(monkeypatch, "k1")
    tsv, _, counts, k1, k6 = job(tmp_path, fastas, mode, "k1.tsv")
    strips = -(-(N - 1) // TILE)
    assert counts["dispatch"] == strips >= 3
    # the square's strip s has 5 - s blocks, the rectangle's 3 each
    assert k1 == (strips * (strips + 1) // 2 if mode == "square"
                  else strips * -(-N2 // TILE))
    assert k6 == 0 and tsv == cached


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mode", MODES)
def test_load_fill_is_one_total_a_job_within_the_sweep(
        tmp_path, monkeypatch, fastas, mode, path):
    take_path(monkeypatch, path)
    for _ in range(2):
        _, totals, counts, _, _ = job(tmp_path, fastas, mode)
        assert counts["load-fill"] == 1
        assert 0 < totals["load-fill"] <= totals["load-sweep"]


@pytest.mark.parametrize("mode", MODES)
def test_an_out_of_core_sweep_adds_no_fill(tmp_path, monkeypatch, fastas,
                                           mode):
    blocked = []
    real = engine._sweep_blocked

    def spy(*args, **kw):
        blocked.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(engine, "_sweep_blocked", spy)
    monkeypatch.setattr(engine, "DEVICE_BUDGET", 12000)
    _, totals, _, _, _ = job(tmp_path, fastas, mode)
    assert blocked == [1]
    assert "load-sweep" in totals and "load-fill" not in totals


@pytest.mark.parametrize("mode", MODES)
def test_recording_keeps_no_fill_span(tmp_path, fastas, mode):
    timing.take_spans()
    timing.record_spans(True)
    try:
        _, totals, _, _, _ = job(tmp_path, fastas, mode)
    finally:
        timing.record_spans(False)
    names = {s.name for s in timing.take_spans()}
    assert "load-sweep" in names and "load-fill" not in names
    assert totals["load-fill"] > 0


@pytest.mark.parametrize("n", [8192, 16384, 100_000])
def test_a_cards_auto_tile_keeps_rel4_segments_of_1024_cells(n):
    """A raw square's auto tiles on a card, whatever its records: rel4's
    sidecar segments hold 1,024 cells, as in the 8,192-genome square's
    2048² blocks (a 16,384-genome SARS-CoV-2 square at 4,096² blocks,
    segments of 4,096 cells, overflowed the sidecar in every strip)."""
    setup = types.SimpleNamespace(tile_i=0, tile_j=0, measure="raw",
                                  shard=None)
    ti, tj = engine._choose_tiles(n, n, setup, torch.device("cuda"))
    cells = len(get_plan("raw").counters) * ti * tj
    assert -(-cells // packing.REL4_SEGMENTS) <= 1024
