"""The port's CLI writes the JAX CLI's bytes and errors.

Every run here is ``--backend torch`` (the plain version on the CPU),
held against ``distance --backend numpy`` and the serial oracle.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu.fastaio import load_fasta  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from tests.conftest import make_fasta, oracle_tsv, random_seqs  # noqa: E402


@pytest.fixture(autouse=True)
def _no_jit_cache(monkeypatch):
    # the JAX CLI would otherwise keep a compilation cache under $HOME
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")


def run_both(tmp_path, capsys, fasta: bytes, *args):
    """(rc, output bytes, stderr) of the port and of the JAX CLI."""
    path = tmp_path / "in.fasta"
    path.write_bytes(fasta)
    results = []
    for name, main, backend in (("port", port_cli.main, "torch"),
                                ("jax", jax_cli.main, "numpy")):
        out = tmp_path / f"{name}.tsv"
        capsys.readouterr()
        rc = main([str(path), *args, "--backend", backend, "-o", str(out)])
        err = capsys.readouterr().err
        results.append((rc, out.read_bytes() if out.exists() else None, err))
    return results


def oracle(fasta: bytes, measure: str) -> bytes:
    aln = load_fasta(io.BytesIO(fasta))
    if measure == "tn93":
        aln.count_bases()
    return oracle_tsv(measure, aln)


@pytest.mark.parametrize("measure", MEASURES)
def test_six_measures_byte_identical(tmp_path, capsys, measure):
    rng = np.random.default_rng(31)
    fasta = make_fasta(random_seqs(rng, 40, 300, amb_frac=0.3))
    port, jax = run_both(tmp_path, capsys, fasta, "-m", measure)
    assert port[0] == jax[0] == 0
    assert port[1] == jax[1] == oracle(fasta, measure)


def _args(path, measure, out):
    return port_cli.build_parser().parse_args(
        [str(path), "-m", measure, "--backend", "torch", "-o", str(out)]
    )


@pytest.mark.parametrize("measure", ["raw", "k80", "tn93"])
def test_small_tiles_give_several_strips_and_blocks(tmp_path, monkeypatch,
                                                    measure):
    rng = np.random.default_rng(32)
    fasta = make_fasta(random_seqs(rng, 50, 120, amb_frac=0.3))
    path = tmp_path / "in.fasta"
    path.write_bytes(fasta)
    calls = []
    real = port_engine._BlockEngine.block

    def spy(self, m1, m2, i0, j0, ti, tj, *packing):
        calls.append((i0, j0))
        return real(self, m1, m2, i0, j0, ti, tj, *packing)

    monkeypatch.setattr(port_engine._BlockEngine, "block", spy)
    out = tmp_path / "out.tsv"
    setup = port_engine.set_up(_args(path, measure, out))
    setup.tile_i = setup.tile_j = 16
    port_engine.run(setup)
    setup.writer.close()
    assert len({i0 for i0, _ in calls}) == 4  # strips at rows 0, 16, 32, 48
    assert len(calls) == 4 + 3 + 2 + 1
    assert out.read_bytes() == oracle(fasta, measure)


def test_low_diversity_engages_column_pruning(tmp_path, capsys,
                                              monkeypatch):
    rng = np.random.default_rng(33)
    recs = random_seqs(rng, 30, 400)
    # most columns invariant: keep mutations only in the first 40 sites
    anc = recs[0][1]
    recs = [(rid, s[:40] + anc[40:]) for rid, s in recs]
    fasta = make_fasta(recs)
    pruned = []
    real = port_engine._prune_invariant_columns

    def spy(mats):
        res = real(mats)
        pruned.append(res is not None)
        return res

    monkeypatch.setattr(port_engine, "_prune_invariant_columns", spy)
    for measure in ("raw", "tn93"):
        port, jax = run_both(tmp_path, capsys, fasta, "-m", measure)
        assert port[1] == jax[1] == oracle(fasta, measure)
    assert pruned == [True, True]


@pytest.mark.parametrize("n_records", [0, 1, 2])
def test_tiny_inputs_match_jax_cli(tmp_path, capsys, n_records):
    rng = np.random.default_rng(34)
    fasta = make_fasta(random_seqs(rng, n_records, 20)) if n_records else b""
    port, jax = run_both(tmp_path, capsys, fasta, "-m", "jc69")
    assert port == jax


@pytest.mark.parametrize(
    "fasta",
    [b">a\nACGT\n>b\nACG\n", b">a\nACGT\n>b\nACZT\n"],
    ids=["ragged", "invalid-nucleotide"],
)
def test_input_errors_match_jax_cli(tmp_path, capsys, fasta):
    port, jax = run_both(tmp_path, capsys, fasta)
    assert port[0] == jax[0] == 1
    assert port[2] == jax[2] and port[2].startswith("Error: Message(")


def test_shards_concatenate_to_unsharded(tmp_path):
    rng = np.random.default_rng(35)
    path = tmp_path / "in.fasta"
    path.write_bytes(make_fasta(random_seqs(rng, 60, 50, amb_frac=0.2)))
    outs = []
    for shard in (None, "0/2", "1/2"):
        out = tmp_path / f"out{shard and shard[0]}.tsv"
        args = _args(path, "raw", out)
        args.shard = shard
        setup = port_engine.set_up(args)
        setup.tile_i = setup.tile_j = 16
        port_engine.run(setup)
        setup.writer.close()
        outs.append(out.read_bytes())
    assert outs[1] and outs[2]
    assert outs[1] + outs[2] == outs[0]


def test_cuda_backend_without_device_fails_cleanly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rng = np.random.default_rng(36)
    path = tmp_path / "in.fasta"
    path.write_bytes(make_fasta(random_seqs(rng, 5, 20)))
    out = tmp_path / "out.tsv"
    rc = port_cli.main([str(path), "--backend", "cuda", "-o", str(out)])
    err = capsys.readouterr().err
    assert rc == 1
    assert "needs a CUDA device" in err
    assert not out.exists() or out.read_bytes() == b""


def test_resume_run_matches_and_clears_sidecar(tmp_path):
    rng = np.random.default_rng(38)
    fasta = make_fasta(random_seqs(rng, 20, 60, amb_frac=0.2))
    path = tmp_path / "in.fasta"
    path.write_bytes(fasta)
    out = tmp_path / "out.tsv"
    rc = port_cli.main([str(path), "-m", "k80", "--backend", "torch",
                        "--resume", "-o", str(out)])
    assert rc == 0
    assert out.read_bytes() == oracle(fasta, "k80")
    assert not (tmp_path / "out.tsv.progress").exists()


@pytest.mark.parametrize("ti, tj", [(8, 8), (8, 32), (32, 8), (16, 64)])
def test_prepared_rows_hold_every_block(ti, tj):
    """torch slicing past the end returns a shorter tensor (the JAX
    engine's dynamic_slice clamped instead): every block the square
    sweep launches must lie inside the prepared rows."""
    for n in range(2, 90):
        n_pad, l_pad = port_engine._padded_shape(n, 5, ti, max(ti, tj))
        assert l_pad == 128
        for i0 in range(0, n - 1, ti):
            assert i0 + ti <= n_pad
            for j0 in range(i0, n, tj):
                assert j0 + tj <= n_pad, (n, i0, j0)
