"""Rectangle and stream mode of the port write the JAX CLI's bytes.

Every port run here is ``--backend torch`` (the plain version on the
CPU), held against ``distance --backend numpy`` and the serial oracle
(``tests/conftest.py::oracle_tsv``) on seeded ``random_seqs`` fixtures.
"""

import io
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu.fastaio import load_fastas  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.fastaio import DistanceError  # noqa: E402
from tests.conftest import make_fasta, oracle_tsv, random_seqs  # noqa: E402


class _Boom(Exception):
    pass


@pytest.fixture(autouse=True)
def _no_jit_cache(monkeypatch):
    # the JAX CLI would otherwise keep a compilation cache under $HOME
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")


def low_diversity(rng, n, width, keep=12):
    """Records that differ from their ancestor only in the first ``keep``
    sites: most loaded columns are invariant."""
    recs = random_seqs(rng, n, width, amb_frac=0.3)
    anc = recs[0][1]
    return [(rid, s[:keep] + anc[keep:]) for rid, s in recs]


@pytest.fixture(scope="module")
def fastas():
    """(file1, file2) bytes: 13 and 29 ambiguity-rich records of 61 sites
    around different ancestors (the stream split stays off)."""
    rng = np.random.default_rng(41)
    return (make_fasta(random_seqs(rng, 13, 61, amb_frac=0.2)),
            make_fasta(random_seqs(rng, 29, 61, amb_frac=0.2)))


def write(tmp_path, *blobs):
    paths = []
    for k, blob in enumerate(blobs):
        path = tmp_path / f"in{k}.fasta"
        path.write_bytes(blob)
        paths.append(str(path))
    return paths


def run_both(tmp_path, capsys, args):
    """(rc, output bytes, stderr) of the port and of the JAX CLI."""
    results = []
    for name, main, backend in (("port", port_cli.main, "torch"),
                                ("jax", jax_cli.main, "numpy")):
        out = tmp_path / f"{name}.tsv"
        capsys.readouterr()
        rc = main([*args, "--backend", backend, "-o", str(out)])
        err = capsys.readouterr().err
        results.append((rc, out.read_bytes() if out.exists() else None, err))
    return results


def run_port(tmp_path, args):
    out = tmp_path / "port.tsv"
    rc = port_cli.main([*args, "--backend", "torch", "-o", str(out)])
    assert rc == 0
    return out.read_bytes()


def rect_oracle(measure, f1, f2):
    loaded = load_fastas([io.BytesIO(f1), io.BytesIO(f2)])
    if measure == "tn93":
        for a in loaded:
            a.count_bases()
    return oracle_tsv(measure, loaded[0], loaded[1])


def stream_oracle(measure, loaded_fa, stream_fa):
    loaded = load_fastas([io.BytesIO(loaded_fa)])[0]
    streamed = load_fastas([io.BytesIO(stream_fa)])[0]
    if measure == "tn93":
        loaded.count_bases()
        # streamed records tally upper-case 'A','T','G','C' bytes only
        # (the reference's quirk, tests/test_golden.py::test_stream_parity)
        blocks = re.findall(rb">\S+[^\n]*\n([^>]*)", stream_fa)
        streamed.base_counts = np.array(
            [[b.replace(b"\n", b"").count(c) for c in (b"A", b"T", b"G", b"C")]
             for b in blocks],
            dtype=np.int64,
        )
    return oracle_tsv(measure, loaded, streamed, stream_ids=streamed.ids)


def make_setup(args, tile=None):
    setup = port_engine.set_up(port_cli.build_parser().parse_args(
        [*args, "--backend", "torch"]
    ))
    if tile is not None:
        setup.tile_i, setup.tile_j = tile
    return setup


def run_setup(setup):
    try:
        port_engine.run(setup)
    finally:
        setup.writer.close()


def interrupt_after(monkeypatch, marks):
    """Make the port's checkpoint raise after ``marks`` checkpoints."""
    real = port_engine._progress_mark
    calls = []

    def bomb(setup, units):
        real(setup, units)
        calls.append(units)
        if len(calls) >= marks:
            raise _Boom()

    monkeypatch.setattr(port_engine, "_progress_mark", bomb)
    return real


# -- rectangle ---------------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
def test_rectangle_six_measures_byte_identical(tmp_path, capsys, fastas,
                                               measure):
    port, jax = run_both(tmp_path, capsys,
                         [*write(tmp_path, *fastas), "-m", measure])
    assert port[0] == jax[0] == 0
    assert port[1] == jax[1] == rect_oracle(measure, *fastas)


def test_rectangle_swapped_inputs(tmp_path, capsys, fastas):
    # lib.rs:1134-1153: swapping the two inputs swaps rows and columns
    f1, f2 = fastas
    port, jax = run_both(tmp_path, capsys,
                         [*write(tmp_path, f2, f1), "-m", "n_high"])
    assert port[1] == jax[1] == rect_oracle("n_high", f2, f1)


@pytest.mark.parametrize("ti, tj", [(8, 8), (8, 16), (16, 8)])
@pytest.mark.parametrize("measure", ["raw", "tn93"])
def test_rectangle_small_tiles_give_strips_and_blocks(tmp_path, monkeypatch,
                                                      fastas, ti, tj,
                                                      measure):
    calls = []
    real = port_engine._BlockEngine.block

    def spy(self, m1, m2, i0, j0, bi, bj, *packing):
        calls.append((i0, j0))
        return real(self, m1, m2, i0, j0, bi, bj, *packing)

    monkeypatch.setattr(port_engine._BlockEngine, "block", spy)
    out = tmp_path / "out.tsv"
    run_setup(make_setup([*write(tmp_path, *fastas), "-m", measure,
                          "-o", str(out)], tile=(ti, tj)))
    strips = -(-13 // ti)
    assert len({i0 for i0, _ in calls}) == strips
    assert len(calls) == strips * -(-29 // tj)
    assert out.read_bytes() == rect_oracle(measure, *fastas)


@pytest.mark.parametrize("ti, tj", [(8, 8), (8, 32), (32, 8), (16, 64)])
def test_rectangle_prepared_rows_hold_every_block(ti, tj):
    """file2 is prepared at the strip stride ti with max_block tj: every
    block of every strip lies inside both prepared matrices."""
    for n1 in range(1, 40):
        for n2 in range(1, 90):
            r1, _ = port_engine._padded_shape(n1, 5, ti, ti)
            r2, _ = port_engine._padded_shape(n2, 5, ti, tj)
            assert all(i0 + ti <= r1 for i0 in range(0, n1, ti))
            assert all(j0 + tj <= r2 for j0 in range(0, n2, tj)), (n2, ti)


@pytest.mark.parametrize("ti, tj", [(8, 32), (32, 8)])
def test_rectangle_footprint_counts_both_prepared_matrices(ti, tj):
    rng = np.random.default_rng(45)
    eng = port_engine._BlockEngine("raw", [torch.device("cpu")], ti, tj=tj)
    mats = [eng.prepare(rng.integers(0, 9, (n, 70), dtype=np.uint8), mb)
            for n, mb in ((21, ti), (53, tj))]
    strips = (port_engine.STRIP_LOOKAHEAD + 1) * 2 * ti * mats[1].shape[0] * 4
    rows = [m.shape[0] for m in mats]
    both = port_engine._blocked_footprint(rows[0], rows[1], 70, 2, ti, tj)
    assert both >= sum(m.numel() for m in mats) + strips
    # file1's rows: their upload (with a diff upload's transient) and
    # baselines, beside file2's footprint alone
    assert both - port_engine._blocked_footprint(0, rows[1], 70, 2, ti, tj) \
        == port_engine._upload_bytes(rows[0], mats[0].shape[1]) + 2 * 8 * rows[0]


def test_rectangle_shards_concatenate_to_unsharded(tmp_path, fastas):
    paths = write(tmp_path, *fastas)
    outs = []
    for shard in (None, "0/2", "1/2"):
        out = tmp_path / f"out{shard and shard[0]}.tsv"
        setup = make_setup([*paths, "-m", "k80", "-o", str(out)]
                           + (["--shard", shard] if shard else []),
                           tile=(4, 8))
        run_setup(setup)
        outs.append(out.read_bytes())
    assert outs[1] and outs[2]
    assert outs[1] + outs[2] == outs[0] == rect_oracle("k80", *fastas)


def test_rectangle_resume(tmp_path, monkeypatch, fastas):
    paths = write(tmp_path, *fastas)
    out = tmp_path / "out.tsv"
    args = [*paths, "-m", "jc69", "--resume", "-o", str(out)]
    real = interrupt_after(monkeypatch, 2)
    with pytest.raises(_Boom):
        run_setup(make_setup(args, tile=(4, 8)))
    monkeypatch.setattr(port_engine, "_progress_mark", real)
    sidecar = json.loads((tmp_path / "out.tsv.progress").read_text())
    assert sidecar["units_done"] == 2 and sidecar["config"]["mode"] == "load"
    run_setup(make_setup(args, tile=(4, 8)))
    assert out.read_bytes() == rect_oracle("jc69", *fastas)
    assert not (tmp_path / "out.tsv.progress").exists()


# -- stream ------------------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
def test_stream_six_measures_byte_identical(tmp_path, capsys, fastas,
                                            measure):
    f1, f2 = fastas
    a, b = write(tmp_path, f1, f2)
    port, jax = run_both(tmp_path, capsys, [a, "-s", b, "-m", measure])
    assert port[0] == jax[0] == 0
    assert port[1] == jax[1] == stream_oracle(measure, f1, f2)


@pytest.fixture(scope="module")
def group_case():
    """A low-diversity loaded file (the split engages) and 37 streamed
    records, with the oracle's stream TSV."""
    rng = np.random.default_rng(42)
    f1 = make_fasta(low_diversity(rng, 11, 70))
    f2 = make_fasta(random_seqs(rng, 37, 70, amb_frac=0.3))
    return f1, f2, stream_oracle("tn93", f1, f2)


@pytest.mark.parametrize("group", [2, 8, 64])
@pytest.mark.parametrize("batch", [1, 2, 5])
def test_stream_batch_and_group_sizes_give_one_output(tmp_path, monkeypatch,
                                                      group_case, batch,
                                                      group):
    f1, f2, want = group_case
    a, b = write(tmp_path, f1, f2)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", group)
    calls = []
    real = port_engine._BlockEngine.block

    def spy(self, m1, m2, i0, j0, bi, bj, *packing):
        calls.append(bj)
        return real(self, m1, m2, i0, j0, bi, bj, *packing)

    monkeypatch.setattr(port_engine._BlockEngine, "block", spy)
    got = run_port(tmp_path, [a, "-s", b, "-m", "tn93", "-b", str(batch)])
    assert got == want
    assert sum(calls) == 37 and max(calls) <= group


def test_auto_groups_hold_whole_batches_up_to_the_cap(tmp_path, monkeypatch):
    """The layout the card's smoke run asserts, at a narrow width: 16384
    records with -b 1000 form groups of 8000, 8000 and 384 records."""
    rng = np.random.default_rng(46)
    f1 = make_fasta(random_seqs(rng, 2, 8))
    f2 = make_fasta(random_seqs(rng, 16384, 8))
    calls = []
    real = port_engine._BlockEngine.block

    def spy(self, m1, m2, i0, j0, bi, bj, fx=None):
        calls.append(bj)  # K1 or K6 runs at first dispatches alone
        return real(self, m1, m2, i0, j0, bi, bj, fx)

    monkeypatch.setattr(port_engine._BlockEngine, "block", spy)
    a, b = write(tmp_path, f1, f2)
    run_port(tmp_path, [a, "-s", b, "-m", "raw", "-b", "1000"])
    assert port_engine.STREAM_GROUP_CAP == 8192
    assert calls == [8000, 8000, 384]


@pytest.mark.parametrize("n1, ram, want", [
    (2, 1 << 40, 8192),     # the cap
    # the host budget: 4 groups in flight x (2 + 2) int32 x 1000 loaded
    (1000, 500 * 64000, 500),
    (1000, 1 << 10, 2),     # never below 2
])
def test_cpu_group_size_follows_host_budget_and_cap(monkeypatch, n1, ram,
                                                    want):
    """The CPU has no device budget: its footprint is never refused, and
    its groups are sized from the host budget and the cap alone."""
    cpu = torch.device("cpu")
    assert port_engine._device_budget(cpu) is None
    monkeypatch.setattr(port_engine, "_strip_ram_budget", lambda: ram)
    assert port_engine._stream_group_size(n1, 29904, "raw", cpu) == want


@pytest.mark.parametrize("engaged", [True, False])
@pytest.mark.parametrize("measure", ["raw", "n", "tn93"])
def test_stream_split_engaged_and_not(tmp_path, capsys, monkeypatch, engaged,
                                      measure):
    rng = np.random.default_rng(43)
    loaded = (low_diversity(rng, 15, 90) if engaged
              else random_seqs(rng, 15, 90, amb_frac=0.3))
    f1 = make_fasta(loaded)
    f2 = make_fasta(random_seqs(rng, 20, 90, amb_frac=0.3))
    fracs = []
    real = port_engine._StreamSplit.__init__

    def spy(self, matrix, plan):
        real(self, matrix, plan)
        fracs.append(self.frac)

    monkeypatch.setattr(port_engine._StreamSplit, "__init__", spy)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 6)
    a, b = write(tmp_path, f1, f2)
    port, jax = run_both(tmp_path, capsys,
                         [a, "-s", b, "-m", measure, "-b", "4"])
    assert (fracs[0] >= port_engine.PRUNE_MIN_FRACTION) == engaged
    assert port[1] == jax[1] == stream_oracle(measure, f1, f2)


@pytest.mark.parametrize("batch", [1, 2])
def test_stream_mid_error_matches_jax_cli(tmp_path, capsys, monkeypatch,
                                          batch):
    """A bad streamed record: every fully read user batch is written, then
    the JAX CLI's error and exit 1 (tests/test_fuzz.py analog)."""
    rng = np.random.default_rng(44)
    f1 = make_fasta(random_seqs(rng, 6, 30))
    recs = random_seqs(rng, 9, 30)
    recs[5] = (recs[5][0], recs[5][1][:10] + "Z" + recs[5][1][11:])
    a, b = write(tmp_path, f1, make_fasta(recs))
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 2)
    port, jax = run_both(tmp_path, capsys, [a, "-s", b, "-m", "raw",
                                            "-b", str(batch)])
    assert port == jax
    assert port[0] == 1 and "Invalid nucleotide" in port[2]
    rows = port[1].decode().splitlines()[1:]
    assert len(rows) == 6 * (4 if batch == 2 else 5)


def test_stream_prepare_failure_surfaces(tmp_path, monkeypatch, fastas):
    def broken(self, matrix, max_block, diff_ref=None, **caches):
        raise _Boom("upload failed")

    monkeypatch.setattr(port_engine._BlockEngine, "prepare", broken)
    a, b = write(tmp_path, *fastas)
    with pytest.raises(_Boom, match="upload failed"):
        run_setup(make_setup([a, "-s", b, "-o", str(tmp_path / "o.tsv")]))


def test_empty_stream_matches_jax_cli(tmp_path, capsys, fastas):
    a, b = write(tmp_path, fastas[0], b"")
    port, jax = run_both(tmp_path, capsys, [a, "-s", b, "-m", "k80"])
    assert port == jax
    assert port[0] == 1 and port[2].startswith("Error: Message(")


def test_width_zero_stream_gives_the_python_stream_paths_tsv(tmp_path,
                                                              capsys,
                                                              monkeypatch):
    """The JAX package's native stream path divides by the width; the
    port's guarded copy gives what its pure-Python stream path gives."""
    a, b = write(tmp_path, b">a\n\n>b\n\n", b">s1\n\n>s2\n\n>s3\n\n")
    port_out = tmp_path / "port.tsv"
    rc = port_cli.main([a, "-s", b, "-b", "2", "--backend", "torch",
                        "-o", str(port_out)])
    assert rc == 0
    monkeypatch.setenv("DISTANCE_TPU_NO_NATIVE", "1")
    jax_out = tmp_path / "jax.tsv"
    assert jax_cli.main([a, "-s", b, "-b", "2", "--backend", "numpy",
                         "-o", str(jax_out)]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert port_out.read_bytes().count(b"\n") == 1 + 2 * 3


def stream_resume_args(tmp_path, fastas, out):
    a, b = write(tmp_path, *fastas)
    return [a, "-s", b, "-m", "tn93", "-b", "3", "--resume", "-o", str(out)]


def test_stream_resume(tmp_path, monkeypatch, fastas):
    out = tmp_path / "out.tsv"
    args = stream_resume_args(tmp_path, fastas, out)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 4)
    real = interrupt_after(monkeypatch, 3)
    with pytest.raises(_Boom):
        run_setup(make_setup(args))
    monkeypatch.setattr(port_engine, "_progress_mark", real)
    sidecar = json.loads((tmp_path / "out.tsv.progress").read_text())
    assert sidecar["units_done"] == 3
    assert {k: sidecar["config"][k] for k in
            ("mode", "batchsize", "stream_group")} == {
        "mode": "stream", "batchsize": 3, "stream_group": 4}
    run_setup(make_setup(args))
    assert out.read_bytes() == stream_oracle("tn93", *fastas)
    assert not (tmp_path / "out.tsv.progress").exists()


def test_stream_resume_refused_at_changed_group_size(tmp_path, monkeypatch,
                                                     fastas):
    out = tmp_path / "out.tsv"
    args = stream_resume_args(tmp_path, fastas, out)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 4)
    interrupt_after(monkeypatch, 1)
    with pytest.raises(_Boom):
        run_setup(make_setup(args))
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 8)
    with pytest.raises(DistanceError, match="Cannot resume"):
        run_setup(make_setup(args))


def test_square_sidecar_refused_by_stream(tmp_path, monkeypatch, fastas):
    out = tmp_path / "out.tsv"
    a, b = write(tmp_path, *fastas)
    interrupt_after(monkeypatch, 1)
    with pytest.raises(_Boom):
        run_setup(make_setup([a, "--resume", "-o", str(out)], tile=(4, 4)))
    with pytest.raises(DistanceError,
                       match="Cannot resume.*'mode': 'load'.*'mode': 'stream'"):
        run_setup(make_setup([a, "-s", b, "--resume", "-o", str(out)]))


# -- over the budget, and without a card -------------------------------------

@pytest.mark.parametrize(
    "mode, what",
    [("stream", "the staged stream"),
     ("rectangle", "the out-of-core rectangle sweep")],
)
def test_over_budget_runs_exit_1(tmp_path, capsys, monkeypatch, fastas, mode,
                                 what):
    """Over the device budget a run no longer exits 1: it goes out of core
    (tests/test_torch_outofcore.py), says so, and writes the JAX CLI's
    bytes."""
    a, b = write(tmp_path, *fastas)
    args = [a, "-s", b] if mode == "stream" else [a, b]
    jax_out = tmp_path / "jax.tsv"
    rc = jax_cli.main(args + ["--backend", "numpy", "-o", str(jax_out)])
    assert rc == 0
    monkeypatch.setattr(port_engine, "_device_budget",
                        lambda device, of_total=False: 1000)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 2)
    capsys.readouterr()
    rc = port_cli.main(args + ["--backend", "torch",
                               "-o", str(tmp_path / "o.tsv")])
    err = capsys.readouterr().err
    assert rc == 0
    assert what.removeprefix("the ") in err and "not yet ported" not in err
    assert (tmp_path / "o.tsv").read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("mode", ["rectangle", "stream"])
def test_cuda_backend_without_device_fails_before_input(tmp_path, capsys,
                                                        mode):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a, = write(tmp_path, b">a\nACGT\n")
    missing = str(tmp_path / "missing.fasta")
    args = [a, missing] if mode == "rectangle" else [a, "-s", missing]
    rc = port_cli.main(args + ["--backend", "cuda"])
    assert rc == 1
    assert "needs a CUDA device" in capsys.readouterr().err
