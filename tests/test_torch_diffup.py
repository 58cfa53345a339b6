"""The port's diff-encoded uploads (``distance_tpu_torch/ops/diffup.py``)
against the JAX package's ``distance_tpu/ops/diffup.py`` on the CPU.

The plain version of K3 must rebuild what ``_build_fn`` rebuilds; the
copied encoder must give the JAX encoder's (idx, vals), on its native
path and its numpy one; the reference rows must be the JAX rows; and the
stream's reference retarget must behave as the JAX engine's does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distance_tpu._native as jax_native  # noqa: E402
import distance_tpu.ops.diffup as jax_diffup  # noqa: E402
import distance_tpu_torch._native as port_native  # noqa: E402
import distance_tpu_torch.engine as port_engine  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch.encoding import ALL_CODES  # noqa: E402
from distance_tpu_torch.ops import diffup  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402
from tests.test_torch_cuda import K3_EDGES, k3_edge_case  # noqa: E402
from tests.test_golden import run_engine  # noqa: E402

CPU = torch.device("cpu")


def codes(rng, rows, width):
    return rng.choice(ALL_CODES, size=(rows, width)).astype(np.uint8)


def encoding(rng, rows, l_pad, n_diffs, tail_rows=0):
    """A sorted, unique, capacity-padded (idx, vals) with n_diffs diffs in
    the first rows - tail_rows rows, as the encoder pads it."""
    cap = diffup._round_cap(n_diffs)
    idx = np.empty(cap, dtype=np.int32)
    idx[:n_diffs] = np.sort(rng.choice((rows - tail_rows) * l_pad, n_diffs,
                                       replace=False))
    idx[n_diffs:] = np.arange(rows * l_pad, rows * l_pad + cap - n_diffs)
    vals = np.zeros(cap, dtype=np.uint8)
    vals[:n_diffs] = rng.choice(ALL_CODES, n_diffs)
    return idx, vals


@pytest.mark.parametrize("case", [pytest.param(n, id=str(n)) for n in
                                  (0, 1, 300, 4096, 4097)] + list(K3_EDGES))
def test_plain_rebuild_equals_build_fn(case):
    """0 diffs, some, capacity-many and one past a capacity: the rebuild
    equals the JAX scatter, its pad rows hold the reference row, and the
    out-of-range tail is dropped.  Then K3's edges (``K3_EDGES`` of the
    card tests, which hold the kernel to this plain version there): widths
    128, 29952 and 65664, 0 and 1 rows, no diffs, a capacity all tail, a
    row all diffs, the first and last bytes of rows, tiles and words, an
    empty tile beside a full one."""
    if isinstance(case, str):
        ref, idx, vals, rows = k3_edge_case(case, np.random.default_rng(77))
        l_pad, pad_rows = ref.size, 0
    else:
        rng = np.random.default_rng(case)
        rows, l_pad, pad_rows = 24, 256, 4
        ref = codes(rng, 1, l_pad)[0]
        idx, vals = encoding(rng, rows, l_pad, case, tail_rows=pad_rows)
    want = np.asarray(jax_diffup._build_fn(rows, l_pad, idx.size)(
        ref, idx, vals))
    got = diffup.diff_rebuild(torch.from_numpy(ref), torch.from_numpy(idx),
                              torch.from_numpy(vals), rows)
    assert got.shape == want.shape == (rows, l_pad)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[rows - pad_rows:],
                                  np.tile(ref, (pad_rows, 1)))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("case", ["low", "pad rows", "diverse", "forced",
                                  "disabled"])
def test_encoder_equals_jax(case, native, monkeypatch):
    """The copied encoder gives the JAX encoder's (idx, vals), or rejects
    the same batches, on the native path (512 rows or more) and the numpy
    one; DISTANCE_TPU_DIFF_UPLOAD=force accepts every batch and
    DISTANCE_TPU_NO_DIFF_UPLOAD rejects every batch."""
    if not native:
        monkeypatch.setattr(port_native, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    if case == "forced":
        monkeypatch.setenv("DISTANCE_TPU_DIFF_UPLOAD", "force")
    if case == "disabled":
        monkeypatch.setenv("DISTANCE_TPU_NO_DIFF_UPLOAD", "1")
    rng = np.random.default_rng(3)
    l_pad = 384
    ref = codes(rng, 1, l_pad)[0]
    rows = 700
    padded = np.repeat(ref[None], rows, 0)
    rate = 0.5 if case in ("diverse", "forced") else 0.01
    hits = rng.random(padded.shape) < rate
    padded[hits] = rng.choice(ALL_CODES, int(hits.sum()))
    n_real = rows
    if case == "pad rows":
        n_real = 600
        padded[n_real:] = 0
    for kw in ({"n_real": n_real}, {}):
        want = jax_diffup.DiffUploader(ref).encode(padded, **kw)
        got = diffup.DiffUploader(ref, CPU).encode(padded, **kw)
        assert (got is None) == (want is None)
        assert (got is None) == (case in ("diverse", "disabled"))
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("diverse", [False, True])
def test_upload_rebuilds_the_dense_rows(diverse, monkeypatch):
    """``upload`` of a low-diversity batch rebuilds it from its diffs
    (pad rows the reference row, as the JAX upload gives them); a diverse
    batch goes dense, pad rows zero."""
    rng = np.random.default_rng(4)
    ref = codes(rng, 1, 256)[0]
    padded = np.zeros((40, 256), dtype=np.uint8)
    padded[:30] = codes(rng, 30, 256) if diverse else np.repeat(
        ref[None], 30, 0)
    if not diverse:
        padded[3, 7] = ALL_CODES[0] if ref[7] != ALL_CODES[0] else ALL_CODES[1]
    got = diffup.DiffUploader(ref, CPU).upload(padded).numpy()
    want = np.asarray(jax_diffup.DiffUploader(ref).upload(padded))
    np.testing.assert_array_equal(got, want)
    pad = np.zeros((10, 256), np.uint8) if diverse else np.tile(ref, (10, 1))
    np.testing.assert_array_equal(got[30:], pad)


@pytest.mark.parametrize("rows", [0, 1, 2, 5, 64, 3000])
def test_mode_rows_equal_jax(rows):
    """``mode_row`` (majority columns settled by one comparison) and
    ``sampled_mode_row`` give the JAX rows: ties go to the code first in
    ALL_CODES, codes outside it (0) count nowhere."""
    rng = np.random.default_rng(rows)
    for pool_size in (1, 2, 3, 17):
        pool = rng.choice(ALL_CODES, pool_size, replace=False)
        if rows % 2:
            pool = np.concatenate([pool, [0]])
        mat = rng.choice(pool, size=(rows, 50)).astype(np.uint8)
        mat[:, :10] = mat[:1, :10]  # columns with a strict majority
        np.testing.assert_array_equal(diffup.mode_row(mat),
                                      jax_diffup.mode_row(mat))
        np.testing.assert_array_equal(diffup.sampled_mode_row(mat, cap=7),
                                      jax_diffup.sampled_mode_row(mat, cap=7))


def lineage(rng, anc, n, tag, width):
    nxt = {"A": "C", "C": "G", "G": "T", "T": "A"}
    recs = []
    for i in range(n):
        s = anc.copy()
        for p in rng.choice(width, 4, replace=False):
            s[p] = nxt[s[p]]
        recs.append((f"{tag}{i}", "".join(s)))
    return recs


def spy_encodes(monkeypatch, module):
    wins = []
    real = module.DiffUploader.encode

    def spy(self, padded, n_real=None):
        out = real(self, padded, n_real)
        wins.append(out is not None)
        return out

    monkeypatch.setattr(module.DiffUploader, "encode", spy)
    return wins


def port_tsv(tmp_path, measure, f1, f2, batch):
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    a.write_bytes(f1)
    b.write_bytes(f2)
    out = tmp_path / "port.tsv"
    assert port_cli.main([str(a), "-s", str(b), "-b", str(batch), "-m",
                          measure, "--backend", "torch", "-o",
                          str(out)]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("case", ["two lineages", "drifting", "diverse"])
def test_stream_retarget_equals_jax(case, tmp_path, monkeypatch):
    """The reference retarget against the JAX engine's, on the cases of
    tests/test_diffup.py: a stream of another lineage than the loaded set
    (one retarget, then every group encodes), a stream that switches
    lineage (a retarget at each switch), and a diverse stream (probing
    stops after RETARGET_FAIL_LIMIT failed candidates).  Full groups of 6
    records (the JAX engine pads a short group to 6 rows and weighs its
    diffs against that many dense bytes; the port sends a group's own
    rows); the TSV equals the JAX xla run's, and the sequence of encode
    outcomes is the JAX sequence."""
    rng = np.random.default_rng(41)
    width = 384
    ancs = [rng.choice(list("ACGT"), size=width) for _ in range(3)]
    if case == "diverse":
        f1 = make_fasta(random_seqs(rng, 6, 400, amb_frac=0.05))
        f2 = make_fasta(random_seqs(rng, 30, 400, amb_frac=0.05))
        measure = "raw"
    else:
        f1 = make_fasta(lineage(rng, ancs[0], 9, "a", width))
        tail = (lineage(rng, ancs[1], 12, "b", width)
                + lineage(rng, ancs[2], 12, "c", width)) if case == (
            "drifting") else lineage(rng, ancs[1], 24, "b", width)
        f2 = make_fasta(tail)
        measure = "n_high" if case == "drifting" else "tn93"
    monkeypatch.setenv("DISTANCE_TPU_STREAM_GROUP", "6")
    jax_wins = spy_encodes(monkeypatch, jax_diffup)
    want = run_engine(measure, f1, stream=f2, backend="xla", batchsize=3)[0]
    port_wins = spy_encodes(monkeypatch, diffup)
    got = port_tsv(tmp_path, measure, f1, f2, 3)
    assert got == want
    assert port_wins == jax_wins
    if case == "two lineages":
        rej = port_wins.index(False)
        assert all(port_wins[rej + 1:]), port_wins
    elif case == "drifting":
        assert port_wins.count(False) == 2, port_wins
    else:
        # the loaded side and five groups against the current reference,
        # and a failed candidate for each of the first
        # RETARGET_FAIL_LIMIT groups
        assert not any(port_wins)
        assert len(port_wins) == 1 + 5 + port_engine.RETARGET_FAIL_LIMIT


def test_retarget_limit_from_the_environment(tmp_path, monkeypatch):
    """DISTANCE_TPU_RETARGET_LIMIT=0 stops the probing at once: each
    diverse group is tried against the loaded reference only."""
    rng = np.random.default_rng(44)
    f1 = make_fasta(random_seqs(rng, 6, 400, amb_frac=0.05))
    f2 = make_fasta(random_seqs(rng, 30, 400, amb_frac=0.05))
    monkeypatch.setenv("DISTANCE_TPU_STREAM_GROUP", "6")
    monkeypatch.setenv("DISTANCE_TPU_RETARGET_LIMIT", "0")
    wins = spy_encodes(monkeypatch, diffup)
    port_tsv(tmp_path, "raw", f1, f2, 3)
    assert wins == [False] * 6  # the loaded side, then five groups
