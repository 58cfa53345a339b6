"""The loaded sweep's serial head, read in place: each pass gives the
result of the function it stands in front of or replaces.

* ``engine._prune_declines`` (a prefix of the rows) declines only where
  ``_prune_invariant_columns`` returns None;
* ``diffup.pooled_mode_row`` (column ranges of the strided sample on the
  pool, no copy) is ``sampled_mode_row``'s row, the port's and the JAX
  package's;
* ``DiffUploader.encode_rows`` (the unpadded rows, indices moved to the
  padded layout) is ``encode`` of the zero-padded matrix, byte for byte,
  or None where it is None.

A square whose columns vary early records ``prune-prefix`` once and,
with 512 rows or more, ``encode-in-place`` once (totals with no span),
and writes the JAX CLI's bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distance_tpu.ops.diffup as jax_diffup  # noqa: E402
from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu_torch import cli  # noqa: E402
from distance_tpu_torch import engine  # noqa: E402
from distance_tpu_torch.emit import _prune_invariant_columns  # noqa: E402
from distance_tpu_torch.encoding import ALL_CODES  # noqa: E402
from distance_tpu_torch.ops import diffup  # noqa: E402
from distance_tpu_torch.utils import timing  # noqa: E402
from tests.conftest import make_fasta  # noqa: E402

CPU = torch.device("cpu")


def mutated(rng, rows, width, per_row, extra=0):
    """(rows, width) codes: one ancestor row with ``per_row`` random
    cells a row set to other codes of ALL_CODES (or to ``extra`` codes
    outside it, 0 and 7, where ``extra`` is nonzero)."""
    anc = rng.choice(ALL_CODES, width).astype(np.uint8)
    m = np.tile(anc, (rows, 1))
    if rows and width:
        r = np.repeat(np.arange(rows), per_row)
        c = rng.integers(0, width, r.size)
        pool = np.concatenate([ALL_CODES, [0, 7][:extra]]).astype(np.uint8)
        m[r, c] = rng.choice(pool, r.size)
    return m


# ---------------------------------------------------------------------------
# the prune's early decline
# ---------------------------------------------------------------------------

def prune_case(name):
    """(matrices, whether the prefix must decline)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "width-0":
        return [np.zeros((9, 0), np.uint8)], False
    if name == "one-row":
        return [mutated(rng, 1, 50, 3)], False
    if name == "all-invariant":
        return [mutated(rng, 300, 64, 0)], False
    if name in ("quarter-invariant", "below-quarter"):
        # 100 (or 99) of 400 columns invariant, the rest vary in row 1
        m = mutated(rng, 200, 400, 0)
        keep = 100 if name == "quarter-invariant" else 99
        m[1:, keep:] = np.where(m[0, keep:] == ALL_CODES[0], ALL_CODES[1],
                                ALL_CODES[0])
        return [m], name == "below-quarter"
    if name == "broken-past-prefix":
        # every column invariant over the prefix, all but a tenth broken
        # in the rows after it
        m = mutated(rng, engine._PRUNE_PREFIX_ROWS + 60, 40, 0)
        m[-1, 4:] = np.where(m[0, 4:] == ALL_CODES[0], ALL_CODES[1],
                             ALL_CODES[0])
        return [m], False
    if name == "broken-past-first-block":
        # the decline comes in the second block
        m = mutated(rng, 500, 80, 0)
        m[100, 10:] = np.where(m[0, 10:] == ALL_CODES[0], ALL_CODES[1],
                               ALL_CODES[0])
        return [m], True
    if name == "diverse":
        return [mutated(rng, 700, 300, 12)], True
    if name == "two-matrices-second-breaks":
        # invariant through file1; file2's first row differs at most sites
        a = mutated(rng, 70, 120, 0)
        b = np.tile(a[0], (30, 1))
        b[0, :100] = np.where(a[0, :100] == ALL_CODES[0], ALL_CODES[1],
                              ALL_CODES[0])
        return [a, b], True
    if name == "two-matrices-engage":
        a, b = mutated(rng, 70, 120, 0), mutated(rng, 30, 120, 0)
        b[:] = a[0]
        b[:, :20] = ALL_CODES[0]
        return [a, b], False
    raise KeyError(name)


PRUNE_CASES = ["width-0", "one-row", "all-invariant", "quarter-invariant",
               "below-quarter", "broken-past-prefix",
               "broken-past-first-block", "diverse",
               "two-matrices-second-breaks", "two-matrices-engage"]


def same_prune(got, want):
    if want is None:
        return got is None
    return (got is not None and got[1:] == want[1:]
            and all(np.array_equal(g, w) for g, w in zip(got[0], want[0])))


@pytest.mark.parametrize("case", PRUNE_CASES)
def test_early_decline_then_prune_equals_the_prune(case):
    mats, declines = prune_case(case)
    assert engine._prune_declines(mats) is declines
    got = None if declines else _prune_invariant_columns(mats)
    assert same_prune(got, _prune_invariant_columns(mats))


# ---------------------------------------------------------------------------
# the diff reference row
# ---------------------------------------------------------------------------

def mode_case(name):
    """(matrix, cap)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "empty":
        return np.zeros((0, 40), np.uint8), 4096
    if name == "ties":
        # 4096 rows, each column half one code and half another; the
        # ranges split the 2,048 columns
        lo = rng.choice(ALL_CODES, 2048)
        hi = rng.choice(ALL_CODES, 2048)
        m = np.where(np.arange(4096)[:, None] % 2, lo, hi).astype(np.uint8)
        return m, 4096
    if name == "outside-codes":
        return mutated(rng, 4096, 1500, 900, extra=2), 4096
    if name == "outside-codes-majority":
        m = mutated(rng, 3000, 1200, 200)
        m[:, :300] = 0
        m[::3, 300:600] = 7
        return m, 4096
    if name == "non-contiguous":
        return mutated(rng, 4200, 3000, 500)[:, ::2], 4096
    if name == "fortran-order":
        return np.asfortranarray(mutated(rng, 2000, 1100, 300)), 4096
    if name == "below-4096":
        return mutated(rng, 1000, 3000, 600), 4096
    if name == "above-4096":
        return mutated(rng, 9000, 1200, 400), 4096
    if name == "cap-7":
        return mutated(rng, 100, 60, 20), 7
    if name == "cap-1000":
        return mutated(rng, 9000, 4096, 1500), 1000
    if name.startswith("sample-edge"):
        # cap 4 of 10 rows samples rows 0, 2, 4, 6: a tie that goes to
        # ALL_CODES[0], which row 8 (the next row at the step) and the odd
        # rows (off the step) would break
        width = 64 if name == "sample-edge" else (1 << 20) + 3
        m = np.empty((10, width), np.uint8)
        m[[0, 2, 8]] = ALL_CODES[1]
        m[[4, 6]] = ALL_CODES[0]
        m[1::2] = ALL_CODES[2]
        return m, 4
    if name == "wide-few-rows":
        # 2 MiB ranges of 3 rows: ranges of 699,051 columns
        return mutated(rng, 3, 1 << 20 | 5, 1 << 17), 4096
    raise KeyError(name)


MODE_CASES = ["empty", "ties", "outside-codes", "outside-codes-majority",
              "non-contiguous", "fortran-order", "below-4096", "above-4096",
              "cap-7", "cap-1000", "sample-edge", "sample-edge-wide",
              "wide-few-rows"]


@pytest.mark.parametrize("case", MODE_CASES)
def test_pooled_mode_row_equals_sampled_mode_row(case):
    m, cap = mode_case(case)
    got = diffup.pooled_mode_row(m, cap)
    want = diffup.sampled_mode_row(m, cap)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if m.shape[1] <= 5000:
        np.testing.assert_array_equal(got,
                                      jax_diffup.sampled_mode_row(m, cap))


def test_diff_ref_for_is_the_pooled_row(monkeypatch):
    m, _ = mode_case("above-4096")
    eng = engine._BlockEngine("raw", [CPU], 8, m.shape[1], rel=True, tj=8)
    np.testing.assert_array_equal(eng.diff_ref_for(m),
                                  diffup.sampled_mode_row(m))
    monkeypatch.setenv("DISTANCE_TPU_NO_DIFF_UPLOAD", "1")
    assert eng.diff_ref_for(m) is None


# ---------------------------------------------------------------------------
# the diff encode of the unpadded rows
# ---------------------------------------------------------------------------

def encode_case(name):
    """(matrix, n_pad, l_pad, whether the encoding wins)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    rows, width, per_row, n_pad, wins = {
        # every row a chunk of its own size but the last: 256, 256, 232
        "last-chunk-short": (744, 300, 6, 744, True),
        "rows-512": (512, 256, 4, 512, True),
        "pad-rows-and-sites": (1000, 29903 // 40, 10, 1024, True),
        "pad-rows-only": (600, 384, 9, 2048, True),
        "sites-not-padded": (530, 128, 3, 530, True),
        "no-diffs": (520, 200, 0, 640, True),
        # below the native path: the padded copy
        "rows-511": (511, 200, 4, 512, True),
        "rows-100": (100, 130, 3, 128, True),
        # 10% of the cells differ: past _rejects' 1/15, inside the
        # sampled pre-check's 2/15
        "rejected-by-count": (800, 500, 50, 800, False),
        "rejected-by-sample": (800, 500, 400, 832, False),
    }[name]
    m = mutated(rng, rows, width, per_row)
    return m, n_pad, -(-width // 128) * 128, wins


ENCODE_CASES = ["last-chunk-short", "rows-512", "pad-rows-and-sites",
                "pad-rows-only", "sites-not-padded", "no-diffs", "rows-511",
                "rows-100", "rejected-by-count", "rejected-by-sample"]


def padded_of(m, n_pad, l_pad):
    p = np.zeros((n_pad, l_pad), np.uint8)
    p[: m.shape[0], : m.shape[1]] = m
    return p


def uploader(m, l_pad):
    ref = np.zeros(l_pad, np.uint8)
    ref[: m.shape[1]] = diffup.sampled_mode_row(m)
    return diffup.DiffUploader(ref, CPU)


@pytest.mark.parametrize("force", [False, True], ids=["default", "force"])
@pytest.mark.parametrize("case", ENCODE_CASES)
def test_in_place_encode_equals_padded_encode(case, force, monkeypatch):
    """The engine's ``_encode`` gives ``encode`` of the padded matrix, or
    None where it does: in place from 512 rows, which builds no padded
    copy, and from the padded copy below."""
    if force:
        monkeypatch.setenv("DISTANCE_TPU_DIFF_UPLOAD", "force")
    m, n_pad, l_pad, wins = encode_case(case)
    up = uploader(m, l_pad)
    assert up.in_place(m) is (m.shape[0] >= 512)
    padded = padded_of(m, n_pad, l_pad)
    eng = engine._BlockEngine("raw", [CPU], 8, m.shape[1], rel=True, tj=8)
    eng.diff_up = up
    built = []
    got = eng._encode(m, n_pad, lambda: built.append(1) or padded)
    assert bool(built) is not up.in_place(m)
    want = up.encode(padded, n_real=m.shape[0])
    assert (want is not None) is (wins or force)
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_in_place_only_where_encode_is_native():
    """Not below 512 rows, at width 0, for rows at another stride or of
    another dtype, nor against a reference row with a nonzero padding
    column: there the engine pads."""
    rng = np.random.default_rng(5)
    m = mutated(rng, 600, 200, 4)
    up = uploader(m, 256)
    assert up.in_place(m)
    assert not up.in_place(m[:511])
    assert not up.in_place(np.zeros((600, 0), np.uint8))
    assert not up.in_place(np.asfortranarray(m))
    assert not up.in_place(m.astype(np.int16))
    wide = np.zeros((600, 256), np.uint8)
    wide[:, :200] = m
    assert not up.in_place(wide[:, :200])
    odd = up.ref.copy()
    odd[-1] = ALL_CODES[0]
    assert not diffup.DiffUploader(odd, CPU).in_place(m)


# ---------------------------------------------------------------------------
# the counters, end to end
# ---------------------------------------------------------------------------

def fasta_of(m):
    from distance_tpu_torch.encoding import CODE_TO_CHAR

    chars = np.array([ord(CODE_TO_CHAR.get(c, "A")) for c in range(256)],
                     np.uint8)
    return make_fasta((f"s{i}", chars[row].tobytes().decode())
                      for i, row in enumerate(m))


def square_codes(rows, width, cols, seed):
    """(rows, width) ACGT codes: the ancestor every seed shares, with
    three point mutations a row (``seed``'s) within its first ``cols``
    sites."""
    rng = np.random.default_rng(seed)
    acgt = np.array([136, 72, 40, 24], np.uint8)
    m = np.tile(np.random.default_rng(0).choice(acgt, width), (rows, 1))
    r = np.repeat(np.arange(rows), 3)
    m[r, rng.integers(0, cols, r.size)] = rng.choice(acgt, r.size)
    return m


def both_tsvs(tmp_path, monkeypatch, files, args=()):
    """(the port's TSV, its phase counts, its spans' names, the JAX CLI's
    TSV) of a raw run over ``files`` (name -> codes), the port's with
    spans recorded."""
    paths = []
    for name, m in files.items():
        paths.append(str(tmp_path / f"{name}.fasta"))
        (tmp_path / f"{name}.fasta").write_bytes(fasta_of(m))
    argv = ([paths[0], "-s", paths[1]] if "-s" in args else paths) + [
        a for a in args if a != "-s"] + ["-m", "raw"]
    port, jax = tmp_path / "port.tsv", tmp_path / "jax.tsv"
    timing.take_spans()
    timing.reset()
    timing.record_spans(True)
    try:
        assert cli.main(argv + ["--backend", "torch", "-o", str(port)]) == 0
    finally:
        timing.record_spans(False)
    names = {s.name for s in timing.take_spans()}
    counts = dict(timing._COUNTS)
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")
    if "-s" in args:
        argv = ["-i"] + argv
    assert jax_cli.main(argv + ["--backend", "numpy", "-o", str(jax)]) == 0
    return port.read_bytes(), counts, names, jax.read_bytes()


@pytest.mark.parametrize("kind", ["diverse", "low-diversity"])
def test_head_counters_on_a_square(tmp_path, monkeypatch, kind):
    """A diverse 520-row square: the prefix declines the prune once and
    the upload encodes in place once.  A low-diversity one (every column
    but the first 20 invariant) prunes, through the spied function, and
    records no ``prune-prefix``.  Neither total keeps a span."""
    m = square_codes(520, 160, 160 if kind == "diverse" else 20, 23)
    pruned = []
    real = engine._prune_invariant_columns

    def spy(mats):
        res = real(mats)
        pruned.append(res is not None)
        return res

    monkeypatch.setattr(engine, "_prune_invariant_columns", spy)
    tsv, counts, names, want = both_tsvs(tmp_path, monkeypatch, {"a": m})
    assert tsv == want
    assert counts["prune"] == 1
    if kind == "diverse":
        assert counts["prune-prefix"] == 1 and pruned == []
    else:
        assert "prune-prefix" not in counts and pruned == [True]
    assert counts["encode-in-place"] == 1
    assert "prune" in names
    assert not {"prune-prefix", "encode-in-place"} & names


# Each path that prepares a loaded matrix, with the encodings it makes in
# place: the rectangle's two files, the out-of-core sweeps' X groups and
# super-rows (at least two), the split engine's one, the stream's loaded
# side.
PATHS = {
    "rectangle": (2, {}),
    "square-out-of-core": (2, {"DEVICE_BUDGET": 250000}),
    "rectangle-out-of-core": (2, {"DEVICE_BUDGET": 250000}),
    "square-split": (1, {"devices_of": lambda backend: [CPU] * 2}),
    "stream": (1, {}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_loaded_path_encodes_in_place_and_writes_the_jax_bytes(
        tmp_path, monkeypatch, path):
    """1,100 loaded records (a stream's 520, against 60; a rectangle's
    second file 600) of one ancestor: every path encodes its uploads of
    512 rows or more in place and writes the JAX CLI's bytes; the loaded
    sweeps decline the prune from the prefix."""
    least, patch = PATHS[path]
    for name, value in patch.items():
        monkeypatch.setattr(engine, name, value)
    files = {"a": square_codes(520 if path == "stream" else 1100, 100,
                               100, 1)}
    if not path.startswith("square"):
        files["b"] = square_codes(60 if path == "stream" else 600, 100,
                                  100, 2)
    args = ("-s", "-b", "60") if path == "stream" else ()
    tsv, counts, _, want = both_tsvs(tmp_path, monkeypatch, files, args)
    assert tsv == want
    if path.endswith("out-of-core"):
        assert counts["ooc-stage"] >= 2
        assert counts["encode-in-place"] >= least
    else:
        assert counts["encode-in-place"] == least
    assert counts.get("prune-prefix") == (None if path == "stream" else 1)
