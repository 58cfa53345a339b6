"""Out of core, diff-uploaded and packed: the port's blocked square and
rectangle and its staged stream write the in-core bytes.

The budgets of ``distance_tpu_torch.engine`` are lowered as
``test_torch_outofcore.lower_budgets`` lowers them, and every run is
``--backend torch`` (the plain versions of the kernels, on the CPU).  Each
out-of-core TSV is held against the in-core run of the same settings and
against ``distance --backend numpy``, for the six measures with diff
uploads and rel packing on (the default), forced, and off (the ladder
without a reference row: narrow -> wide); a diverse alignment with blocks
large enough to overflow rel4's sidecar walks rel4 -> rel -> wide and
narrow -> wide out of core; and a staged super-row is diff-encoded once a
run, however often it is staged, in place from 512 rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.encoding import ALL_CODES  # noqa: E402
from distance_tpu_torch.ops import diffup  # noqa: E402
from tests.test_stream_split import low_diversity_fastas  # noqa: E402
from tests.test_torch_outofcore import Seen, lower_budgets  # noqa: E402
from tests.test_torch_packed_e2e import (  # noqa: E402,F401
    check_no_recount,
    diverse_fastas,
    spies,
)

SETTINGS = {
    "on": {},
    "forced": {"DISTANCE_TPU_DIFF_UPLOAD": "force"},
    "off": {"DISTANCE_TPU_NO_DIFF_UPLOAD": "1",
            "DISTANCE_TPU_NO_REL_PACK": "1"},
}


@pytest.fixture(autouse=True)
def _no_jit_cache(monkeypatch):
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")


@pytest.fixture
def encodes(monkeypatch):
    """Diff encodes made while a staged side stages a super-row, by span
    (the engine's ``_encode``, in place or from the padded copy), those of
    them read in place (``DiffUploader.encode_rows``), and the diff
    uploads of the run."""
    seen = {"spans": {}, "in_place": {}, "stagings": {}, "uploads": 0}
    current = []
    real_get = port_engine._StagedSide.get
    real_encode = port_engine._BlockEngine._encode
    real_rows = diffup.DiffUploader.encode_rows
    real_upload = diffup.DiffUploader.upload_encoded

    def get(side, q0, q1):
        if side._key != (q0, q1):
            seen["stagings"][(q0, q1)] = seen["stagings"].get((q0, q1), 0) + 1
        current.append((q0, q1))
        try:
            return real_get(side, q0, q1)
        finally:
            current.pop()

    def count(key, span):
        seen[key][span] = seen[key].get(span, 0) + 1

    def encode(eng, matrix, n_pad, padded):
        if current:
            count("spans", current[-1])
        return real_encode(eng, matrix, n_pad, padded)

    def encode_rows(up, matrix, rows_pad):
        if current:
            count("in_place", current[-1])
        return real_rows(up, matrix, rows_pad)

    def upload_encoded(up, enc, rows_pad):
        seen["uploads"] += 1
        return real_upload(up, enc, rows_pad)

    monkeypatch.setattr(port_engine._StagedSide, "get", get)
    monkeypatch.setattr(port_engine._BlockEngine, "_encode", encode)
    monkeypatch.setattr(diffup.DiffUploader, "encode_rows", encode_rows)
    monkeypatch.setattr(diffup.DiffUploader, "upload_encoded", upload_encoded)
    return seen


def args_of(tmp_path, mode, f1, f2, batch):
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    a.write_bytes(f1)
    b.write_bytes(f2)
    return {"square": [str(a)], "rectangle": [str(a), str(b)],
            "stream": [str(a), "-s", str(b), "-b", str(batch)]}[mode]


def port_tsv(tmp_path, args, name):
    out = tmp_path / name
    assert port_cli.main([*args, "--backend", "torch", "-o", str(out)]) == 0
    return out.read_bytes()


def numpy_tsv(tmp_path, args):
    out = tmp_path / "numpy.tsv"
    assert jax_cli.main([*args, "--backend", "numpy", "-o", str(out)]) == 0
    return out.read_bytes()


def rungs():
    return dict(port_engine.RUNG_BLOCKS)


def delta(before):
    return {k: v - before[k] for k, v in port_engine.RUNG_BLOCKS.items()}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
@pytest.mark.parametrize("measure", MEASURES)
def test_out_of_core_packed_equals_in_core(tmp_path, monkeypatch, encodes,
                                           measure, mode, setting):
    """Low-diversity inputs (an ancestor and 6 mutated sites a record):
    out of core, X groups and super-rows (and the staged stream's groups)
    go diff-encoded and blocks at rel4 by default and under ``force``;
    ``off`` sends them dense and packs narrow lanes.  The bytes are the
    in-core run's and numpy's."""
    for name, value in SETTINGS[setting].items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 4)
    f1, f2 = low_diversity_fastas(seed=5, n1=40, n2=45, width=400, nmut=6)
    # groups of two -b 2 batches: even, so rel4 packs them
    args = args_of(tmp_path, mode, f1, f2, batch=2) + ["-m", measure]
    want = numpy_tsv(tmp_path, args)
    assert port_tsv(tmp_path, args, "in_core.tsv") == want
    lower_budgets(monkeypatch, mode)
    seen = Seen(monkeypatch)
    before, uploads = rungs(), encodes["uploads"]
    assert port_tsv(tmp_path, args, "ooc.tsv") == want
    d = delta(before)
    if mode == "stream":
        assert seen.staged >= 2
    else:
        assert seen.blocked == 1 and seen.x_groups >= 2
    assert len(seen.super_rows) >= 2
    assert d["none"] == d["wide"] == 0
    if setting == "off":
        assert encodes["uploads"] == uploads and not encodes["spans"]
        assert d["rel4"] == d["rel"] == 0 and d["narrow"] >= 1
    else:
        assert encodes["uploads"] > uploads and d["rel4"] >= 1
        assert d["narrow"] == 0


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
@pytest.mark.parametrize("measure", ["raw", "tn93"])
def test_out_of_core_saturating_walks_every_packed_rung(tmp_path, monkeypatch,
                                                       measure, mode):
    """Random bases over 600 sites, out of core in blocks of 64 x 256 (the
    staged stream: super-rows of 64 loaded rows against groups of 256
    records), more cells than rel4's sidecar segments hold two outliers
    of: blocks
    saturate rel4 and rel and are fetched wide, later ones go narrow,
    saturate and are fetched wide, then wide.  The bytes are the in-core
    run's and numpy's."""
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 256)
    # the stream's loaded side is shorter: numpy's stream is slow
    f1, f2 = diverse_fastas(n1=130 if mode == "stream" else 300, n2=260,
                            width=600)
    args = args_of(tmp_path, mode, f1, f2, batch=256) + ["-m", measure]
    want = numpy_tsv(tmp_path, args)
    assert port_tsv(tmp_path, args, "in_core.tsv") == want
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET",
                        150_000 if mode == "stream" else 250_000)
    monkeypatch.setattr(port_engine, "TILE_I", 64)
    monkeypatch.setattr(port_engine, "TILE_J", 256)
    seen = Seen(monkeypatch)
    before = rungs()
    assert port_tsv(tmp_path, args, "ooc.tsv") == want
    assert (seen.staged if mode == "stream" else seen.x_groups) >= 2
    assert len(seen.super_rows) >= 2
    d = delta(before)
    assert min(d["rel4"], d["rel"], d["narrow"], d["wide"]) >= 1, d
    assert d["none"] == 0


@pytest.mark.parametrize("rung", ["rel4", "narrow"])
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_out_of_core_refetches_repack_the_kept_counters(
        tmp_path, monkeypatch, spies, mode, rung):
    """Out of core (the blocked square and rectangle, the staged stream),
    a strip or staged part saturated at rel4, or without a reference row
    at narrow, is packed again from its kept counters: the counter kernel
    runs for first dispatches and baselines alone.  The bytes are the
    in-core run's and numpy's."""
    if rung == "narrow":
        monkeypatch.setenv("DISTANCE_TPU_NO_REL_PACK", "1")
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 256)
    f1, f2 = diverse_fastas(n1=130 if mode == "stream" else 300, n2=260,
                            width=600)
    args = args_of(tmp_path, mode, f1, f2, batch=256) + ["-m", "tn93"]
    want = numpy_tsv(tmp_path, args)
    assert port_tsv(tmp_path, args, "in_core.tsv") == want
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET",
                        150_000 if mode == "stream" else 250_000)
    monkeypatch.setattr(port_engine, "TILE_I", 64)
    monkeypatch.setattr(port_engine, "TILE_J", 256)
    seen = Seen(monkeypatch)
    before = spies()
    assert port_tsv(tmp_path, args, "ooc.tsv") == want
    assert (seen.staged if mode == "stream" else seen.x_groups) >= 2
    assert len(seen.super_rows) >= 2
    d = {k: v - before[k] for k, v in spies().items()}
    check_no_recount(d)
    assert d[rung] >= 1 and d["none"] == 0


@pytest.mark.parametrize("width", [600, 1 << 16])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_footprints_count_kept_counters_beside_packs(g, width):
    """Each strip (stream group) in flight holds its int32 counters, kept
    for a refetch, and one strip's packs sit beside them (its blocks' and
    their concatenation along columns; a group's one block's), each as
    large as the wide words below 2^16 sites and the int32 counters past
    them."""
    ti, tj = 64, 256
    l_pad = -(-width // 128) * 128
    g4 = 4 * g
    pack = (4 * g if width >= 1 << 16
            else 2 if g == 1 else 4 * ((g + 1) // 2))
    fp = port_engine._blocked_footprint
    per_tj = fp(128, 4 * tj, width, g, ti, tj) - fp(128, 3 * tj, width, g,
                                                     ti, tj)
    strip = g4 * ti * tj + port_engine._SIDECAR_BYTES
    assert per_tj == (port_engine._upload_bytes(tj, l_pad) + 2 * g4 * tj
                      + (port_engine.STRIP_LOOKAHEAD + 1) * strip
                      + 2 * pack * ti * tj)
    sf = port_engine._stream_footprint
    rows, groups = 300, 4
    per_record = sf(9, rows, width, g, groups) - sf(8, rows, width, g, groups)
    assert per_record == (groups * (port_engine._upload_bytes(1, l_pad) + g4
                                    + g4 * rows) + pack * rows)


def test_tiny_budget_below_the_footprint_goes_out_of_core(tmp_path,
                                                          monkeypatch):
    """The in-core square's footprint is the line: a device budget of it
    keeps the sweep in core, one byte less sends it out of core, and the
    bytes are numpy's either way (a saturating alignment, so strips keep
    their counters and refetch)."""
    f1, f2 = diverse_fastas(n1=70, width=600)
    args = args_of(tmp_path, "square", f1, f2, batch=1) + ["-m", "k80"]
    want = numpy_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine, "TILE_I", 16)
    monkeypatch.setattr(port_engine, "TILE_J", 32)
    seen_fp = []
    real = port_engine._blocked_footprint

    def footprint(*a, **k):
        seen_fp.append(real(*a, **k))
        return seen_fp[-1]

    monkeypatch.setattr(port_engine, "_blocked_footprint", footprint)
    assert port_tsv(tmp_path, args, "free.tsv") == want
    line = seen_fp[0]
    for budget, blocked in ((line, 0), (line - 1, 1)):
        monkeypatch.setattr(port_engine, "DEVICE_BUDGET", budget)
        seen = Seen(monkeypatch)
        assert port_tsv(tmp_path, args, f"{budget}.tsv") == want
        assert seen.blocked == blocked


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_staged_super_rows_encode_once(tmp_path, monkeypatch, encodes, mode):
    """Every super-row is staged again for each X group (each stream
    group) but the one the serpentine order keeps on the device; its diff
    encoding is kept on the host, so each is encoded once a run."""
    f1, f2 = low_diversity_fastas(seed=8, n1=40, n2=45, width=400, nmut=6)
    args = args_of(tmp_path, mode, f1, f2, batch=3) + ["-m", "raw"]
    want = numpy_tsv(tmp_path, args)
    # a host budget whose half holds every super-row's encoding (at least
    # 4096 diffs of 5 B each: the encoder's least capacity)
    lower_budgets(monkeypatch, mode, host=1 << 20)
    assert port_tsv(tmp_path, args, "ooc.tsv") == want
    assert max(encodes["stagings"].values()) >= 2
    assert encodes["spans"] == {span: 1 for span in encodes["stagings"]}


# (device, host) budgets that stage 1,100 loaded rows (the rectangle's
# second file, the stream's loaded side) in two super-rows of 512 rows or
# more, the first staged twice: against the rectangle's two X groups of
# 24 rows, against the stream's groups of 16 records.  On K1's path (no
# cached measure), whose super-rows take the larger share of the budget.
WIDE_SUPER_ROWS = {"rectangle": (130_000_000, 1 << 19),
                   "stream": (900_000, 1 << 20)}


@pytest.mark.parametrize("mode", sorted(WIDE_SUPER_ROWS))
def test_staged_super_rows_of_512_rows_encode_once_in_place(
        tmp_path, monkeypatch, encodes, mode):
    """Super-rows of 512 rows or more, which the encoder reads in place
    (``DiffUploader.encode_rows``, no padded copy): each is encoded once
    a run however often it is staged, every encode of them in place, and
    the bytes are numpy's."""
    rect = mode == "rectangle"
    f1, f2 = low_diversity_fastas(seed=8, n1=48 if rect else 1100,
                                  n2=1100 if rect else 45, width=400,
                                  nmut=6)
    args = args_of(tmp_path, mode, f1, f2, batch=3) + ["-m", "raw"]
    want = numpy_tsv(tmp_path, args)
    budget, host = WIDE_SUPER_ROWS[mode]
    lower_budgets(monkeypatch, mode, group=16, host=host)
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET", budget)
    monkeypatch.setattr(port_engine, "CACHED_MEASURES", frozenset())
    assert port_tsv(tmp_path, args, "ooc.tsv") == want
    spans = encodes["stagings"]
    assert len(spans) >= 2 and min(q1 - q0 for q0, q1 in spans) >= 512
    assert max(spans.values()) >= 2
    assert encodes["spans"] == {span: 1 for span in spans}
    assert encodes["in_place"] == encodes["spans"]


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_staged_super_rows_launch_one_baseline(tmp_path, monkeypatch, mode):
    """A super-row staged again keeps its K1 baseline against the
    reference row: a run launches one baseline for each X group (each
    stream group), one for each super-row and the reference row's own,
    however often the super-rows are staged."""
    f1, f2 = low_diversity_fastas(seed=8, n1=40, n2=45, width=400, nmut=6)
    args = args_of(tmp_path, mode, f1, f2, batch=3) + ["-m", "raw"]
    want = numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, mode)
    seen = Seen(monkeypatch)
    monkeypatch.setattr(port_engine, "BASELINES", 0)
    assert port_tsv(tmp_path, args, "ooc.tsv") == want
    groups = seen.staged if mode == "stream" else seen.x_groups
    assert seen.uploads > len(seen.super_rows) >= 2 and groups >= 2
    assert port_engine.BASELINES == groups + len(seen.super_rows) + 1


def staged_side(monkeypatch, host_budget):
    monkeypatch.setattr(port_engine, "HOST_BUF_BUDGET", host_budget)
    rng = np.random.default_rng(3)
    src = np.repeat(rng.choice(ALL_CODES[:4], 300).astype(np.uint8)[None],
                    24, 0)
    hits = rng.random(src.shape) < 0.01
    src[hits] = rng.choice(ALL_CODES, int(hits.sum()))
    eng = port_engine._BlockEngine("raw", [torch.device("cpu")], 8, 300,
                                   rel=True, tj=8)
    side = port_engine._StagedSide(eng, src, 8, eng.diff_ref_for(src))
    return eng, side, src


def test_memo_is_kept_per_uploader_and_within_the_host_budget(monkeypatch,
                                                              encodes):
    eng, side, src = staged_side(monkeypatch, 1 << 20)
    assert eng.diff_up is None
    for q in ((0, 8), (8, 16), (0, 8), (8, 16)):
        got = side.get(*q)
        np.testing.assert_array_equal(got[: q[1] - q[0], :300].numpy(),
                                      src[q[0]:q[1]])
    assert encodes["spans"] == {(0, 8): 1, (8, 16): 1}
    assert all(m["enc"] is not None for m in side._memos.values())
    # a retarget swaps the uploader: the kept encodings are stale
    eng.diff_up = diffup.DiffUploader(eng.diff_up.ref.copy(), eng.device)
    side.get(0, 8)
    assert encodes["spans"][(0, 8)] == 2
    # past half the host budget no memo is admitted: the first one is,
    # and every later span encodes at each staging
    eng, side, _ = staged_side(monkeypatch, 2)
    encodes["spans"].clear()
    for q in ((0, 8), (8, 16), (0, 8), (8, 16)):
        side.get(*q)
    assert encodes["spans"] == {(0, 8): 1, (8, 16): 2}
    assert side._memo_bytes > 1
