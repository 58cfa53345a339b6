"""End to end: the port's in-core square, rectangle and stream with
diff-encoded uploads and the JAX engine's pack ladder write the bytes of
``distance --backend numpy``, for all six measures, whether diff uploads
and rel packing are on (the default), forced, off (the ladder without a
reference row: narrow -> wide), or saturating (a diverse alignment walks
rel4 -> rel -> wide below 2^16 sites, and rel4 -> rel -> int32 above),
sharded, and under ``--launch 2``.  Every port run is ``--backend torch``
(the plain versions of the kernels, on the CPU).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.ops import diffup  # noqa: E402
from tests.conftest import make_fasta  # noqa: E402
from tests.test_stream_split import low_diversity_fastas  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = {
    "on": {},
    "forced": {"DISTANCE_TPU_DIFF_UPLOAD": "force"},
    "off": {"DISTANCE_TPU_NO_DIFF_UPLOAD": "1",
            "DISTANCE_TPU_NO_REL_PACK": "1"},
}


@pytest.fixture(autouse=True)
def _no_jit_cache(monkeypatch):
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")


def diverse_fastas(seed=3, n1=150, n2=140, width=300):
    """Random bases: residuals against any reference row pass the nibble
    and int8 ranges in blocks of more cells than the sidecar's segments,
    and past 255 sites the narrow lanes saturate too."""
    rng = np.random.default_rng(seed)

    def recs(n, tag):
        return [(f"{tag}{i}", "".join(rng.choice(list("ACGTN"), width,
                                                 p=[.24, .24, .24, .24, .04])))
                for i in range(n)]

    return make_fasta(recs(n1, "a")), make_fasta(recs(n2, "t"))


@pytest.fixture
def spies(monkeypatch):
    """Counts of diff uploads, of blocks by rung, of counter-kernel calls
    (``k1``: K1's, or K6's on the cached-feature path), of blocks first
    dispatched (``first``: every strip, stream group and staged part is
    dispatched once, then perhaps again) and of baselines in one run."""
    seen = {"diff": 0, "k1": 0, "first": 0}
    real = diffup.DiffUploader.upload_encoded
    real_counters = port_engine.kernels.counters
    real_contract = port_engine.cached_ops.contract
    real_strip = port_engine._Strip.__init__

    def upload_encoded(self, enc, rows_pad):
        seen["diff"] += 1
        return real(self, enc, rows_pad)

    def counters(*args, **kwargs):
        seen["k1"] += 1
        return real_counters(*args, **kwargs)

    def contract(*args, **kwargs):
        seen["k1"] += 1
        return real_contract(*args, **kwargs)

    def strip(self, eng, m1, m2, i0, col_starts, *args, **kwargs):
        seen["first"] += len(col_starts)
        real_strip(self, eng, m1, m2, i0, col_starts, *args, **kwargs)

    monkeypatch.setattr(diffup.DiffUploader, "upload_encoded",
                        upload_encoded)
    monkeypatch.setattr(port_engine.kernels, "counters", counters)
    monkeypatch.setattr(port_engine.cached_ops, "contract", contract)
    monkeypatch.setattr(port_engine._Strip, "__init__", strip)

    def snapshot():
        return dict(port_engine.RUNG_BLOCKS, diff=seen["diff"],
                    k1=seen["k1"], first=seen["first"],
                    baselines=port_engine.BASELINES)

    return snapshot


def check_no_recount(d):
    """Every counter-kernel call of a run was a block's first dispatch or
    a baseline, though blocks were packed again after a saturation."""
    packs = sum(d[rung] for rung in port_engine.RUNG_BLOCKS)
    assert d["k1"] == d["first"] + d["baselines"], d
    assert packs > d["first"] >= 1, d


def delta(before, after):
    return {k: after[k] - before[k] for k in before}


def mode_args(tmp_path, mode, f1, f2, batch=7):
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    a.write_bytes(f1)
    b.write_bytes(f2)
    return {"square": [str(a)], "rectangle": [str(a), str(b)],
            "stream": [str(a), "-s", str(b), "-b", str(batch)]}[mode]


def both(tmp_path, args):
    outs = []
    for main, backend in ((port_cli.main, "torch"), (jax_cli.main, "numpy")):
        out = tmp_path / f"{backend}.tsv"
        assert main([*args, "--backend", backend, "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    return outs


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
@pytest.mark.parametrize("measure", MEASURES)
def test_packed_runs_equal_numpy(tmp_path, monkeypatch, spies, measure, mode,
                                 setting):
    """Low-diversity inputs (an ancestor and 6 mutated sites a record):
    the default run sends its codes as diffs and its blocks at rel4,
    ``force`` diff-encodes every upload, ``off`` sends them dense and
    packs narrow lanes (no reference row); the bytes never change.  The stream's groups of 7-record
    batches (at most 14 records a group) are odd and even: odd ones take
    rel."""
    for name, value in SETTINGS[setting].items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("DISTANCE_TPU_STREAM_GROUP", "14")
    f1, f2 = low_diversity_fastas(seed=5, n1=40, n2=45, width=400, nmut=6)
    args = mode_args(tmp_path, mode, f1, f2) + ["-m", measure]
    before = spies()
    got, want = both(tmp_path, args)
    assert got == want
    d = delta(before, spies())
    if setting == "off":
        assert d["diff"] == 0 and d["rel4"] == d["rel"] == 0 and d["narrow"]
    else:
        assert d["diff"] >= 1 and d["rel4"] >= 1 and d["none"] == 0
    if setting != "off" and mode == "stream":
        assert d["rel"] >= 1  # the odd groups (45 = 14 + 14 + 14 + 3)


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
@pytest.mark.parametrize("measure", MEASURES)
def test_saturating_runs_walk_the_ladder(tmp_path, spies, measure, mode):
    """A diverse alignment: every block saturates rel4 and rel and is
    fetched wide (the JAX engine's ladder at 300 sites); the bytes are
    numpy's."""
    f1, f2 = diverse_fastas()
    args = mode_args(tmp_path, mode, f1, f2, batch=140) + ["-m", measure]
    before = spies()
    got, want = both(tmp_path, args)
    assert got == want
    d = delta(before, spies())
    assert d["rel4"] >= 1 and d["rel"] == d["rel4"] and d["wide"] == d["rel"]
    assert d["narrow"] == d["none"] == 0


@pytest.mark.parametrize("width", [(1 << 16) - 1, 1 << 16])
def test_ladder_without_reference_ends_at_the_pack_limit(tmp_path, spies,
                                                        monkeypatch, width):
    """Without a reference row (DISTANCE_TPU_NO_REL_PACK) a diverse square
    below 2^16 sites goes narrow (saturated) -> wide, and at 2^16 sites,
    where no 16-bit field holds a counter, int32 from the start; the bytes
    are numpy's."""
    monkeypatch.setenv("DISTANCE_TPU_NO_REL_PACK", "1")
    f1, _ = diverse_fastas(n1=12, width=width)
    args = mode_args(tmp_path, "square", f1, b"") + ["-m", "tn93"]
    before = spies()
    got, want = both(tmp_path, args)
    assert got == want
    d = delta(before, spies())
    assert d["rel4"] == d["rel"] == 0
    want_rungs = (1, 1, 0) if width < 1 << 16 else (0, 0, 1)
    assert (d["narrow"], d["wide"], d["none"]) == want_rungs


def test_sticky_ladder_skips_saturating_rungs(tmp_path, spies, monkeypatch):
    """After NARROW_STICKY_LIMIT consecutive saturations at rel4 and at
    rel, later strips are first dispatched narrow, and after as many at
    narrow, wide: with one strip in flight at a time
    (DISTANCE_TPU_LOOKAHEAD=0), a diverse square of 600 sites and ten
    strips goes rel4 (refetched at rel, then wide) twice, narrow
    (refetched wide) twice, then wide."""
    monkeypatch.setenv("DISTANCE_TPU_LOOKAHEAD", "0")
    monkeypatch.setattr(port_engine, "TILE_I", 32)
    monkeypatch.setattr(port_engine, "TILE_J", 512)
    f1, _ = diverse_fastas(n1=300, width=600)
    args = mode_args(tmp_path, "square", f1, b"") + ["-m", "raw"]
    before = spies()
    got, want = both(tmp_path, args)
    assert got == want
    d = delta(before, spies())
    assert (d["rel4"], d["rel"], d["narrow"], d["wide"], d["none"]) == (
        2, 2, 2, 10, 0)


@pytest.mark.parametrize("tile_i, tile_j, n", [(14, 7, 28), (18, 9, 27)])
def test_odd_tiles_pack_at_rel(tmp_path, spies, monkeypatch, tile_i, tile_j,
                               n):
    """rel4 packs columns two a byte: blocks of an odd width take rel."""
    monkeypatch.setattr(port_engine, "TILE_I", tile_i)
    monkeypatch.setattr(port_engine, "TILE_J", tile_j)
    f1, _ = low_diversity_fastas(seed=6, n1=n, width=300)
    args = mode_args(tmp_path, "square", f1, b"") + ["-m", "tn93"]
    before = spies()
    got, want = both(tmp_path, args)
    assert got == want
    d = delta(before, spies())
    assert d["rel4"] == 0 and d["rel"] >= 4 and d["none"] == 0


@pytest.mark.parametrize("data", ["low", "diverse"])
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_shards_equal_the_unsharded_numpy_run(tmp_path, data, mode):
    """Three shards of each mode, packed (and saturating), concatenate
    (square, rectangle) or merge (stream) to numpy's bytes."""
    f1, f2 = (low_diversity_fastas(seed=7, n1=40, n2=45, width=300, nmut=5)
              if data == "low" else diverse_fastas(n1=60, n2=50))
    args = mode_args(tmp_path, mode, f1, f2, batch=5) + ["-m", "k80"]
    want = both(tmp_path, args)[1]
    parts = []
    for k in range(3):
        parts.append(str(tmp_path / f"part{k}"))
        assert port_cli.main([*args, "--backend", "torch", "--shard",
                              f"{k}/3", "-o", parts[-1]]) == 0
    if mode == "stream":
        merged = tmp_path / "merged.tsv"
        assert port_cli.main(["--merge", *parts, "-o", str(merged)]) == 0
        got = merged.read_bytes()
    else:
        got = b"".join(Path(p).read_bytes() for p in parts)
    assert got == want


@pytest.mark.parametrize("mode", ["square", "stream"])
def test_launch_2_packed_and_saturating(tmp_path, mode):
    """``--launch 2`` workers (processes of their own) run the packed path
    and its ladder; the merged file is numpy's."""
    f1, f2 = diverse_fastas(n1=60, n2=50)
    args = mode_args(tmp_path, mode, f1, f2, batch=5) + ["-m", "tn93"]
    want = both(tmp_path, args)[1]
    out = tmp_path / "launched.tsv"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "distance_tpu_torch.cli", *args, "--backend",
         "torch", "--launch", "2", "-o", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == want


@pytest.mark.parametrize("rung", ["rel4", "narrow"])
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_refetches_repack_the_kept_counters(tmp_path, spies, monkeypatch,
                                            mode, rung):
    """A strip (stream group) saturated at rel4, or without a reference
    row at narrow, is packed again at the next rungs from the int32
    counters its first dispatch kept on the device: the counter kernel
    runs for first dispatches and baselines alone.  The bytes are
    numpy's."""
    if rung == "narrow":
        monkeypatch.setenv("DISTANCE_TPU_NO_REL_PACK", "1")
    # past 255 differences a pair the narrow lanes saturate
    f1, f2 = diverse_fastas(width=600)
    args = mode_args(tmp_path, mode, f1, f2, batch=140) + ["-m", "raw"]
    before = spies()
    got, want = both(tmp_path, args)
    assert got == want
    d = delta(before, spies())
    check_no_recount(d)
    if rung == "rel4":
        assert d["rel4"] == d["rel"] == d["wide"] == d["first"]
        # the row and column baselines and the reference row's own; a
        # stream group's column baseline once, refetched or not
        assert d["baselines"] == (2 + d["first"] if mode == "stream" else 3)
    else:
        assert d["narrow"] == d["wide"] == d["first"]
        assert d["baselines"] == d["rel4"] == d["rel"] == 0

