"""Out-of-core runs of the port write the in-core bytes.

The device and host budgets of ``distance_tpu_torch.engine`` are lowered
by monkeypatch, so that ``--backend torch`` (the plain version on the
CPU) takes the blocked square and rectangle sweeps and the staged stream
on small seeded fixtures.  Their TSVs are held against ``distance
--backend numpy``, and for raw and tn93 against the JAX package's own
blocked paths (``--backend xla`` with its budgets lowered, as
``tests/test_outofcore.py`` runs them).  The sizing is checked as
arithmetic at the sizes users run: budgets of tens of GB, millions of
records.
"""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distance_tpu.engine as jax_engine  # noqa: E402
from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.ops import counters as kernels  # noqa: E402
from distance_tpu_torch.ops import packing  # noqa: E402
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402
from tests.test_golden import run_engine  # noqa: E402
from tests.test_torch_rect_stream import (  # noqa: E402
    _Boom,
    interrupt_after,
    make_setup,
    run_setup,
    write,
)

# Budgets that send every fixture below out of core for every measure,
# with several X groups and super-rows (8 x 8 tiles, 128 padded sites):
# the load sweeps need 13.5-45 kB in core, the stream 9.7-24 kB.
LOAD_BUDGET = 12000
STREAM_BUDGET = 2500
HOST_BUDGET = 10240


@pytest.fixture(autouse=True)
def _no_jit_cache(monkeypatch):
    # the JAX CLI would otherwise keep a compilation cache under $HOME
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")


@pytest.fixture(scope="module")
def fastas():
    rng = np.random.default_rng(12345)
    return {
        "square": make_fasta(random_seqs(rng, 40, 90, amb_frac=0.2)),
        "file1": make_fasta(random_seqs(rng, 37, 90, amb_frac=0.2)),
        "file2": make_fasta(random_seqs(rng, 23, 90, amb_frac=0.2)),
        "loaded": make_fasta(random_seqs(rng, 33, 90, amb_frac=0.2)),
        "streamed": make_fasta(random_seqs(rng, 21, 90, amb_frac=0.2)),
    }


def mode_args(tmp_path, fastas, mode, batch=3):
    if mode == "square":
        return write(tmp_path, fastas["square"])
    if mode == "rectangle":
        return write(tmp_path, fastas["file1"], fastas["file2"])
    loaded, streamed = write(tmp_path, fastas["loaded"], fastas["streamed"])
    return [loaded, "-s", streamed, "-b", str(batch)]


def lower_budgets(monkeypatch, mode, tile=(8, 8), group=4,
                  host=HOST_BUDGET):
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET",
                        STREAM_BUDGET if mode == "stream" else LOAD_BUDGET)
    monkeypatch.setattr(port_engine, "HOST_BUF_BUDGET", host)
    monkeypatch.setattr(port_engine, "TILE_I", tile[0])
    monkeypatch.setattr(port_engine, "TILE_J", tile[1])
    monkeypatch.setattr(port_engine, "STREAM_GROUP", group)


class Seen:
    """What a run did out of core: blocked sweeps, staged groups, X-group
    uploads, and each super-row asked of a ``_StagedSide`` (with whether
    it was the resident one)."""

    def __init__(self, monkeypatch):
        self.blocked = self.staged = self.x_groups = 0
        self.gets = []
        self.stage_bns = []
        real_blocked = port_engine._sweep_blocked
        real_staged = port_engine._dispatch_stream_staged
        real_get = port_engine._StagedSide.get
        real_timer = port_engine.phase_timer

        def blocked(*a, **k):
            self.blocked += 1
            return real_blocked(*a, **k)

        def staged(*args):
            self.staged += 1
            self.stage_bns.append(args[-1])  # the group's records
            return real_staged(*args)

        def get(side, q0, q1):
            self.gets.append((q0, q1, side._key == (q0, q1)))
            return real_get(side, q0, q1)

        def timer(name):
            self.x_groups += name == "ooc-xgroup-prepare"
            return real_timer(name)

        monkeypatch.setattr(port_engine, "_sweep_blocked", blocked)
        monkeypatch.setattr(port_engine, "_dispatch_stream_staged", staged)
        monkeypatch.setattr(port_engine._StagedSide, "get", get)
        monkeypatch.setattr(port_engine, "phase_timer", timer)

    @property
    def super_rows(self):
        return {(q0, q1) for q0, q1, _ in self.gets}

    @property
    def uploads(self):
        return sum(not hit for *_, hit in self.gets)


def port_tsv(tmp_path, args, name="port.tsv"):
    out = tmp_path / name
    assert port_cli.main([*args, "--backend", "torch", "-o", str(out)]) == 0
    return out.read_bytes()


def jax_numpy_tsv(tmp_path, args):
    out = tmp_path / "jax.tsv"
    assert jax_cli.main([*args, "--backend", "numpy", "-o", str(out)]) == 0
    return out.read_bytes()


# -- parity ------------------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_out_of_core_six_measures_byte_identical(tmp_path, monkeypatch,
                                                 fastas, mode, measure):
    args = [*mode_args(tmp_path, fastas, mode), "-m", measure]
    want = jax_numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, mode)
    seen = Seen(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    # the out-of-core path ran, with more than one X group (stream
    # group) and more than one super-row
    if mode == "stream":
        assert seen.staged >= 2 and not seen.blocked
    else:
        assert seen.blocked == 1 and seen.x_groups >= 2
    assert len(seen.super_rows) >= 2


@pytest.mark.parametrize("measure", ["raw", "tn93"])
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_out_of_core_equals_the_jax_blocked_path(tmp_path, monkeypatch,
                                                 fastas, mode, measure):
    """The JAX package's blocked sweeps and staged stream, run as its own
    tests run them (``--backend xla`` on the CPU, budgets lowered), write
    the port's out-of-core bytes."""
    monkeypatch.setattr(jax_engine, "HBM_BUDGET_BYTES", 2000)
    monkeypatch.setattr(jax_engine, "HOST_BUF_BUDGET", 40000)
    monkeypatch.setenv("DISTANCE_TPU_STREAM_GROUP", "4")
    path = {"square": "_sweep_square_blocked",
            "rectangle": "_sweep_rectangle_blocked",
            "stream": "_dispatch_stream_staged"}[mode]
    calls = []
    real = getattr(jax_engine, path)
    monkeypatch.setattr(jax_engine, path,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if mode == "square":
        want, _ = run_engine(measure, fastas["square"], backend="xla")
    elif mode == "rectangle":
        want, _ = run_engine(measure, fastas["file1"], fastas["file2"],
                             backend="xla")
    else:
        want, _ = run_engine(measure, fastas["loaded"],
                             stream=fastas["streamed"], backend="xla")
    assert calls, "the JAX blocked path never engaged"
    lower_budgets(monkeypatch, mode)
    args = [*mode_args(tmp_path, fastas, mode), "-m", measure]
    assert port_tsv(tmp_path, args) == want


@pytest.mark.parametrize("tile", [(8, 16), (8, 32), (16, 32), (16, 8)])
def test_blocked_square_unaligned_tiles(tmp_path, monkeypatch, tile):
    """Groups of one strip (ti) narrower than a block (tj): a group's
    first block begins before its column origin, and its columns there
    are clipped (a negative offset would wrap the buffer)."""
    ti, tj = tile
    rng = np.random.default_rng(61)
    args = [*write(tmp_path, make_fasta(random_seqs(rng, 70, 90,
                                                    amb_frac=0.2))),
            "-m", "raw"]
    want = jax_numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, "square", tile=tile,
                  host=70 * 4 * 2 * (ti + 1))
    seen = Seen(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    assert seen.x_groups == -(-69 // ti)


@pytest.mark.parametrize("tile", [(8, 16), (16, 8)])
def test_blocked_rectangle_mixed_tiles(tmp_path, monkeypatch, fastas, tile):
    args = [*mode_args(tmp_path, fastas, "rectangle"), "-m", "jc69"]
    want = jax_numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, "rectangle", tile=tile)
    seen = Seen(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    assert seen.x_groups >= 2 and len(seen.super_rows) >= 2


@pytest.mark.parametrize("mode", ["square", "rectangle"])
def test_blocked_shards_concatenate_to_unsharded(tmp_path, monkeypatch,
                                                 fastas, mode):
    args = [*mode_args(tmp_path, fastas, mode), "-m", "k80"]
    want = jax_numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, mode)
    parts = [port_tsv(tmp_path, [*args, "--shard", f"{k}/3"], f"p{k}.tsv")
             for k in range(3)]
    assert all(parts) and b"".join(parts) == want


# -- resume ------------------------------------------------------------------

@pytest.mark.parametrize("marks", [1, 2])
@pytest.mark.parametrize("mode", ["square", "rectangle"])
def test_blocked_resume_misaligned_tiles(tmp_path, monkeypatch, fastas, mode,
                                         marks):
    """ti = 16 over tj = 8: groups stay multiples of ti, so the strip
    ordinals (the resume units) of different groups never collide and a
    resume skips no strip that was not written."""
    out = tmp_path / "out.tsv"
    args = [*mode_args(tmp_path, fastas, mode), "-m", "raw", "--resume",
            "-o", str(out)]
    want = jax_numpy_tsv(tmp_path, args[:-3])
    lower_budgets(monkeypatch, mode, tile=(16, 8))
    real = interrupt_after(monkeypatch, marks)
    with pytest.raises(_Boom):
        run_setup(make_setup(args, tile=(16, 8)))
    monkeypatch.setattr(port_engine, "_progress_mark", real)
    sidecar = json.loads((tmp_path / "out.tsv.progress").read_text())
    assert sidecar["units_done"] == marks
    seen = Seen(monkeypatch)
    run_setup(make_setup(args, tile=(16, 8)))
    assert seen.blocked == 1
    assert out.read_bytes() == want
    assert not (tmp_path / "out.tsv.progress").exists()


@pytest.mark.parametrize("first", ["in core", "out of core"])
@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_resume_moves_between_in_core_and_out_of_core(tmp_path, monkeypatch,
                                                      fastas, mode, first):
    """The resume config holds no budget: a run cut in core resumes out
    of core (a card with less free memory), and the reverse."""
    out = tmp_path / "out.tsv"
    args = [*mode_args(tmp_path, fastas, mode), "-m", "tn93", "--resume",
            "-o", str(out)]
    want = jax_numpy_tsv(tmp_path, args[:-3])
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 4)

    def budgets(out_of_core):
        if out_of_core:
            lower_budgets(monkeypatch, mode)
        else:
            monkeypatch.setattr(port_engine, "DEVICE_BUDGET", 0)

    budgets(first == "out of core")
    real = interrupt_after(monkeypatch, 2)
    with pytest.raises(_Boom):
        run_setup(make_setup(args, tile=(8, 8)))
    monkeypatch.setattr(port_engine, "_progress_mark", real)
    budgets(first == "in core")
    seen = Seen(monkeypatch)
    run_setup(make_setup(args, tile=(8, 8)))
    assert bool(seen.blocked or seen.staged) == (first == "in core")
    assert out.read_bytes() == want


def test_staged_stream_resume_records_the_staged_group(tmp_path, monkeypatch,
                                                       fastas):
    """At the auto group size a staged stream's groups are sized for
    staging, not in core; the sidecar records the size the run used, and
    a resume completes the bytes."""
    out = tmp_path / "out.tsv"
    args = [*mode_args(tmp_path, fastas, "stream", batch=1), "-m", "raw",
            "--resume", "-o", str(out)]
    want = jax_numpy_tsv(tmp_path, args[:-3])
    lower_budgets(monkeypatch, "stream", group=0, host=4000)
    monkeypatch.setattr(port_engine, "STAGED_ROWS_FLOOR", 2)
    # half the host budget over 2 int32 counters x 33 loaded rows
    staged_group = 4000 // 2 // (4 * 2 * 33) // 2 * 2
    assert staged_group == 6
    real = interrupt_after(monkeypatch, 2)
    with pytest.raises(_Boom):
        run_setup(make_setup(args))
    monkeypatch.setattr(port_engine, "_progress_mark", real)
    sidecar = json.loads((tmp_path / "out.tsv.progress").read_text())
    assert sidecar["units_done"] == 2
    assert sidecar["config"]["stream_group"] == staged_group
    seen = Seen(monkeypatch)
    run_setup(make_setup(args))
    assert seen.stage_bns == [6, 3]  # 21 records: groups 3 and 4 of 6, 6, 6, 3
    assert out.read_bytes() == want


# A card of 2,131,000 B whose loaded side (33 x 128 padded sites, raw)
# fits half of it in core with groups of 4 records: ``_stream_footprint``
# of 4 groups of 4 in flight, with their packs' sidecars, is 1,064,342 B,
# and of 4 groups of 6, 1,068,494 B.  Another process holding all but
# 6000 B sends the same stream out of core.
CARD_TOTAL = 2_131_000
CARD_FREE_LOW = 6000


@pytest.mark.parametrize("first", ["in core", "staged"])
def test_auto_stream_resumes_after_the_free_memory_changed(tmp_path,
                                                           monkeypatch, fastas,
                                                           first):
    """At the auto budget the group size, a resume unit, follows the
    card's total memory and not its free memory: a stream cut while the
    card was free resumes when it is nearly full (staged), and the
    reverse, at the same recorded group size."""
    out = tmp_path / "out.tsv"
    args = [*mode_args(tmp_path, fastas, "stream", batch=1), "-m", "raw",
            "--resume", "-o", str(out)]
    want = jax_numpy_tsv(tmp_path, args[:-3])
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 0)

    def card(free):
        monkeypatch.setattr(port_engine, "_card_memory",
                            lambda device: (free, CARD_TOTAL))

    card(CARD_TOTAL if first == "in core" else CARD_FREE_LOW)
    real = interrupt_after(monkeypatch, 2)
    with pytest.raises(_Boom):
        run_setup(make_setup(args, tile=(8, 8)))
    monkeypatch.setattr(port_engine, "_progress_mark", real)
    sidecar = json.loads((tmp_path / "out.tsv.progress").read_text())
    assert sidecar["config"]["stream_group"] == 4
    card(CARD_FREE_LOW if first == "in core" else CARD_TOTAL)
    seen = Seen(monkeypatch)
    run_setup(make_setup(args, tile=(8, 8)))
    assert bool(seen.staged) == (first == "in core")
    if seen.staged:  # groups 3 to 6 of 4, 4, 4, 4, 4, 1
        assert seen.stage_bns == [4, 4, 4, 1]
        assert len(seen.super_rows) >= 2
    assert out.read_bytes() == want


def test_card_memory_counts_the_allocator_cache(monkeypatch):
    """Memory torch's caching allocator holds unused is free for the
    next sweep: the budget does not shrink after an earlier run in the
    same process."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1000, 5000))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 700)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 200)
    assert port_engine._card_memory(CUDA) == (1500, 5000)
    assert port_engine._device_budget(CUDA) == 750
    assert port_engine._device_budget(CUDA, of_total=True) == 2500
    assert port_engine._card_memory(torch.device("cpu")) is None


# -- staged stream -----------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3, 7])
def test_staged_stream_batchsize_independence(tmp_path, monkeypatch, fastas,
                                              batch):
    args = [*mode_args(tmp_path, fastas, "stream", batch=batch), "-m",
            "jc69"]
    want = jax_numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, "stream")
    seen = Seen(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    assert seen.staged >= 2 and max(seen.stage_bns) <= 4


def test_staged_group_bounded_by_host_budget(tmp_path, monkeypatch):
    """A staged group assembles a (G, n1, rows) int32 host buffer: at the
    auto size its rows are capped so that it takes half the host budget
    (the floor lowered so that the cap binds)."""
    rng = np.random.default_rng(62)
    a, b = write(tmp_path, make_fasta(random_seqs(rng, 33, 90, amb_frac=0.2)),
                 make_fasta(random_seqs(rng, 40, 90, amb_frac=0.2)))
    args = [a, "-s", b, "-m", "raw"]
    want = jax_numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, "stream", group=0, host=4000)
    monkeypatch.setattr(port_engine, "STAGED_ROWS_FLOOR", 2)
    seen = Seen(monkeypatch)
    assert port_tsv(tmp_path, args) == want
    assert seen.stage_bns and max(seen.stage_bns) == 6  # see the resume test
    assert sum(seen.stage_bns) == 40


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_boundary_super_row_is_reused_across_groups(tmp_path, monkeypatch,
                                                    fastas, mode):
    """The serpentine order makes the last super-row of one group the
    first of the next: it stays on the device, and every group after the
    first uploads one super-row fewer than it sweeps."""
    args = [*mode_args(tmp_path, fastas, mode), "-m", "raw"]
    want = jax_numpy_tsv(tmp_path, args)
    lower_budgets(monkeypatch, mode)
    seen = Seen(monkeypatch)
    prepares = []
    real = port_engine._BlockEngine.prepare

    def prepare(eng, matrix, max_block, **kw):
        prepares.append(matrix.shape[0])
        return real(eng, matrix, max_block, **kw)

    monkeypatch.setattr(port_engine._BlockEngine, "prepare", prepare)
    assert port_tsv(tmp_path, args) == want
    hits = sum(hit for *_, hit in seen.gets)
    groups = seen.staged if mode == "stream" else seen.x_groups
    assert groups >= 2 and hits >= 1
    if mode != "square":  # the square's later groups sweep fewer spans
        assert hits == groups - 1
    # uploads: one per super-row miss, plus one per X group (load sweeps)
    assert len(prepares) == seen.uploads + (0 if mode == "stream" else groups)


@pytest.mark.parametrize("batch", [1, 2])
def test_staged_stream_mid_error(tmp_path, capsys, monkeypatch, batch):
    """A bad streamed record: every fully read batch is written, then the
    JAX CLI's error and exit 1."""
    rng = np.random.default_rng(63)
    recs = random_seqs(rng, 9, 30)
    recs[5] = (recs[5][0], recs[5][1][:10] + "Z" + recs[5][1][11:])
    a, b = write(tmp_path, make_fasta(random_seqs(rng, 20, 30)),
                 make_fasta(recs))
    args = [a, "-s", b, "-m", "raw", "-b", str(batch)]
    outs = {}
    for name, main, backend in (("jax", jax_cli.main, "numpy"),
                                ("port", port_cli.main, "torch")):
        if name == "port":
            lower_budgets(monkeypatch, "stream", group=2)
            seen = Seen(monkeypatch)
        out = tmp_path / f"{name}.tsv"
        capsys.readouterr()
        rc = main([*args, "--backend", backend, "-o", str(out)])
        err = capsys.readouterr().err
        outs[name] = (rc, out.read_bytes(), err.splitlines()[-1])
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 1 and "Invalid nucleotide" in outs["port"][2]
    assert seen.staged >= 2
    assert len(outs["port"][1].decode().splitlines()[1:]) == 20 * (
        4 if batch == 2 else 5)


# -- sizing at the sizes users run -------------------------------------------

GB = 10 ** 9
SIZING_BUDGET = 40 * GB
SIZING_HOST = 4 << 30
SIZING_MEASURES = {"n": 1, "raw": 2, "k80": 3, "tn93": 4}
SIZING_SHAPES = {
    "square 100k": ("square", 100_000, 100_000),
    "square 2M": ("square", 2_000_000, 2_000_000),
    "rectangle 10k x 2M": ("rectangle", 10_000, 2_000_000),
    "stream 2M loaded": ("stream", 2_000_000, None),
}
CUDA = torch.device("cuda", 0)


@pytest.fixture
def gb_budgets(monkeypatch):
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET", SIZING_BUDGET)
    monkeypatch.setattr(port_engine, "HOST_BUF_BUDGET", SIZING_HOST)
    # the host's RAM picks the strip height of the auto tiles: fix it at a
    # third of 96 GiB
    monkeypatch.setattr(port_engine, "_strip_ram_budget",
                        lambda deterministic=False: (96 << 30) // 3)


@pytest.mark.parametrize("width", [29904, 1024, 128])
@pytest.mark.parametrize("measure", list(SIZING_MEASURES))
@pytest.mark.parametrize("shape", list(SIZING_SHAPES))
def test_out_of_core_sizing_at_gb_scale(gb_budgets, shape, measure, width):
    """Pure arithmetic, nothing allocated: the rows are nonzero and
    tile-aligned, the device bytes (codes and the int32 counters in
    flight) stay within the device budget, the host buffers within half
    of the host budget (unless one strip or the staged floor alone needs
    more), and every launch within the kernel's limits."""
    mode, n1, n2 = SIZING_SHAPES[shape]
    g = SIZING_MEASURES[measure]
    assert len(get_plan(measure).counters) == g
    l_pad = -(-width // 128) * 128
    if mode == "stream":
        ti = min(port_engine._cap_tile_ram(
            port_engine._auto_tile(CUDA), n1, measure, False
        ), port_engine._pow2_at_least(n1))
        lay = port_engine._stream_layout(n1, width, measure, CUDA, ti)
        assert 2 <= lay.group <= port_engine.STREAM_GROUP_CAP
        assert lay.group % 2 == 0 and 1 <= lay.pending <= 3
        assert lay.group <= kernels.MAX_Y_ROWS
        if not lay.sr_rows:  # in core: one launch over every loaded row
            assert n1 <= kernels.MAX_X_ROWS
            assert n1 * l_pad + (lay.pending + 1) * lay.group * (
                g * n1 * 4 + l_pad) <= SIZING_BUDGET
            assert port_engine._stream_footprint(
                lay.group, n1, width, g, lay.pending + 1) <= SIZING_BUDGET
            assert g * n1 * lay.group <= packing.MAX_CELLS  # one pack
            return
        assert lay.sr_rows % ti == 0 and 0 < lay.sr_rows <= kernels.MAX_X_ROWS
        assert lay.group >= port_engine.STAGED_ROWS_FLOOR
        assert (lay.group + lay.sr_rows) * l_pad + (
            g * lay.sr_rows * lay.group * 4) <= SIZING_BUDGET
        assert port_engine._stream_footprint(
            lay.group, lay.sr_rows, width, g, 1, kept=n1) <= SIZING_BUDGET
        assert g * lay.sr_rows * lay.group <= packing.MAX_CELLS
        host = lay.pending * g * n1 * lay.group * 4
        assert host <= SIZING_HOST // 2 or (
            lay.pending == 1 and lay.group == port_engine.STAGED_ROWS_FLOOR)
        return
    setup = types.SimpleNamespace(tile_i=0, tile_j=0, measure=measure,
                                  shard=None)
    ti, tj = port_engine._choose_tiles(n1, n2, setup, CUDA)
    assert ti <= kernels.MAX_X_ROWS and tj <= kernels.MAX_Y_ROWS
    rows, sr = port_engine._blocked_layout(n1, n2, width, g, ti, tj,
                                           SIZING_BUDGET)
    assert rows > 0 and rows % ti == 0 and sr > 0 and sr % tj == 0
    y_rows = port_engine._padded_shape(sr, width, ti, tj)[0]
    assert rows * l_pad + y_rows * l_pad + (
        port_engine.STRIP_LOOKAHEAD + 1) * g * ti * y_rows * 4 <= SIZING_BUDGET
    kept = n2 + -(-n2 // tj) * max(ti, tj)  # every super-row's baselines
    assert port_engine._blocked_footprint(rows, y_rows, width, g, ti, tj,
                                          kept) <= SIZING_BUDGET
    assert g * rows * n2 * 4 <= SIZING_HOST // 2 or rows == ti


@pytest.mark.parametrize("measure, n1", [("raw", 131072), ("tn93", 65536),
                                         ("tn93", 1_000_000)])
def test_stream_groups_stay_within_one_pack(monkeypatch, measure, n1):
    """A stream group's (G, n1, rows) counters are packed in one launch,
    whose rel4 sidecar indexes cells with int32: on an 80 GB card the
    auto group stays below 2^31 cells where the cap of 8192 records would
    pass it (raw from 131072 loaded records, tn93 from 65536), in core and
    under a shard alike."""
    monkeypatch.setattr(port_engine, "_card_memory",
                        lambda device: (84_465_090_560, 85_017_493_504))
    monkeypatch.setattr(port_engine, "_strip_ram_budget",
                        lambda deterministic=False: (96 << 30) // 3)
    g = len(get_plan(measure).counters)
    for sharded in (False, True):
        lay = port_engine._stream_layout(n1, 29904, measure, CUDA, 8192,
                                         sharded=sharded)
        rows = lay.sr_rows or n1
        assert g * rows * lay.group <= packing.MAX_CELLS
        assert lay.group >= 2 and lay.group % 2 == 0
    assert g * n1 * port_engine.STREAM_GROUP_CAP > packing.MAX_CELLS


@pytest.mark.parametrize("measure, crossover", [("raw", 65536),
                                                ("tn93", 32768)])
def test_square_in_core_crossover_on_an_80gb_card(measure, crossover):
    """At 29904 sites and 8192-row tiles, the in-core square fits half of
    an H100 80GB HBM3's free memory up to this many records (whole
    strips: each strip in flight keeps its int32 counters for a refetch,
    beside one strip's packs); one record more goes out of core.  A host
    with less RAM halves the auto strip, which moves the crossover up."""
    budget = 84_465_090_560 // 2  # free at the start of a process
    g = len(get_plan(measure).counters)

    def footprint(n):
        rows = port_engine._padded_shape(n, 29904, 8192, 8192)[0]
        return port_engine._blocked_footprint(0, rows, 29904, g, 8192, 8192)

    assert footprint(crossover) <= budget < footprint(crossover + 1)


def test_budgets_default_to_the_device():
    assert port_engine.DEVICE_BUDGET == 0
    assert port_engine.HOST_BUF_BUDGET == 4 << 30
    assert port_engine.STAGED_ROWS_FLOOR == 256
    assert port_engine._device_budget(torch.device("cpu")) is None


def test_device_budget_applies_on_the_cpu(monkeypatch):
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET", 12345)
    assert port_engine._device_budget(torch.device("cpu")) == 12345

