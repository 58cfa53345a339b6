"""The stream's early flush and its pair-sized groups.

A group whose counters are back goes to the emitter before the sweep
waits for the next streamed record; at most ``layout.pending`` groups wait
behind the newest otherwise.  An in-core, unsharded stream's auto group
holds about ``STREAM_GROUP_PAIRS`` pairs (more for a plan of more than
two counters).  Every port run here is
``--backend torch`` (whose fetches are always done), held against the JAX
CLI's ``--backend numpy`` bytes.
"""

import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch import writer  # noqa: E402
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
from distance_tpu_torch.parallel.multihost import UnitIndex  # noqa: E402
from distance_tpu_torch.utils import timing  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402

N1, N2 = 13, 29
# a pairs cap that cuts the 29 streamed records into groups of 6 (5
# groups) at a plan of up to two counters
GROUP = 6
CUDA = torch.device("cuda")
CARD_80GB = (84_465_090_560, 85_017_493_504)


class _Boom(Exception):
    pass


@pytest.fixture(autouse=True)
def _no_jit_cache(monkeypatch):
    # the JAX CLI would otherwise keep a compilation cache under $HOME
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(19)
    d = tmp_path_factory.mktemp("flush")
    a, b = d / "a.fasta", d / "b.fasta"
    a.write_bytes(make_fasta(random_seqs(rng, N1, 64, amb_frac=0.2)))
    b.write_bytes(make_fasta(random_seqs(rng, N2, 64, amb_frac=0.2)))
    return str(a), str(b)


@pytest.fixture
def pair_groups(monkeypatch):
    """Auto groups of GROUP records against the N1 loaded ones."""
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 0)
    monkeypatch.setattr(port_engine, "STREAM_GROUP_PAIRS", GROUP * N1 + 1)
    monkeypatch.setattr(port_engine, "STREAM_GROUP_FLOOR", 2)


def group_of(measure):
    """The pair-sized group of ``pair_groups``: GROUP records for a plan
    of up to two counters, twice that for tn93's four."""
    return port_engine._stream_pairs_cap(N1, len(get_plan(measure).counters))


def jax_tsv(tmp_path, args):
    out = tmp_path / "jax.tsv"
    assert jax_cli.main([*args, "--backend", "numpy", "-o", str(out)]) == 0
    return out.read_bytes()


def port_tsv(tmp_path, args):
    out = tmp_path / "port.tsv"
    assert port_cli.main([*args, "--backend", "torch", "-o", str(out)]) == 0
    return out.read_bytes()


def spy_groups(monkeypatch):
    """The streamed records of each block the stream launches."""
    seen = []
    real = port_engine._BlockEngine.block

    def spy(self, m1, m2, i0, j0, bi, bj, *rest, **kw):
        seen.append(bj)
        return real(self, m1, m2, i0, j0, bi, bj, *rest, **kw)

    monkeypatch.setattr(port_engine._BlockEngine, "block", spy)
    return seen


@pytest.mark.parametrize("batch", [1, GROUP + 2])
@pytest.mark.parametrize("measure", ["raw", "n", "tn93"])
def test_pair_sized_groups_give_the_jax_engines_tsv(tmp_path, monkeypatch,
                                                     inputs, pair_groups,
                                                     measure, batch):
    """Several pair-sized groups, each emitted as it comes back, at -b 1
    and at a -b larger than a group (a batch then fills groups of its
    own), write the JAX CLI's bytes."""
    a, b = inputs
    args = [a, "-s", b, "-m", measure, "-b", str(batch)]
    seen = spy_groups(monkeypatch)
    timing.reset()
    assert port_tsv(tmp_path, args) == jax_tsv(tmp_path, args)
    assert group_of(measure) == (2 * GROUP if measure == "tn93" else GROUP)
    assert sum(seen) == N2 and max(seen) <= group_of(measure)
    assert len(seen) >= 3
    counts = dict(timing._COUNTS)
    assert counts["stream-fill"] == 1
    # every group but the one the stream's end dispatches goes early
    assert counts["stream-early-flush"] == len(seen) - 1


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("measure", ["raw", "k80", "tn93"])
def test_keyed_memo_of_pair_sized_groups_gives_the_jax_engines_tsv(
        tmp_path, monkeypatch, inputs, pair_groups, measure, sharded):
    """Every group's rows through the writer's keyed memo (its row
    threshold lowered to one row): the bytes are the JAX CLI's.  Sharded,
    the groups of each part, as its ``.units`` sidecar counts them, sum
    to the part's bytes past its preamble, and the parts merge to the
    same bytes."""
    a, b = inputs
    args = [a, "-s", b, "-m", measure, "-b", "1"]
    want = jax_tsv(tmp_path, args)
    monkeypatch.setattr(writer, "_MEMO_MIN_ROWS", 1)
    tables = []
    real_table = writer._value_table

    def table(*a, **kw):
        tables.append(a[2])  # the keyspace
        return real_table(*a, **kw)

    monkeypatch.setattr(writer, "_value_table", table)
    if not sharded:
        assert port_tsv(tmp_path, args) == want
        # one keyed table a group
        assert len(tables) == -(-N2 // group_of(measure))
        return
    # a shard's auto group follows no pairs cap: fix it at the same size
    monkeypatch.setattr(port_engine, "STREAM_GROUP", group_of(measure))
    parts = [str(tmp_path / f"part{k}") for k in range(2)]
    ordinals = []
    for k, part in enumerate(parts):
        assert port_cli.main([*args, "--backend", "torch", "--shard",
                              f"{k}/2", "-o", part]) == 0
        index = UnitIndex(part)
        assert index.load()
        assert all(g % 2 == k for g, _ in index.units)
        assert (sum(nbytes for _, nbytes in index.units)
                == os.path.getsize(part) - index.preamble)
        ordinals += [g for g, _ in index.units]
    groups = -(-N2 // group_of(measure))
    assert sorted(ordinals) == list(range(groups)) and len(tables) == groups
    out = tmp_path / "merged.tsv"
    assert port_cli.main(["--merge", *parts, "-o", str(out)]) == 0
    assert out.read_bytes() == want


def closure(fn, seen=None):
    """Every value a function's closure holds, through the functions in
    it."""
    seen = set() if seen is None else seen
    for cell in fn.__closure__ or ():
        value = cell.cell_contents
        if id(value) not in seen:
            seen.add(id(value))
            yield value
            if inspect.isfunction(value):
                yield from closure(value, seen)


def test_the_emission_tail_holds_no_group(tmp_path, monkeypatch, inputs,
                                          pair_groups):
    """What the stream hands the emitter holds no group in flight: a
    group's device codes and pinned fetch go once it is handed over, not
    once its rows are written."""
    a, b = inputs
    args = [a, "-s", b, "-m", "raw", "-b", "1"]
    held = []
    real_submit = port_engine._AsyncEmitter.submit

    def submit(self, fn):
        held.append(any(isinstance(v, port_engine._Group)
                        for v in closure(fn)))
        return real_submit(self, fn)

    monkeypatch.setattr(port_engine._AsyncEmitter, "submit", submit)
    assert port_tsv(tmp_path, args) == jax_tsv(tmp_path, args)
    assert held == [False] * -(-N2 // GROUP)


def log_order(monkeypatch):
    """Events of a stream, in order: ("record", id) as the sweep takes
    each streamed record, ("submit",) as a group goes to the emitter.  The
    producer runs on the sweep's thread, so a record is taken as it is
    made."""
    events = []
    real_stream = port_engine.stream_fasta

    def stream(*args, **kw):
        for batch in real_stream(*args, **kw):
            events.extend(("record", i) for i in batch.ids)
            yield batch

    real_submit = port_engine._AsyncEmitter.submit

    def submit(self, fn):
        events.append(("submit",))
        return real_submit(self, fn)

    monkeypatch.setattr(port_engine, "stream_fasta", stream)
    monkeypatch.setattr(port_engine, "_threaded_iter", iter)
    monkeypatch.setattr(port_engine._AsyncEmitter, "submit", submit)
    return events


def records_before_each_submit(events):
    taken, out = 0, []
    for ev in events:
        if ev[0] == "record":
            taken += 1
        else:
            out.append(taken)
    return out


@pytest.mark.parametrize("done", [True, False])
def test_a_group_is_emitted_once_its_fetch_is_done(tmp_path, monkeypatch,
                                                   inputs, pair_groups, done):
    """With fetches that are done, group k reaches the emitter before the
    record that opens group k + 1 is taken; with fetches that never are,
    a group goes only once layout.pending later groups were dispatched,
    and the rest at the stream's end.  The bytes are the same."""
    a, b = inputs
    args = [a, "-s", b, "-m", "raw", "-b", "1"]
    want = jax_tsv(tmp_path, args)
    monkeypatch.setattr(port_engine._AsyncFetch, "done",
                        lambda self: done)
    events = log_order(monkeypatch)
    timing.reset()
    assert port_tsv(tmp_path, args) == want
    groups = -(-N2 // GROUP)
    pending = port_engine.STREAM_PENDING
    if done:
        # the last group is dispatched at the stream's end
        want_taken = [GROUP * (k + 1) for k in range(groups - 1)] + [N2]
        assert timing._COUNTS["stream-early-flush"] == groups - 1
    else:
        want_taken = ([GROUP * (k + 1 + pending)
                       for k in range(groups - 1 - pending)]
                      + [N2] * (pending + 1))
        assert "stream-early-flush" not in timing._COUNTS
    assert records_before_each_submit(events) == want_taken
    assert timing._COUNTS["stream-fill"] == 1


def test_a_cpu_fetch_is_always_done():
    fetch = port_engine._AsyncFetch(torch.zeros(3, dtype=torch.int32))
    assert fetch.done()
    fetch = port_engine._AsyncFetch((torch.zeros(2), torch.ones(2)))
    assert fetch.done()


@pytest.fixture
def card_80gb(monkeypatch):
    """An H100 80GB's memory, and a third of 96 GiB of host RAM."""
    monkeypatch.setattr(port_engine, "_card_memory", lambda device: CARD_80GB)
    monkeypatch.setattr(port_engine, "_strip_ram_budget",
                        lambda deterministic=False: (96 << 30) // 3)


def layouts(n1, measure, sharded=False):
    return port_engine._stream_layout(n1, 29904, measure, CUDA, 2048,
                                      sharded=sharded)


@pytest.mark.parametrize("measure, want", [
    ("n", 2096), ("n_high", 2096), ("raw", 2096), ("jc69", 2096),
    ("k80", 3144),    # 3 counters: 6 M pairs
    ("tn93", 4194),   # 4 counters: 8 M pairs
])
def test_in_core_group_holds_about_four_million_pairs(card_80gb, measure,
                                                      want):
    """2,000 loaded records: 2,096 streamed records a group in core for a
    plan of up to two counters (was 8,192), more for more counters, the
    caches engaged with it; the module constants have their shipped
    values."""
    assert port_engine.STREAM_GROUP_PAIRS == 1 << 22
    assert port_engine.STREAM_GROUP_FLOOR == 2048
    lay = layouts(2000, measure)
    assert lay.sr_rows == 0 and lay.cached
    assert (lay.group, lay.pending) == (want, port_engine.STREAM_PENDING)


@pytest.mark.parametrize("n1, counters, want", [
    (1, 2, 8192),       # the cap
    (2000, 1, 2096),    # one counter as two
    (2000, 2, 2096),
    (1003, 2, 4180),    # rounded down to even
    (3000, 4, 2796),
    (3000, 2, 2048),    # the floor
    (20_000, 2, 2048),
])
def test_pairs_cap(n1, counters, want):
    assert port_engine._stream_pairs_cap(n1, counters) == want


@pytest.mark.parametrize("case", ["staged", "sharded", "sharded staged",
                                  "fixed"])
def test_staged_sharded_and_fixed_groups_keep_their_size(card_80gb,
                                                         monkeypatch, case):
    """Only the in-core, unsharded auto group follows the pairs cap: a
    staged stream (1,000,000 loaded records), a shard (in core or staged)
    and a STREAM_GROUP size are what they are without it."""
    n1 = 1_000_000 if "staged" in case else 2000
    sharded = "sharded" in case
    if case == "fixed":
        monkeypatch.setattr(port_engine, "STREAM_GROUP", 1000)
    lay = layouts(n1, "raw", sharded)
    assert bool(lay.sr_rows) == ("staged" in case)
    monkeypatch.setattr(port_engine, "STREAM_GROUP_PAIRS", 1 << 62)
    assert layouts(n1, "raw", sharded) == lay


@pytest.mark.parametrize("n1, want", [
    (2000, 2096),
    (8000, 2048),     # the pairs cap, 524, under the staged floor
    (16_384, 2048),
])
def test_in_core_group_is_fixed_by_the_cards_total_memory(card_80gb,
                                                          monkeypatch, n1,
                                                          want):
    """A card whose free memory cannot hold the in-core stream runs it
    staged, in the capped groups of a free card: the group, a resume
    unit, does not follow what is free, and never falls below the
    staged stream's floor, since each staged group uploads the whole
    loaded side again."""
    free = layouts(n1, "raw")
    monkeypatch.setattr(port_engine, "_card_memory",
                        lambda device: (60 << 20, CARD_80GB[1]))
    busy = layouts(n1, "raw")
    assert busy.sr_rows and not free.sr_rows
    assert busy.group == free.group == want
    assert want >= port_engine.STREAM_GROUP_FLOOR


def test_resume_of_an_early_flushed_stream(tmp_path, monkeypatch, inputs,
                                           pair_groups):
    """A stream cut after its second pair-sized group resumes from it and
    writes the JAX CLI's bytes; the progress file records the group."""
    a, b = inputs
    out = tmp_path / "out.tsv"
    base = [a, "-s", b, "-m", "tn93", "-b", "1"]
    args = [*base, "--resume", "-o", str(out)]
    real = port_engine._progress_mark
    marks = []

    def bomb(setup, units):
        real(setup, units)
        marks.append(units)
        if len(marks) >= 2:
            raise _Boom()

    monkeypatch.setattr(port_engine, "_progress_mark", bomb)
    with pytest.raises(_Boom):
        setup = port_engine.set_up(port_cli.build_parser().parse_args(
            [*args, "--backend", "torch"]))
        try:
            port_engine.run(setup)
        finally:
            setup.writer.close()
    monkeypatch.setattr(port_engine, "_progress_mark", real)
    sidecar = json.loads((tmp_path / "out.tsv.progress").read_text())
    assert sidecar["units_done"] == 2
    assert sidecar["config"]["stream_group"] == group_of("tn93")
    assert port_cli.main([*args, "--backend", "torch"]) == 0
    assert out.read_bytes() == jax_tsv(tmp_path, base)
    assert not (tmp_path / "out.tsv.progress").exists()
