"""The phase timers' spans (``utils/timing.py``): a job recorded through
the port's CLI on the CPU backend gives one root span ``job`` and the
sweep's spans, each with its job's ordinal and a parent that holds it;
with recording off nothing is kept and the totals only gain the new
phases' names."""

import os
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from distance_tpu_torch import cli, writer  # noqa: E402
from distance_tpu_torch.utils import timing  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402

MODES = ["square", "rectangle", "stream"]
SWEEP = {"dispatch", "fetch-wait", "finish", "emit-submit-wait",
         "emit-drain"}
# The phases each job had before spans: the new ones come beside them.
OLD = {
    "square": {"load+encode", "load-sweep", "diff-ref", "prepare-upload",
               "gather", "keys", "finalize", "write", "write:io"},
    "stream": {"load+encode", "stream-sweep", "stream-parse-wait",
               "stream-prepare-upload", "stream-group-build",
               "stream-upload", "stream-fetch-wait", "stream-gather", "keys",
               "finalize", "write", "write:io"},
}
OLD["rectangle"] = OLD["square"]
NEW = {"emit-idle", "write:format", "prune"} | SWEEP
# A sweep's wait for its first write: a total (``timing.add``) that
# keeps no span, since it ends inside another phase.  So does the
# loaded sweeps' early decline of the column prune (``prune-prefix``),
# which these diverse fixtures take.
UNNESTED = {"square": {"load-fill", "prune-prefix"},
            "rectangle": {"load-fill", "prune-prefix"},
            "stream": {"stream-fill"}}
# The pool's seconds formatting keyed rows ahead of their writes into an
# output that cannot be mapped: a total once a strip, summed over its
# chunks on the pool's threads, so no span.
RING_TOTALS = {"write:format-ahead"}
# once a process, so only in the first job that loads them
FIRST_USE = {"lib-load", "lib-build", "cuda-init"}


def _argv(tmp_path, mode):
    rng = np.random.default_rng(17)
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    a.write_bytes(make_fasta(random_seqs(rng, 30, 200, amb_frac=0.2)))
    b.write_bytes(make_fasta(
        (f"t{i}", s.upper())
        for i, (_, s) in enumerate(random_seqs(rng, 25, 200))))
    extra = {"square": [], "rectangle": [str(b)],
             "stream": ["-s", str(b), "-b", "4"]}[mode]
    return [str(a), *extra, "-m", "raw", "--backend", "torch", "-o",
            str(tmp_path / f"{mode}.tsv")]


def _job(argv):
    """One CLI job: (its spans, totals, perf_counter before and after)."""
    timing.take_spans()
    timing.reset()
    t0 = time.perf_counter()
    assert cli.main(argv) == 0
    t1 = time.perf_counter()
    return timing.take_spans(), timing.totals(), t0, t1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mode run twice with recording on, then once with it off."""
    out = {}
    timing.record_spans(True)
    try:
        for mode in MODES:
            argv = _argv(tmp_path_factory.mktemp(mode), mode)
            out[mode] = [_job(argv), _job(argv)]
    finally:
        timing.record_spans(False)
    for mode in MODES:
        argv = _argv(tmp_path_factory.mktemp(mode + "-off"), mode)
        out[mode].append(_job(argv))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_a_job_has_one_root(runs, mode):
    spans = runs[mode][0][0]
    roots = [s for s in spans if s.name == "job"]
    assert len(roots) == 1
    assert roots[0].parent is None and roots[0].thread == "MainThread"


@pytest.mark.parametrize("mode", MODES)
def test_spans_carry_their_job_and_lie_in_their_parent(runs, mode):
    spans = runs[mode][0][0]
    root, = (s for s in spans if s.name == "job")
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.job == root.job
        if s is root:
            continue
        parent = by_id[s.parent]
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1, (s, parent)
        # a thread's outermost span hangs from the job's root
        assert parent.thread == s.thread or parent is root, (s, parent)
    assert {s.thread for s in spans} >= {"MainThread", "emitter"}


@pytest.mark.parametrize("mode", MODES)
def test_the_sweep_spans_are_there(runs, mode):
    spans = runs[mode][0][0]
    names = {s.name for s in spans}
    assert SWEEP <= names
    assert ("stream-produce" in names) == (mode == "stream")
    main = {s.name for s in spans if s.thread == "MainThread"}
    assert SWEEP <= main
    assert {s.name for s in spans if s.thread == "emitter"} >= {"emit-idle"}
    produced = [s for s in spans if s.name == "stream-produce"]
    assert all(s.thread != "MainThread" for s in produced)


@pytest.mark.parametrize("mode", MODES)
def test_two_jobs_get_different_ordinals(runs, mode):
    first, second = runs[mode][0][0], runs[mode][1][0]
    assert len({s.job for s in first}) == len({s.job for s in second}) == 1
    assert first[0].job < second[0].job


@pytest.mark.parametrize("mode", MODES)
def test_span_times_lie_within_the_job(runs, mode):
    for spans, _, t0, t1 in runs[mode][:2]:
        assert spans
        assert all(t0 <= s.t0 <= s.t1 <= t1 for s in spans)


@pytest.mark.parametrize("mode", MODES)
def test_recording_off_keeps_nothing_and_keeps_the_totals(runs, mode):
    spans, totals, _, _ = runs[mode][2]
    assert spans == [] and timing.take_spans() == []
    new = NEW | UNNESTED[mode] | ({"stream-produce"} if mode == "stream"
                                  else set())
    assert set(totals) - FIRST_USE == OLD[mode] | new
    # recording on runs the same phases; the job's root is no phase
    assert set(runs[mode][1][1]) - FIRST_USE == set(totals) - FIRST_USE
    assert {s.name for s in runs[mode][1][0]} == set(
        runs[mode][1][1]) - UNNESTED[mode] | {"job"}


def _self_s(spans, root):
    """The root's seconds less the union of its children on its thread."""
    covered, end = 0.0, root.t0
    for c in sorted((s for s in spans
                     if s.parent == root.id and s.thread == root.thread),
                    key=lambda s: s.t0):
        a, b = max(c.t0, end), min(c.t1, root.t1)
        if b > a:
            covered, end = covered + b - a, b
    return root.t1 - root.t0 - covered


@pytest.mark.parametrize("mode", MODES)
def test_sweep_self_time_is_under_the_root(runs, mode):
    """What no span under the sweep's root names is part of the root, and
    the sweep's spans all descend from the root."""
    root_name = "stream-sweep" if mode == "stream" else "load-sweep"
    for spans, *_ in runs[mode][:2]:
        root, = (s for s in spans if s.name == root_name)
        assert 0 <= _self_s(spans, root) < root.t1 - root.t0
        by_id = {s.id: s for s in spans}
        for s in spans:
            if s.name in SWEEP:
                p = by_id[s.parent]
                while p is not root and p.name != "job":
                    p = by_id[p.parent]
                assert p is root, s


@pytest.mark.parametrize("mode", MODES)
def test_the_stream_producer_is_timed_with_recording_off(runs, mode):
    """Off, the producer's batches add one ``stream-produce`` total a job
    (no timer a batch), and the job's root adds none."""
    _, totals, t0, t1 = runs[mode][2]
    assert "job" not in totals
    if mode == "stream":
        assert 0 < totals["stream-produce"] < t1 - t0
    else:
        assert "stream-produce" not in totals


def test_the_rings_formatting_ahead_is_a_total_with_no_span(
        tmp_path, monkeypatch):
    """A square past the writer's keyed threshold (370 records, 68,265
    rows, 17 chunks of 4,096) into a FIFO: the ring adds its total and
    keeps no span of it, and each chunk's ``write:io`` lies beside
    ``write:assemble``."""
    monkeypatch.setattr(writer, "_FORMAT_CHUNK_ROWS", 4096)
    rng = np.random.default_rng(19)
    a = tmp_path / "a.fasta"
    a.write_bytes(make_fasta(random_seqs(rng, 370, 40, amb_frac=0.1)))
    fifo = tmp_path / "out.fifo"
    os.mkfifo(fifo)
    got = []

    def drain():
        with open(fifo, "rb") as f:
            got.append(len(f.read()))

    t = threading.Thread(target=drain)
    t.start()
    timing.take_spans()
    timing.record_spans(True)
    try:
        spans, totals, _, _ = _job([str(a), "-m", "raw", "--backend",
                                    "torch", "-o", str(fifo)])
    finally:
        timing.record_spans(False)
    t.join(timeout=120)
    assert not t.is_alive() and got[0] > 0
    assert RING_TOTALS <= set(totals)
    assert not RING_TOTALS & {s.name for s in spans}
    by_id = {s.id: s for s in spans}
    writes = [s for s in spans if s.name == "write:io"]
    assert len([s for s in writes if s.thread == "emitter"]) >= 17
    assert all(by_id[s.parent].name != "write:assemble" for s in writes
               if s.parent in by_id)


def _diverse_fasta(path, n, width, seed):
    """An ancestor with 30% of the cells redrawn: every pair differs at
    many sites, so rel4's sidecar overflows and every record has a base
    tally of its own."""
    rng = np.random.default_rng(seed)
    mat = np.tile(rng.choice(np.frombuffer(b"ACGT", np.uint8), width),
                  (n, 1))
    hit = rng.random(mat.shape) < 0.3
    mat[hit] = rng.choice(np.frombuffer(b"ACGT", np.uint8), int(hit.sum()))
    path.write_bytes(make_fasta(
        (f"r{i}", row.tobytes().decode()) for i, row in enumerate(mat)))


def test_a_saturated_strips_refetch_is_a_child_of_finish(tmp_path):
    """On diverse records the rel4 pack saturates: each redispatch at
    the next rung, its wait and its unpack are a span ``refetch`` inside
    ``finish``; the tn93 memo bails and adds the total ``keys-bail``,
    which keeps no span."""
    from distance_tpu_torch import engine

    a = tmp_path / "a.fasta"
    _diverse_fasta(a, 600, 120, 23)
    before = dict(engine.RUNG_BLOCKS)
    timing.take_spans()
    timing.record_spans(True)
    try:
        spans, totals, _, _ = _job([str(a), "-m", "tn93", "--backend",
                                    "torch", "-o", str(tmp_path / "o.tsv")])
    finally:
        timing.record_spans(False)
    assert engine.RUNG_BLOCKS["rel"] > before["rel"]
    by_id = {s.id: s for s in spans}
    refetch = [s for s in spans if s.name == "refetch"]
    assert refetch and all(s.thread == "MainThread" for s in refetch)
    for s in refetch:
        parent = by_id[s.parent]
        assert parent.name == "finish"
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    assert totals["refetch"] == pytest.approx(
        sum(s.t1 - s.t0 for s in refetch))
    assert totals["keys-bail"] > 0
    assert "keys-bail" not in {s.name for s in spans}


@pytest.mark.parametrize("mode", MODES)
def test_no_refetch_span_where_no_strip_saturates(runs, mode):
    """No strip of the fixtures saturates its pack: no ``refetch`` span
    or total, and no ``keys-bail`` (raw keeps no tn93 memo)."""
    for spans, totals, _, _ in runs[mode]:
        assert "refetch" not in {s.name for s in spans}
        assert not {"refetch", "keys-bail"} & set(totals)
