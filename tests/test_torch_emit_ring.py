"""Keyed rows into an output that cannot be mapped go out chunk by chunk
from a ring of recycled buffers (``distance_tpu_torch/ringwrite.py``).

The bytes equal the unkeyed formatting's, the one-buffer assembly's
(``writer._assemble_keyed`` without a sink) and the mmap window's, into
an in-memory file, a pipe and a FIFO, through the writer and through
the port's CLI (held against ``oracle_tsv``).  ``write:format-ahead``
counts the chunks that went through the ring; a regular file still
takes the mmap window and counts none.  A chunk that fails stops the
writes at the chunks before it, and a reader that closes the pipe
exits 0 through ``on_broken_pipe``.
"""

import ctypes
import io
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu_torch import cli, engine, ringwrite, writer  # noqa: E402
from distance_tpu_torch._native import get_lib  # noqa: E402
from distance_tpu_torch.fastaio import load_fasta  # noqa: E402
from distance_tpu_torch.utils import timing  # noqa: E402
from tests.conftest import make_fasta, oracle_tsv, random_seqs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 4096
KEYSPACE = 5000


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    """Chunks of 4,096 rows: a strip of 70,001 rows is 18 of them, and
    wraps a ring of RING_CHUNKS buffers several times."""
    monkeypatch.setattr(writer, "_FORMAT_CHUNK_ROWS", CHUNK)
    timing.reset()


def block(seed, n, id_len=9, kind="raw"):
    """(ids, pair_i, pair_j, values, keys) of a keyed strip of ``n`` rows:
    each row's value is a function of its key."""
    rng = np.random.default_rng(seed)
    ids = [f"s{i:0{id_len - 1}d}" for i in range(700)]
    pi = rng.integers(0, len(ids), n).astype(np.int32)
    pj = rng.integers(0, len(ids), n).astype(np.int32)
    keys = rng.integers(0, KEYSPACE, n).astype(np.int32)
    if kind == "raw":
        vals = keys.astype(np.float64) / 7.0
    else:
        vals = keys.astype(np.int64) * 3
    return ids, pi, pj, vals, keys


def unkeyed(ids, pi, pj, vals, keys):
    """The rows as the unkeyed formatting writes them."""
    return bytes(writer._format_rows(ids, ids, pi, pj, vals))


def one_buffer(ids, pi, pj, vals, keys):
    """The rows as one exact-size buffer assembles them (no sink)."""
    return bytes(writer._format_rows(ids, ids, pi, pj, vals, keys,
                                     KEYSPACE))


def put(w, strip):
    """One strip through the writer's ``rows``, as a square's sweep
    calls it."""
    ids, pi, pj, vals, keys = strip
    w.rows(ids, ids, pi, pj, vals, keys, KEYSPACE)


def emit(out, strips):
    """Every strip through one writer."""
    w = writer.TsvWriter(out)
    for strip in strips:
        put(w, strip)
    w.flush()
    return w


def chunks_of(*ns):
    return sum(-(-n // CHUNK) for n in ns)


class Pipe:
    """An ``os.pipe`` whose read end a thread drains."""

    def __init__(self):
        r, w = os.pipe()
        self.out = os.fdopen(w, "wb")
        self.data = b""
        self._r = os.fdopen(r, "rb")
        self._t = threading.Thread(target=self._drain)
        self._t.start()

    def _drain(self):
        self.data = self._r.read()
        self._r.close()

    def close(self):
        self.out.close()
        self._t.join(timeout=60)
        assert not self._t.is_alive()
        return self.data


@pytest.mark.parametrize("kind", ["raw", "n"])
@pytest.mark.parametrize("sink", ["bytesio", "pipe"])
def test_ring_writes_the_unkeyed_and_one_buffer_bytes(kind, sink):
    strip = block(1, 70_001, kind=kind)
    want = unkeyed(*strip)
    assert one_buffer(*strip) == want
    if sink == "bytesio":
        out = io.BytesIO()
        emit(out, [strip])
        got = out.getvalue()
    else:
        pipe = Pipe()
        emit(pipe.out, [strip])
        got = pipe.close()
    assert got == writer.HEADER + want
    assert timing._COUNTS["write:format-ahead"] == chunks_of(70_001) == 18
    assert timing.totals()["write:format-ahead"] > 0


def test_strips_reuse_the_ring_and_grow_it_when_a_chunk_outgrows_it():
    small = [block(2, 70_001), block(3, 66_000, kind="raw")]
    wide = block(4, 80_000, id_len=40)  # longer ids: larger chunks
    out = io.BytesIO()
    w = writer.TsvWriter(out)
    put(w, small[0])
    ring = {k: v for k, v in w._scratch.items() if k.startswith("ring")}
    assert len(ring) == ringwrite.RING_CHUNKS
    put(w, small[1])
    assert all(w._scratch[k] is v for k, v in ring.items())
    put(w, wide)
    for k, v in ring.items():
        assert w._scratch[k].nbytes > v.nbytes
    assert out.getvalue() == writer.HEADER + b"".join(
        unkeyed(*s) for s in small + [wide])
    assert timing._COUNTS["write:format-ahead"] == chunks_of(
        70_001, 66_000, 80_000)


def test_a_strip_of_one_chunk_goes_through_the_ring(monkeypatch):
    monkeypatch.setattr(writer, "_FORMAT_CHUNK_ROWS", 1 << 20)
    strip = block(5, 70_000)
    out = io.BytesIO()
    w = emit(out, [strip])
    assert out.getvalue() == writer.HEADER + unkeyed(*strip)
    assert timing._COUNTS["write:format-ahead"] == 1
    assert [k for k in w._scratch if k.startswith("ring")] == ["ring0"]


def test_a_regular_file_still_takes_the_mmap_window(tmp_path, monkeypatch):
    windows = []
    real = writer.TsvWriter._mmap_dest

    def spy(self, total):
        got = real(self, total)
        windows.append(got is not None)
        return got

    monkeypatch.setattr(writer.TsvWriter, "_mmap_dest", spy)
    strips = [block(6, 70_001), block(7, 65_536, kind="n")]
    path = tmp_path / "out.tsv"
    with open(path, "wb") as out:
        emit(out, strips)
    assert windows == [True, True]
    assert path.read_bytes() == writer.HEADER + b"".join(
        unkeyed(*s) for s in strips)
    assert timing._COUNTS.get("write:format-ahead", 0) == 0
    # a pipe is no regular file: no window, so the ring
    pipe = Pipe()
    emit(pipe.out, strips)
    assert pipe.close() == path.read_bytes()
    assert windows == [True, True, False, False]
    assert timing._COUNTS["write:format-ahead"] == chunks_of(70_001, 65_536)


def test_write_io_is_beside_write_assemble_never_inside_it():
    timing.take_spans()
    timing.record_spans(True)
    try:
        emit(io.BytesIO(), [block(8, 70_001)])
    finally:
        timing.record_spans(False)
    spans = timing.take_spans()
    by_id = {s.id: s for s in spans}
    ios = [s for s in spans if s.name == "write:io"]
    assembles = [s for s in spans if s.name == "write:assemble"]
    assert len(ios) == 1 + chunks_of(70_001)  # the header, then each chunk
    # the bounds, the ring's set-up, then each chunk's wait
    assert len(assembles) == 2 + chunks_of(70_001)
    for s in ios:
        assert s.parent not in by_id or by_id[s.parent].name != \
            "write:assemble"
    assert "write:format-ahead" not in {s.name for s in spans}


def fake_format(monkeypatch, pair_i, bad_chunk, how):
    """Makes the native call of chunk ``bad_chunk`` of a strip whose
    ``pair_i`` is given return one byte short, or raise."""
    lib = get_lib()
    real = lib.dt_format_rows_pre
    target = pair_i.ctypes.data + 4 * bad_chunk * CHUNK

    def fake(*args):
        w = real(*args)
        if ctypes.cast(args[4], ctypes.c_void_p).value == target:
            if how == "raises":
                raise OSError("formatting failed")
            return w - 1
        return w

    monkeypatch.setattr(lib, "dt_format_rows_pre", fake)


@pytest.mark.parametrize("how, error", [("short", RuntimeError),
                                        ("raises", OSError)])
def test_a_failed_chunk_stops_the_writes_before_it(monkeypatch, how, error):
    ids, pi, pj, vals, keys = strip = block(9, 70_001)
    rows = unkeyed(*strip).splitlines(keepends=True)
    bad = 7
    fake_format(monkeypatch, pi, bad, how)
    out = io.BytesIO()
    w = writer.TsvWriter(out)
    after = []

    def tail():
        w.rows(ids, ids, pi, pj, vals, keys, KEYSPACE)
        after.append(1)

    emitter = engine._AsyncEmitter()
    emitter.submit(tail)
    with pytest.raises(error):
        emitter.finish()
    w.flush()
    assert out.getvalue() == writer.HEADER + b"".join(rows[:bad * CHUNK])
    assert after == []
    assert "write:format-ahead" not in timing._COUNTS


class _Exited(Exception):
    pass


def test_a_reader_that_closes_the_pipe_mid_strip_exits_0(monkeypatch):
    """The writer's broken-pipe exit: ``on_broken_pipe``, then exit 0
    (``os._exit``, caught here), with no further chunk written."""
    codes, cleared = [], []

    def _exit(code):
        codes.append(code)
        raise _Exited

    monkeypatch.setattr(os, "_exit", _exit)
    monkeypatch.setattr(sys, "stderr", io.StringIO())
    r, wfd = os.pipe()
    reader = os.fdopen(r, "rb")
    head = []

    def read_some():
        head.append(reader.read(1000))
        reader.close()

    t = threading.Thread(target=read_some)
    t.start()
    ids, pi, pj, vals, keys = strip = block(10, 70_001)
    w = writer.TsvWriter(os.fdopen(wfd, "wb"),
                         on_broken_pipe=lambda: cleared.append(1))
    with pytest.raises(_Exited):
        w.rows(ids, ids, pi, pj, vals, keys, KEYSPACE)
    t.join(timeout=60)
    assert not t.is_alive()
    assert codes == [0] and cleared == [1]
    assert head[0] == (writer.HEADER + unkeyed(*strip))[:1000]
    assert "write:format-ahead" not in timing._COUNTS


# The port's CLI into a pipe: a square of 400 records (79,800 rows) and
# a stream of 300 loaded by 250 streamed records (75,000 rows), each past
# the writer's keyed threshold.
def cli_fastas(tmp_path):
    rng = np.random.default_rng(2121)
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    a.write_bytes(make_fasta(random_seqs(rng, 400, 40, amb_frac=0.1)))
    b.write_bytes(make_fasta(
        (f"t{i}", s) for i, (_, s) in enumerate(
            random_seqs(rng, 250, 40, amb_frac=0.1))))
    return a, b


def drained(path):
    """A thread that reads the FIFO ``path`` to its end."""
    got = []

    def drain():
        with open(path, "rb") as f:
            got.append(f.read())

    t = threading.Thread(target=drain)
    t.start()
    return t, got


@pytest.mark.parametrize("mode", ["square", "stream"])
def test_the_cli_writes_the_oracles_bytes_into_a_pipe(tmp_path, mode):
    a, b = cli_fastas(tmp_path)
    fifo = tmp_path / "out.fifo"
    os.mkfifo(fifo)
    t, got = drained(fifo)
    args = [str(a)] + (["-s", str(b)] if mode == "stream" else [])
    assert cli.main(args + ["-m", "raw", "--backend", "torch", "-o",
                            str(fifo)]) == 0
    t.join(timeout=120)
    assert not t.is_alive()
    aln1 = load_fasta(open(a, "rb"))
    if mode == "square":
        want, rows = oracle_tsv("raw", aln1), 400 * 399 // 2
    else:
        aln2 = load_fasta(open(b, "rb"))
        want = oracle_tsv("raw", aln1, aln2, stream_ids=aln2.ids)
        rows = 400 * 250
    assert got[0] == want
    assert timing._COUNTS["write:format-ahead"] >= -(-rows // CHUNK)


def test_the_cli_exits_0_when_its_reader_closes_the_pipe(tmp_path):
    a, _ = cli_fastas(tmp_path)
    script = (
        "import sys\n"
        "from distance_tpu_torch import cli, ringwrite, writer\n"
        f"writer._FORMAT_CHUNK_ROWS = {CHUNK}\n"
        "ring = ringwrite._ring\n"
        "def spy(*args):\n"
        "    sys.stderr.write('ring\\n'); sys.stderr.flush()\n"
        "    return ring(*args)\n"
        "ringwrite._ring = spy\n"
        f"sys.exit(cli.main([{str(a)!r}, '-m', 'raw', '--backend',"
        " 'torch']))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.Popen([sys.executable, "-c", script], cwd=str(ROOT),
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE)
    head = p.stdout.read(1000)
    p.stdout.close()
    err = p.stderr.read()
    assert p.wait(timeout=300) == 0
    assert head.startswith(writer.HEADER)
    assert b"ring" in err and b"Traceback" not in err
