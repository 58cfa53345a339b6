"""The port's copies of the JAX package's host code stay identical to it.

``distance_tpu_torch`` cannot import ``distance_tpu``: every submodule of
it loads jax through ``distance_tpu/__init__.py``.  So the port carries
copies of the JAX-free host modules and helpers; these tests pin them to
their originals, with the import prefix (and the path prefix of citations
of the Rust reference's sources) the only allowed difference besides the
repairs listed in ``SANCTIONED``, and check that the port runs with jax
unimportable.
"""

import ast
import inspect
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distance_tpu.engine as jax_engine  # noqa: E402
import distance_tpu.ops.diffup as jax_diffup  # noqa: E402
import distance_tpu.ops.packing as jax_packing  # noqa: E402
import distance_tpu.parallel.multihost as jax_multihost  # noqa: E402
import distance_tpu_torch.emit as port_emit  # noqa: E402
import distance_tpu_torch.engine as port_engine  # noqa: E402
import distance_tpu_torch.ops.diffup as port_diffup  # noqa: E402
import distance_tpu_torch.ops.packing as port_packing  # noqa: E402
import distance_tpu_torch.parallel.multihost as port_multihost  # noqa: E402
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
from tests.conftest import make_fasta, oracle_tsv, random_seqs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

COPIED_FILES = [
    "encoding.py",
    "measures.py",
    "_native/__init__.py",
    "_native/native.c",
    "utils/__init__.py",
    "utils/timing.py",
    "fastaio.py",
    "finalize.py",
    "writer.py",
    "progress.py",
    "ops/features.py",
]

EMIT_HELPERS = [
    "_emit_pairs", "_lin3_native", "_minmax_native", "_value_keys",
    "_tn93_value_keys", "_tri_indices", "_ScratchPool", "_gather_emit",
    "_gather_strip_triangle", "_prune_invariant_columns",
]

ENGINE_HELPERS = [
    "_input_fingerprint", "_resume_skip", "_progress_mark",
    "_pipeline_strips", "_AsyncEmitter", "_split_strips",
    "_strip_ram_budget", "_cap_tile_ram", "_pow2_at_least",
    "_StreamSplit", "_transpose_add", "_threaded_iter", "_unpack_rel_parts",
    "_rel4_finish_native",
]

DIFFUP_HELPERS = ["_get_pool", "_row_chunks", "_round_cap",
                  "sampled_mode_row"]

MULTIHOST_HELPERS = [
    "_merge_stream", "_check_no_stdin", "MultihostCtx", "_run_fingerprint",
    "_read_marker", "_merge_when_ready",
]

# Repairs the port makes to copied functions: name -> [(original text,
# port's text)].  The port's stream groups follow the memory of the card
# and host unless sharded, so the .units sidecar records a shard's group
# size, and merge_parts refuses parts cut into groups of different sizes
# rather than interleave them.
SANCTIONED_FUNCTIONS = {
    "UnitIndex": [
        ('''        self.units: List[List[int]] = []  # [global_ordinal, nbytes]
''', '''        self.units: List[List[int]] = []  # [global_ordinal, nbytes]
        # records per stream group: every shard must cut the stream into
        # the same groups for the ordinals to interleave
        self.group: Optional[int] = None
'''),
        ('''            self.units = [[int(a), int(b)] for a, b in d["units"]]
''', '''            self.units = [[int(a), int(b)] for a, b in d["units"]]
            self.group = d.get("group")
'''),
        ('''            json.dump({"preamble": self.preamble, "units": self.units}, f)
''', '''            json.dump({"preamble": self.preamble, "units": self.units,
                       "group": self.group}, f)
'''),
    ],
    "merge_parts": [
        ('''    if part_paths and all(ix.load() for ix in indexes):
''', '''    if part_paths and all(ix.load() for ix in indexes):
        if len({ix.group for ix in indexes}) > 1:
            raise DistanceError(
                "cannot merge stream parts cut into groups of different"
                " sizes (" + ", ".join(
                    f"{p}: {ix.group}" for p, ix in zip(part_paths, indexes)
                ) + ")"
            )
'''),
    ],
}

# Repairs the port makes to copied engine helpers: name -> [(original
# text, port's text)].  The ordered emitter's thread is named, and its
# waits are phases: the sweep blocked on a full queue, the job's tail
# waiting for the last writes, the emitter starved of work.
SANCTIONED_HELPERS = {
    "_AsyncEmitter": [
        ('''        self._thread = threading.Thread(target=self._run, daemon=True)
''', '''        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="emitter")
'''),
        ('''            fn = self._q.get()
''', '''            with phase_timer("emit-idle"):
                fn = self._q.get()
'''),
        ('''        self._q.put(fn)
''', '''        with phase_timer("emit-submit-wait"):
            self._q.put(fn)
'''),
        ('''        self._q.put(None)
        self._done.wait()
        self._thread.join()
''', '''        with phase_timer("emit-drain"):
            self._q.put(None)
            self._done.wait()
            self._thread.join()
'''),
    ],
}

# Repairs the port makes to copied emission helpers: name -> [(original
# text, port's text)].  The tn93 memo's bail-outs add a total of their
# own, so that a run can see how often and how long the memo gave up.
SANCTIONED_EMIT = {
    "_tn93_value_keys": [
        ("""    budget, at a bounded partial-pass cost.
""", """    budget, at a bounded partial-pass cost.  Each bail-out (there, or
    before it where the spread is too wide for the hash path) adds one
    to the total ``keys-bail``, with the call's seconds up to it.
"""),
        ("""    if not n:
        return None, 0
""", """    if not n:
        return None, 0
    t0 = time.perf_counter()
"""),
        ("""        # where the memo would not pay anyway.
        return None, 0
""", """        # where the memo would not pay anyway.
        timing.add("keys-bail", time.perf_counter() - t0, 1)
        return None, 0
"""),
        ("""        if any(r < 0 for r in [f.result() for f in futs]):
            return None, 0
""", """        if any(r < 0 for r in [f.result() for f in futs]):
            timing.add("keys-bail", time.perf_counter() - t0, 1)
            return None, 0
"""),
    ],
}

# Repairs the port makes to a copy: file -> [(original text, port's
# text)].  fastaio._assemble_rows took `off % width` at width 0
# (ZeroDivisionError in the native stream path); the port returns the
# empty rows first, as the pure-Python stream path does.  Its run
# detection took any 1-D view starting on a row of the piece matrix for
# that whole row; the port also asks for a full, unit-stride row.  And
# _read_pieces yields (piece, records), not bytes.  The phase timers
# also keep spans (start, end, thread, parent, job) when asked to, and
# the writer's unkeyed formatting is a phase of its own.  The writer's
# keyed rows go to ``ringwrite`` when it writes its own output.
SANCTIONED = {
    "fastaio.py": [
        ("""    if n == 0:
        return np.zeros((0, width), np.uint8)
""", """    if n == 0 or width == 0:
        # width 0: the rows hold no codes (and `off % width` would divide
        # by zero)
        return np.zeros((n, width), np.uint8)
"""),
        ("""            and base.shape[1] == width
            and r.ndim == 1
        ):
""", """            and base.shape[1] == width
            and r.ndim == 1
            # a full unit-stride row: a shorter or strided view of the
            # base would be copied as the whole row it starts
            and r.size == width
            and r.strides == (1,)
        ):
"""),
        ("""                    and rows[j].__array_interface__["data"][0] == nxt
                ):
""", """                    and rows[j].__array_interface__["data"][0] == nxt
                    and rows[j].size == width
                    and rows[j].strides == (1,)
                ):
"""),
        ("def _read_pieces(handle: BinaryIO, batch_rows: int = 0)"
         " -> Iterator[bytes]:\n"
         '    """Pieces of the stream, each cut at a record boundary so every\n'
         "    piece holds whole records.\n",
         "def _read_pieces(handle: BinaryIO,\n"
         "                 batch_rows: int = 0) -> Iterator[Tuple[bytes, int]]:\n"
         '    """Pieces of the stream, each cut at a record boundary so every\n'
         "    piece holds whole records, with the number of records each"
         " holds.\n"),
    ],
    "utils/timing.py": [
        ('''phase occurrences).
"""
''', '''phase occurrences).

``record_spans(True)`` also keeps each phase as a ``Span`` (start, end,
thread, parent, job) until ``take_spans()`` hands them over; ``job()``
numbers the jobs of a process and opens each one's root span.
"""
'''),
        ('''import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator
''', '''import contextlib
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional
'''),
        ('''_COUNTS: Dict[str, int] = defaultdict(int)
''', '''_COUNTS: Dict[str, int] = defaultdict(int)


class Span(NamedTuple):
    """One phase as it ran: ``t0`` and ``t1`` on ``time.perf_counter()``'s
    clock; ``parent`` the ``id`` of the innermost span open on the same
    thread, or for a thread's outermost span the root of the job it ran
    in; ``job`` that job's ordinal (None outside a job)."""

    id: int
    name: str
    thread: str
    t0: float
    t1: float
    parent: Optional[int]
    job: Optional[int]


_recording = False
_spans: List[Span] = []
_span_ids = itertools.count()
_job_ids = itertools.count()
_job: Optional[int] = None  # the open job's ordinal
_root: Optional[int] = None  # the open job's root span
_open = threading.local()  # .ids: the thread's open, recorded spans
'''),
        ('''def phase_timer(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
''', '''def phase_timer(name: str) -> Iterator[None]:
    span = _enter() if _recording else None
    t0 = time.perf_counter()
'''),
        ('''        _COUNTS[name] += 1
        if enabled():
''', '''        _COUNTS[name] += 1
        if span is not None:
            _leave(span, name, t0, t0 + dt)
        if enabled():
'''),
        ('''

def totals() -> Dict[str, float]:
''', '''

def _enter() -> tuple:
    """A recorded span opens: (id, parent, job), its id pushed on the
    thread's stack."""
    ids = getattr(_open, "ids", None)
    if ids is None:
        ids = _open.ids = []
    sid = next(_span_ids)
    span = (sid, ids[-1] if ids else _root, _job)
    ids.append(sid)
    return span


def _leave(span: tuple, name: str, t0: float, t1: float) -> None:
    sid, parent, job = span
    _open.ids.remove(sid)
    _spans.append(Span(sid, name, threading.current_thread().name, t0, t1,
                       parent, job))


def totals() -> Dict[str, float]:
'''),
        ('''    _TOTALS.clear()
    _COUNTS.clear()
''', '''    _TOTALS.clear()
    _COUNTS.clear()


def record_spans(on: bool = True) -> None:
    """Keep a ``Span`` of every phase that opens from now on (``on``), or
    of none (off, the default); ``take_spans()`` hands them over."""
    global _recording
    _recording = bool(on)


def take_spans() -> List[Span]:
    """The spans kept since the last call, in the order they closed."""
    global _spans
    spans, _spans = _spans, []
    return spans


def recording() -> bool:
    """Whether phases are kept as spans (``record_spans``)."""
    return _recording


def add(name: str, seconds: float, count: int) -> None:
    """Adds ``count`` occurrences of phase ``name``, ``seconds`` in all,
    timed by the caller, to the totals: a phase too short and frequent
    for a timer each.  It keeps no span."""
    _TOTALS[name] += seconds
    _COUNTS[name] += count


@contextlib.contextmanager
def job() -> Iterator[int]:
    """One job of the process: the next ordinal, which every span that
    opens until the job ends carries, and, while spans are recorded, the
    job's root span ``job``, the parent of each other thread's outermost
    spans.  The root is no phase: it adds no total."""
    global _job, _root
    outer = _job, _root
    _job = next(_job_ids)
    span = _enter() if _recording else None
    _root = None if span is None else span[0]
    t0 = time.perf_counter()
    try:
        yield _job
    finally:
        if span is not None:
            _leave(span, "job", t0, time.perf_counter())
        _job, _root = outer
'''),
    ],
    "writer.py": [
        ('''                table = _value_table(values, keys, keyspace, lib, sink)
            with phase_timer("write:assemble"):
''', '''                table = _value_table(values, keys, keyspace, lib, sink)
            if sink is not None:
                # into the writer's output: its mmap window, or chunk by
                # chunk from a ring while the pool formats the next ones
                from distance_tpu_torch.ringwrite import write_keyed

                return write_keyed(lib, id_args, off1, off2, pair_i,
                                   pair_j, table, n, sink)
            with phase_timer("write:assemble"):
'''),
        ('''        starts = list(range(0, n, _FORMAT_CHUNK_ROWS))
        if len(starts) > 1:
            out = list(_format_pool().map(chunk, starts))
        else:
            out = [chunk(starts[0])]
''', '''        from distance_tpu_torch.utils.timing import phase_timer

        starts = list(range(0, n, _FORMAT_CHUNK_ROWS))
        with phase_timer("write:format"):
            if len(starts) > 1:
                out = list(_format_pool().map(chunk, starts))
            else:
                out = [chunk(starts[0])]
'''),
    ],
}

# The diff uploader's host half, copied; its __init__ takes the port's
# torch device where the JAX one takes a mesh flag.
DIFFUP_METHODS = ["encode", "_rejects", "_with_tail", "_encode_native"]
DIFFUP_INIT = [
    ("    def __init__(self, ref_padded: np.ndarray, sharded: bool = False):\n",
     "    def __init__(self, ref_padded: np.ndarray, device: torch.device):\n"),
    ("        self.sharded = bool(sharded)\n", "        self.device = device\n"),
]

PACKING_HELPERS = ["unpack_host", "unpack_host_narrow", "unpack_host_rel",
                   "unpack_rel4_nibbles", "finish_host_rel4",
                   "unbundle_sidecars"]
PACKING_CONSTANTS = ["PACK_LIMIT", "NARROW_SAT", "REL_SAT", "REL4_SAT",
                     "REL4_SEGMENTS", "REL4_EXC_CAP", "SIDECAR_MAGIC", "_HDR"]

# Methods of the JAX _BlockEngine that the port's carries verbatim (its
# pack_mode is the JAX one without the numpy backend and the mesh check).
ENGINE_METHODS = ["note_narrow", "note_rel", "note_rel4", "_rel_usable"]


def ported(text: str) -> str:
    """The original's text as the port carries it: the import prefix, and
    citations of the Rust reference's sources without the absolute path
    they were written with."""
    text = re.sub(r"\bdistance_tpu\b", "distance_tpu_torch", text)
    return text.replace("/root/reference/", "reference/")


@pytest.mark.parametrize("rel", COPIED_FILES)
def test_copied_file_is_verbatim(rel):
    want = ported((ROOT / "distance_tpu" / rel).read_text())
    for old, new in SANCTIONED.get(rel, []):
        assert want.count(old) == 1
        want = want.replace(old, new)
    assert (ROOT / "distance_tpu_torch" / rel).read_text() == want


@pytest.mark.parametrize("name", EMIT_HELPERS)
def test_emit_helper_is_verbatim(name):
    want = ported(inspect.getsource(getattr(jax_engine, name)))
    for old, new in SANCTIONED_EMIT.get(name, []):
        assert want.count(old) == 1
        want = want.replace(old, new)
    assert inspect.getsource(getattr(port_emit, name)) == want


@pytest.mark.parametrize("name", ["_KEYSPACE_CAP", "PRUNE_MIN_FRACTION"])
def test_emit_constant_is_verbatim(name):
    assert getattr(port_emit, name) == getattr(jax_engine, name)


@pytest.mark.parametrize("name", ENGINE_HELPERS)
def test_engine_helper_is_verbatim(name):
    want = ported(inspect.getsource(getattr(jax_engine, name)))
    for old, new in SANCTIONED_HELPERS.get(name, []):
        assert want.count(old) == 1
        want = want.replace(old, new)
    assert inspect.getsource(getattr(port_engine, name)) == want


@pytest.mark.parametrize("name", DIFFUP_HELPERS)
def test_diffup_helper_is_verbatim(name):
    want = ported(inspect.getsource(getattr(jax_diffup, name)))
    assert inspect.getsource(getattr(port_diffup, name)) == want


@pytest.mark.parametrize("name", ["_MIN_CAP", "_MIN_WIN"])
def test_diffup_constant_is_verbatim(name):
    assert getattr(port_diffup, name) == getattr(jax_diffup, name)


@pytest.mark.parametrize("name", DIFFUP_METHODS + ["__init__"])
def test_diff_uploader_host_half_is_verbatim(name):
    want = ported(inspect.getsource(getattr(jax_diffup.DiffUploader, name)))
    for old, new in DIFFUP_INIT if name == "__init__" else []:
        assert want.count(old) == 1
        want = want.replace(old, new)
    assert inspect.getsource(getattr(port_diffup.DiffUploader, name)) == want


@pytest.mark.parametrize("name", PACKING_HELPERS)
def test_packing_host_half_is_verbatim(name):
    want = ported(inspect.getsource(getattr(jax_packing, name)))
    assert inspect.getsource(getattr(port_packing, name)) == want


@pytest.mark.parametrize("name", PACKING_CONSTANTS)
def test_packing_constant_is_verbatim(name):
    assert getattr(port_packing, name) == getattr(jax_packing, name)


@pytest.mark.parametrize("name", ENGINE_METHODS)
def test_engine_method_is_verbatim(name):
    def source(cls):
        attr = inspect.getattr_static(cls, name)
        return inspect.getsource(getattr(attr, "fget", attr))

    assert source(port_engine._BlockEngine) == source(jax_engine._BlockEngine)


def test_assemble_rows_copies_a_strided_row_as_itself():
    """A 1-D view that starts on a row of a piece matrix but is not that
    whole row (here every other byte of two rows) is copied as it is,
    not taken for the row it starts (the JAX copy's latent fault)."""
    from distance_tpu_torch import fastaio

    base = np.empty((4, 16), dtype=np.uint8)  # owns its memory
    base[:] = np.arange(4 * 16).reshape(4, 16)
    strided = base.reshape(-1)[16:48:2]
    assert strided.base is base and strided.size == 16
    out = fastaio._assemble_rows([base[0], strided, base[3]], 16)
    np.testing.assert_array_equal(out, np.stack([base[0], strided, base[3]]))
    # full rows still assemble as one zero-copy run
    run = fastaio._assemble_rows([base[1], base[2]], 16)
    assert run.base is base
    np.testing.assert_array_equal(run, base[1:3])


def test_read_pieces_yields_pieces_with_their_record_counts():
    import io

    from distance_tpu_torch import fastaio

    assert (fastaio._read_pieces.__annotations__["return"]
            == "Iterator[Tuple[bytes, int]]")
    data = b">a\nAC\n>b\nGT\n>c\nTT\n"
    for batch_rows in (0, 1, 2):
        pieces = list(fastaio._read_pieces(io.BytesIO(data), batch_rows))
        assert [p.count(b">") for p, _ in pieces] == [n for _, n in pieces]
        assert b"".join(p for p, _ in pieces) == data


@pytest.mark.parametrize("name", MULTIHOST_HELPERS + list(SANCTIONED_FUNCTIONS))
def test_multihost_helper_is_verbatim(name):
    want = ported(inspect.getsource(getattr(jax_multihost, name)))
    for old, new in SANCTIONED_FUNCTIONS.get(name, []):
        assert want.count(old) == 1
        want = want.replace(old, new)
    assert inspect.getsource(getattr(port_multihost, name)) == want


@pytest.mark.parametrize("name",
                         ["MERGE_POLL_S", "MERGE_TIMEOUT_S", "MERGE_NOTE_S"])
def test_multihost_constant_is_verbatim(name):
    assert getattr(port_multihost, name) == getattr(jax_multihost, name)


def function_source(path: Path, name: str) -> str:
    """The source text of the top-level function ``name`` of ``path``,
    read with ast (importing the JAX fuzzer would set ``XLA_FLAGS``)."""
    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(text, node)


# Functions the port's scripts and modules copy from files outside the
# JAX package: (original file, copy, name).
COPIED_FUNCTIONS = [
    ("scripts/fuzz_differential.py", "scripts/fuzz_differential_torch.py",
     "one_config"),
    ("tests/conftest.py", "scripts/fuzz_differential_torch.py",
     "make_fasta"),
    ("tests/conftest.py", "scripts/fuzz_differential_torch.py",
     "random_seqs"),
    ("__graft_entry__.py", "distance_tpu_torch/dryrun.py", "_example_data"),
]


@pytest.mark.parametrize("original, copy, name", COPIED_FUNCTIONS,
                         ids=[c[2] for c in COPIED_FUNCTIONS])
def test_copied_function_is_verbatim(original, copy, name):
    assert function_source(ROOT / copy, name) == ported(
        function_source(ROOT / original, name))


@pytest.mark.parametrize("name", ["BASE_COUNT_DEVICE_MIN_BYTES",
                                  "H2D_CHUNK_BYTES"])
def test_base_count_constant_is_the_jax_engines(name):
    assert getattr(port_engine, name) == getattr(jax_engine, name)


@pytest.mark.parametrize("chunk", [2000, 32 << 20])
def test_count_bases_device_equals_jax(monkeypatch, chunk):
    """The port's ``_count_bases_device`` (on the CPU) and
    ``_count_bases_maybe_device`` give the JAX engine's tallies, chunked
    alike."""
    from distance_tpu.fastaio import Alignment as JaxAlignment
    from distance_tpu_torch.encoding import ALL_CODES
    from distance_tpu_torch.fastaio import Alignment

    mat = np.random.default_rng(chunk).choice(
        ALL_CODES, size=(41, 333)).astype(np.uint8)
    for mod in (jax_engine, port_engine):
        monkeypatch.setattr(mod, "H2D_CHUNK_BYTES", chunk)
        monkeypatch.setattr(mod, "BASE_COUNT_DEVICE_MIN_BYTES", 0)
    want = jax_engine._count_bases_device(mat)
    np.testing.assert_array_equal(
        port_engine._count_bases_device(mat, torch.device("cpu")), want)
    jax_aln = JaxAlignment(ids=[], descriptions=[], matrix=mat)
    jax_engine._count_bases_maybe_device(jax_aln, "xla")
    aln = Alignment(ids=[], descriptions=[], matrix=mat)
    port_engine._count_bases_maybe_device(aln, "torch")
    np.testing.assert_array_equal(aln.base_counts, jax_aln.base_counts)


# Runs each command line (separated by "::") through the port's CLI with
# jax unimportable, stopping at the first that fails.
_NO_JAX_RUN = """
import sys
sys.modules["jax"] = None
import distance_tpu_torch.cli
import distance_tpu_torch.engine
import distance_tpu_torch.ops.diffup
import distance_tpu_torch.ops.packing
import distance_tpu_torch.parallel.mesh
import distance_tpu_torch.dryrun
import distance_tpu_torch.ops.basecount
import distance_tpu_torch.ops.estimate
assert "distance_tpu" not in sys.modules
argv = sys.argv[1:]
while argv:
    cut = argv.index("::") if "::" in argv else len(argv)
    rc = distance_tpu_torch.cli.main(argv[:cut])
    if rc:
        sys.exit(rc)
    argv = argv[cut + 1:]
"""


@pytest.mark.parametrize(
    "mode", ["square", "rectangle", "stream", "launch", "stream-shard"])
@pytest.mark.parametrize("measure", ["raw", "tn93"])
def test_port_runs_without_jax(tmp_path, measure, mode):
    """With jax unimportable, the port imports and writes the oracle's
    TSV in each mode — as it must on a GPU host that has no jax.  Packages
    named jax and distance_tpu that refuse to import come first on the
    path, so that processes the port starts (``--launch`` workers) cannot
    import them either; ``stream-shard`` runs two stream shards of
    several groups and merges them."""
    from distance_tpu.fastaio import load_fasta

    rng = np.random.default_rng(7)
    fasta = tmp_path / "a.fasta"
    fasta.write_bytes(make_fasta(random_seqs(rng, 12, 90, amb_frac=0.3)))
    other = tmp_path / "b.fasta"
    # upper case only: the stream's tn93 tallies count upper-case bytes
    other.write_bytes(make_fasta(
        (f"t{i}", s.upper()) for i, (_, s) in enumerate(random_seqs(rng, 9, 90))
    ))
    shadow = tmp_path / "shadow"
    for name in ("jax", "distance_tpu"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not on a GPU host')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(shadow),
                                                       str(ROOT)]))
    out = tmp_path / "out.tsv"
    common = ["-m", measure, "--backend", "torch"]
    if mode == "stream-shard":
        # groups of 4 records (the -b 4 batches): 4, 4, 1
        g = len(get_plan(measure).counters)
        env["DISTANCE_TPU_STRIP_RAM"] = str(4 * (g + 2) * 12 * 4 * 4)
        parts = [str(tmp_path / f"p{k}") for k in range(2)]
        argv = []
        for k, part in enumerate(parts):
            argv += [str(fasta), "-s", str(other), "-b", "4", *common,
                     "--shard", f"{k}/2", "-o", part, "::"]
        argv += ["--merge", *parts, "-o", str(out)]
    else:
        extra = {"square": [], "rectangle": [str(other)],
                 "stream": ["-s", str(other), "-b", "4"],
                 "launch": ["--launch", "2"]}[mode]
        argv = [str(fasta), *extra, *common, "-o", str(out)]
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, *argv],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    if mode == "stream-shard":
        assert [len(json.loads(open(p + ".units").read())["units"])
                for p in parts] == [2, 1]
    alns = []
    for path in (fasta, other):
        with open(path, "rb") as f:
            alns.append(load_fasta(f))
        if measure == "tn93":
            alns[-1].count_bases()
    if mode in ("square", "launch"):
        want = oracle_tsv(measure, alns[0])
    else:
        want = oracle_tsv(measure, *alns, stream_ids=(
            alns[1].ids if mode.startswith("stream") else None))
    assert out.read_bytes() == want


@pytest.mark.parametrize("command", ["dryrun", "fuzzer"])
def test_dryrun_and_fuzzer_run_without_jax(tmp_path, command):
    """The dry run and the port's fuzzer import and pass on the CPU with
    jax and the JAX package unimportable."""
    shadow = tmp_path / "shadow"
    for name in ("jax", "distance_tpu"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not on a GPU host')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(shadow),
                                                       str(ROOT)]))
    argv = {"dryrun": ["-m", "distance_tpu_torch.dryrun", "--cpu",
                       "--devices", "2"],
            "fuzzer": [str(ROOT / "scripts" / "fuzz_differential_torch.py"),
                       "--backend", "torch", "--iters", "2"]}[command]
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert ("dryrun ok on 2 devices" if command == "dryrun"
            else "PASS: 2 random configs") in proc.stdout
