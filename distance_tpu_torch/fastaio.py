"""FASTA I/O: parse, validate, and pack alignments into uint8 code matrices.

TPU-native counterpart of the reference's record-oriented I/O layer
(reference/src/fastaio.rs).  Instead of a Vec of per-record byte
vectors, an alignment is packed into one contiguous ``(n_seqs, L)`` uint8
matrix ready for device upload; ids/descriptions stay host-side.

Error messages reproduce the reference verbatim
(reference/src/fastaio.rs:89-99).
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass
from typing import BinaryIO, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from distance_tpu_torch.encoding import ENCODING, A, G, C, T


def _count_bases_host(m: np.ndarray) -> np.ndarray:
    """(n, 4) int32 per-row counts of encoded A/T/G/C."""
    n = m.shape[0]
    if n and m.size and m.flags["C_CONTIGUOUS"]:
        from distance_tpu_torch._native import get_lib

        lib = get_lib()
        if lib is not None:
            import ctypes

            out = np.empty((n, 4), dtype=np.int32)
            codes = np.array([A, T, G, C], dtype=np.uint8)
            p_u8 = ctypes.POINTER(ctypes.c_uint8)
            p_i32 = ctypes.POINTER(ctypes.c_int32)

            def _chunk(r0: int, r1: int) -> None:
                lib.dt_count_bases(
                    m[r0:r1].ctypes.data_as(p_u8), r1 - r0, m.shape[1],
                    codes.ctypes.data_as(p_u8),
                    out[r0:r1].ctypes.data_as(p_i32),
                )

            workers = min(_os.cpu_count() or 1, max(1, n // 4096))
            if workers > 1:
                from concurrent.futures import ThreadPoolExecutor

                bounds = np.linspace(0, n, workers + 1, dtype=np.int64)
                with ThreadPoolExecutor(workers) as ex:
                    list(ex.map(
                        lambda se: _chunk(int(se[0]), int(se[1])),
                        zip(bounds[:-1], bounds[1:]),
                    ))
            else:
                _chunk(0, n)
            return out
    return np.stack(
        [
            (m == A).sum(axis=1),
            (m == T).sum(axis=1),
            (m == G).sum(axis=1),
            (m == C).sum(axis=1),
        ],
        axis=1,
    ).astype(np.int32)


class DistanceError(Exception):
    """Engine error carrying a user-facing message.

    Mirrors the reference's ``DistanceError::Message``
    (reference/src/lib.rs:21-39): the CLI prints the message wrapped
    Debug-style and exits 1.
    """


def _err_invalid_nuc(record_id: str, ch: str) -> str:
    # reference/src/fastaio.rs:89-91
    return f"Invalid nucleotide character in record '{record_id}': '{ch}'"


def _err_different_lengths(w1: int, w2: int) -> str:
    # reference/src/fastaio.rs:93-95
    return f"Different length sequences in alignment(s): {w1} vs {w2}"


def _err_empty_fasta() -> str:
    # reference/src/fastaio.rs:97-99
    return "Empty FASTA file"


# ---------------------------------------------------------------------------
# Raw FASTA parsing
# ---------------------------------------------------------------------------

def parse_fasta(handle: BinaryIO) -> Iterator[Tuple[str, str, bytes]]:
    """Yield ``(id, description, sequence_bytes)`` per record.

    Follows the same conventions as the reference's FASTA reader
    (rust-bio, reference/src/fastaio.rs:1-2): a record header is
    ``>`` followed by an id (first whitespace-delimited token) and an
    optional description; sequence lines are concatenated with only
    TRAILING whitespace trimmed (``trim_end`` semantics) — leading or
    embedded whitespace reaches the encoder and errors as an invalid
    nucleotide, exactly like the reference.
    """
    header: Optional[str] = None
    chunks: List[bytes] = []
    seen_any = False
    for raw in handle:
        line = raw.rstrip(b"\r\n")
        if line.startswith(b">"):
            if header is not None:
                yield _split_header(header) + (b"".join(chunks),)
            header = line[1:].decode("utf-8", errors="replace")
            chunks = []
            seen_any = True
        else:
            if not seen_any:
                if line.strip() == b"":
                    continue
                raise DistanceError("Expected '>' at FASTA record start")
            chunks.append(line.rstrip())
    if header is not None:
        yield _split_header(header) + (b"".join(chunks),)


def _split_header(header: str) -> Tuple[str, str]:
    parts = header.split(maxsplit=1)
    if not parts:
        return "", ""
    rid = parts[0]
    desc = parts[1] if len(parts) > 1 else ""
    return rid, desc


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def encode_seq(record_id: str, seq: bytes) -> np.ndarray:
    """Encode one sequence to Paradis codes, validating every byte.

    Invalid bytes raise with the reference's message, naming the first
    offending character in sequence order
    (reference/src/fastaio.rs:110-115).
    """
    arr = np.frombuffer(seq, dtype=np.uint8)
    codes = ENCODING[arr]
    if arr.size and not codes.all():
        bad = int(np.argmax(codes == 0))
        raise DistanceError(_err_invalid_nuc(record_id, chr(arr[bad])))
    return codes


@dataclass
class Alignment:
    """One loaded FASTA alignment, packed for device upload.

    Fields mirror the reference's per-record state
    (reference/src/fastaio.rs:13-24) hoisted to matrix form:
    ``base_counts`` is the tn93 per-record ATGC tally.  (The reference's
    per-record consensus-difference lists, fastaio.rs:67-75, exist to
    sparsify measure ``n``; the engine's invariant-column pruning is the
    matrix-form generalization, so no per-record lists are kept.)
    """

    ids: List[str]
    descriptions: List[str]
    matrix: np.ndarray  # (n_seqs, L) uint8
    base_counts: Optional[np.ndarray] = None  # (n_seqs, 4) int32: A,T,G,C

    @property
    def n(self) -> int:
        return self.matrix.shape[0]

    @property
    def width(self) -> int:
        return self.matrix.shape[1]

    def count_bases(self) -> np.ndarray:
        """Per-record counts of encoded A/T/G/C (case-insensitive by
        construction), as used by the loaded-path tn93
        (reference/src/fastaio.rs:53-66).

        One GIL-released native pass (threaded over row chunks) when the
        library is available — the numpy spelling allocates four
        full-matrix boolean temporaries and measured ~120 MB/s on this
        host vs multi-GB/s for the single C pass."""
        m = self.matrix
        self.base_counts = _count_bases_host(m)
        return self.base_counts

    def tally_ranks(self):
        """Dense ranks over DISTINCT ``base_counts`` rows, cached.

        (rank int32 (n,), n_distinct) — the tn93 keyed-memo side key:
        equal ranks imply identical (A,T,G,C) tally rows, hence (with
        equal counters) bit-identical tn93 values."""
        ranks = getattr(self, "_tally_ranks", None)
        if ranks is None:
            uniq, inv = np.unique(
                self.base_counts, axis=0, return_inverse=True
            )
            ranks = (
                np.ascontiguousarray(inv.reshape(-1), dtype=np.int32),
                int(uniq.shape[0]),
            )
            self._tally_ranks = ranks
        return ranks


# Files above this size parse through the native C path when available.
NATIVE_PARSE_MIN_BYTES = 1 << 20


def load_fasta(handle: BinaryIO) -> Alignment:
    """Read a whole FASTA stream into an Alignment.

    Enforces equal widths within the file and rejects empty files
    (reference/src/fastaio.rs:174-200).  Large inputs go through
    the native C parser+encoder (the reference's parse path is native
    Rust); both paths produce identical Alignments and error messages.
    """
    data = handle.read()
    if len(data) >= NATIVE_PARSE_MIN_BYTES:
        aln = _load_fasta_native(data)
        if aln is not None:
            return aln
    return _load_fasta_python(data)


def _load_fasta_python(data: bytes) -> Alignment:
    import io as _io

    ids: List[str] = []
    descs: List[str] = []
    rows: List[np.ndarray] = []
    width: Optional[int] = None
    for rid, desc, seq in parse_fasta(_io.BytesIO(data)):
        codes = encode_seq(rid, seq)
        if width is None:
            width = codes.size
        elif codes.size != width:
            raise DistanceError(_err_different_lengths(codes.size, width))
        ids.append(rid)
        descs.append(desc)
        rows.append(codes)
    if not rows:
        raise DistanceError(_err_empty_fasta())
    matrix = np.vstack(rows) if width else np.zeros((len(rows), 0), np.uint8)
    return Alignment(ids=ids, descriptions=descs, matrix=matrix)


def _first_record_width(data: bytes) -> Optional[int]:
    """Length of the first record's sequence (Python-trimmed semantics)."""
    start = data.find(b">")
    if start < 0:
        return None
    eol = data.find(b"\n", start)
    if eol < 0:
        return 0
    nxt = data.find(b"\n>", eol)
    block = data[eol + 1 : None if nxt < 0 else nxt + 1]
    return sum(len(line.rstrip()) for line in block.split(b"\n"))


def _load_fasta_native(data: bytes) -> Optional[Alignment]:
    """C fast path; returns None if the native library is unavailable."""
    from distance_tpu_torch._native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    # cheap upper bound on record count ('>' anywhere).  Checked BEFORE
    # the width probe: with no '>' at all the probe returns None too,
    # and raising Empty FASTA here would shadow the Python path's
    # precise "Expected '>' at FASTA record start" for junk input
    # (the error must not depend on file size / native availability)
    max_records = data.count(b">")
    if max_records == 0:
        # junk or whitespace only — let the Python path raise precisely
        return _load_fasta_python(data)
    width = _first_record_width(data)
    if width is None:
        raise DistanceError(_err_empty_fasta())
    arr = np.frombuffer(data, dtype=np.uint8)

    # np.empty: every reported record's row is fully written (col==width
    # enforced) and error paths discard the matrix
    matrix = np.empty((max_records, width), dtype=np.uint8)
    # header blobs are tiny relative to sequence data; if a pathological
    # input overflows these, rc=4 falls back to the Python path
    ids_cap = min(len(data), max(4096, max_records * 128))
    ids_buf = ctypes.create_string_buffer(ids_cap)
    descs_buf = ctypes.create_string_buffer(ids_cap)
    id_offs = np.zeros(max_records + 1, dtype=np.int64)
    desc_offs = np.zeros(max_records + 1, dtype=np.int64)
    n_out = np.zeros(1, dtype=np.int64)
    err_a = np.zeros(1, dtype=np.int64)
    err_b = np.zeros(1, dtype=np.int64)

    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    rc = lib.dt_parse_fasta_fill(
        arr.ctypes.data_as(p_u8), len(data), width, max_records,
        ENCODING.ctypes.data_as(p_u8),
        matrix.ctypes.data_as(p_u8),
        ids_buf, ids_cap, id_offs.ctypes.data_as(p_i64),
        descs_buf, ids_cap, desc_offs.ctypes.data_as(p_i64),
        n_out.ctypes.data_as(p_i64),
        err_a.ctypes.data_as(p_i64), err_b.ctypes.data_as(p_i64),
        None,
    )

    def rec_id(k: int) -> str:
        # note: .raw copies the whole buffer — take one bytes snapshot
        blob = ctypes.string_at(ids_buf, int(id_offs[min(k + 1, max_records)]))
        return blob[id_offs[k] : id_offs[k + 1]].decode(
            "utf-8", errors="replace"
        )

    if rc == 1:
        raise DistanceError(
            _err_invalid_nuc(rec_id(int(err_a[0])), chr(int(err_b[0])))
        )
    if rc == 2:
        raise DistanceError(
            _err_different_lengths(int(err_b[0]), width)
        )
    if rc == 3:
        raise DistanceError("Expected '>' at FASTA record start")
    if rc != 0:
        # capacity problems shouldn't happen (buffers sized from input);
        # fall back rather than fail
        return _load_fasta_python(data)

    n = int(n_out[0])
    if n == 0:
        raise DistanceError(_err_empty_fasta())
    id_blob = ctypes.string_at(ids_buf, int(id_offs[n]))
    desc_blob = ctypes.string_at(descs_buf, int(desc_offs[n]))
    ids = [
        id_blob[id_offs[k] : id_offs[k + 1]].decode("utf-8", errors="replace")
        for k in range(n)
    ]
    descs = [
        desc_blob[desc_offs[k] : desc_offs[k + 1]].decode(
            "utf-8", errors="replace"
        )
        for k in range(n)
    ]
    return Alignment(ids=ids, descriptions=descs, matrix=matrix[:n])


def load_fastas(handles: Sequence[BinaryIO]) -> List[Alignment]:
    """Load one or two alignments, checking widths across files
    (reference/src/fastaio.rs:202-212)."""
    loaded: List[Alignment] = []
    for counter, handle in enumerate(handles):
        loaded.append(load_fasta(handle))
        if counter == 1 and loaded[0].width != loaded[1].width:
            raise DistanceError(
                _err_different_lengths(loaded[0].width, loaded[1].width)
            )
    return loaded


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------

@dataclass
class StreamBatch:
    """A batch of streamed records (analog of ``Records``,
    reference/src/fastaio.rs:83-87)."""

    ids: List[str]
    matrix: np.ndarray  # (batch, L) uint8
    base_counts: Optional[np.ndarray]  # (batch, 4) int32 A,T,G,C or None
    idx: int


def _tally_atgc(seq: bytes) -> np.ndarray:
    """Raw upper-case-only (A, T, G, C) byte counts — the reference's
    streamed tn93 precompute quirk (its streamed encoder tallies chars,
    not codes, reference/src/fastaio.rs:124-142).  The native
    parser computes the same tally in C (dt_parse_fasta_fill); this is
    the Python-path twin."""
    raw = np.frombuffer(seq, dtype=np.uint8)
    return np.array(
        [int((raw == ord(c)).sum()) for c in "ATGC"], dtype=np.int64
    )


def stream_fasta(
    handle: BinaryIO,
    width: int,
    measure: str,
    consensus_seq: Optional[np.ndarray],
    batchsize: int,
) -> Iterator[StreamBatch]:
    """Incrementally read, validate, and encode records in batches.

    Mirrors reference/src/fastaio.rs:215-286:

    * every record's width is checked against the loaded alignment;
    * measure ``tn93`` tallies raw upper-case 'A','T','G','C' bytes only
      (the reference's streamed-path quirk, fastaio.rs:124-142 — the loaded
      path counts encoded codes and therefore accepts lower case);
    * measure ``n`` requires a consensus built from the loaded alignment.
    * an empty stream is an error, raised after the end of iteration.
    """
    if measure == "n" and consensus_seq is None:
        # reference/src/fastaio.rs:233-240
        raise DistanceError(
            "Expected a consensus sequence to be generated when the distance"
            " measure is n"
        )

    if not _os.environ.get("DISTANCE_TPU_NO_NATIVE"):
        # GIL-releasing chunked C parse+encode; for tn93 the parser also
        # tallies raw 'A','T','G','C' bytes per record (upper-case only —
        # the reference's streamed-path quirk, fastaio.rs:124-142)
        from distance_tpu_torch._native import get_lib

        if get_lib() is not None:
            yield from _stream_fasta_batches(
                _stream_records_native(
                    handle, width, want_tallies=(measure == "tn93"),
                    batch_rows=batchsize,
                ),
                width, batchsize,
            )
            return

    ids: List[str] = []
    rows: List[np.ndarray] = []
    counts: List[np.ndarray] = []
    idx_counter = 0
    record_counter = 0

    def make_batch(i: int) -> StreamBatch:
        return StreamBatch(
            ids=list(ids),
            matrix=np.vstack(rows) if rows else np.zeros((0, width), np.uint8),
            base_counts=np.vstack(counts).astype(np.int32) if counts else None,
            idx=i,
        )

    for rid, _desc, seq in parse_fasta(handle):
        record_counter += 1
        if len(seq) != width:
            raise DistanceError(_err_different_lengths(len(seq), width))
        codes = encode_seq(rid, seq)
        ids.append(rid)
        rows.append(codes)
        if measure == "tn93":
            counts.append(_tally_atgc(seq))
        if len(ids) == batchsize:
            yield make_batch(idx_counter)
            idx_counter += 1
            ids, rows, counts = [], [], []

    if ids:
        yield make_batch(idx_counter)

    if record_counter == 0:
        raise DistanceError(_err_empty_fasta())


# Stream read granularity for the native chunked parser.
STREAM_READ_BYTES = int(
    _os.environ.get("DISTANCE_TPU_STREAM_READ", 8 << 20)
)


def _assemble_rows(rows: List[np.ndarray], width: int) -> np.ndarray:
    """Batch matrix from per-record rows, exploiting that native-parse
    rows are consecutive views into one C-contiguous piece matrix: runs
    copy as single slices, and a batch that is exactly one run returns a
    zero-copy view (safe: batch matrices are read-only downstream — the
    engine copies them into its padded upload buffer).  Replaces the
    per-row np.vstack that was ~half the stream-parse pipeline's time."""
    n = len(rows)
    if n == 0:
        return np.zeros((0, width), np.uint8)
    runs: List[tuple] = []  # (base, i0, count) | (None, rows-index, 1)
    k = 0
    while k < n:
        r = rows[k]
        base = r.base
        if (
            isinstance(base, np.ndarray)
            and base.ndim == 2
            and base.dtype == np.uint8
            and base.flags.c_contiguous
            and base.shape[1] == width
            and r.ndim == 1
        ):
            p0 = r.__array_interface__["data"][0]
            b0 = base.__array_interface__["data"][0]
            off = p0 - b0
            if off % width == 0:
                i0 = off // width
                j = k + 1
                nxt = p0 + width
                while (
                    j < n
                    and rows[j].base is base
                    and rows[j].__array_interface__["data"][0] == nxt
                ):
                    j += 1
                    nxt += width
                runs.append((base, i0, j - k))
                k = j
                continue
        runs.append((None, k, 1))
        k += 1
    if len(runs) == 1 and runs[0][0] is not None:
        base, i0, cnt = runs[0]
        return base[i0:i0 + cnt]
    out = np.empty((n, width), np.uint8)
    w = 0
    for base, a, cnt in runs:
        if base is None:
            out[w] = rows[a]
            w += 1
        else:
            out[w:w + cnt] = base[a:a + cnt]
            w += cnt
    return out


def _stream_fasta_batches(
    records: Iterator[tuple], width: int, batchsize: int
) -> Iterator[StreamBatch]:
    """Group an (id, encoded-row[, tally]) iterator into StreamBatch
    messages at the user's ``-b`` granularity."""
    ids: List[str] = []
    rows: List[np.ndarray] = []
    counts: List[np.ndarray] = []
    idx_counter = 0
    record_counter = 0

    def flush(i: int) -> StreamBatch:
        return StreamBatch(
            ids=list(ids),
            matrix=_assemble_rows(rows, width),
            base_counts=(
                np.vstack(counts).astype(np.int32) if counts else None
            ),
            idx=i,
        )

    for rec in records:
        rid, codes = rec[0], rec[1]
        record_counter += 1
        ids.append(rid)
        rows.append(codes)
        if len(rec) > 2 and rec[2] is not None:
            counts.append(rec[2])
        if len(ids) == batchsize:
            yield flush(idx_counter)
            idx_counter += 1
            ids, rows, counts = [], [], []
    if ids:
        yield flush(idx_counter)
    if record_counter == 0:
        raise DistanceError(_err_empty_fasta())


# Concurrent native parse workers for the streamed path.  The C pass
# releases the GIL, so pieces parse in true parallel; records still
# yield strictly in stream order.  1 = serial (the old behavior).
def _stream_parse_workers() -> int:
    env = _os.environ.get("DISTANCE_TPU_STREAM_PARSE_WORKERS")
    if env:
        return max(1, int(env))
    return max(1, min(4, (_os.cpu_count() or 1) - 1))


# Hard cap on one piece's size while waiting for a batch-aligned record
# count; past it the cut falls back to the last record boundary.
STREAM_PIECE_CAP = int(
    _os.environ.get("DISTANCE_TPU_STREAM_PIECE_CAP", 64 << 20)
)


def _read_pieces(handle: BinaryIO, batch_rows: int = 0) -> Iterator[bytes]:
    """Pieces of the stream, each cut at a record boundary so every
    piece holds whole records.

    With ``batch_rows == 0``: ~STREAM_READ_BYTES pieces cut at the last
    record boundary (legacy shape).  With ``batch_rows > 0``: each piece
    holds an exact MULTIPLE of ``batch_rows`` records whenever that
    multiple arrives under STREAM_PIECE_CAP — downstream StreamBatch
    matrices then assemble as zero-copy slices of one parsed piece
    (``_assemble_rows``) instead of paying a second full copy of the
    stream.  Record starts are counted as '>' at the piece head or after
    a newline, exactly the boundaries the legacy rfind(b"\\n>") cut
    used, so piece-content semantics (incl. leading-junk and mid-stream
    error replay) are unchanged — only the cut positions move."""
    carry: List[bytes] = []
    eof = False
    while not eof:
        parts: List[bytes] = []
        offs: List[int] = []   # global start offset of each part
        size = 0
        cuts: List[int] = []   # global offsets where a record starts
        prev_last = b""

        def absorb(chunk: bytes) -> None:
            nonlocal size, prev_last
            base = size
            if chunk[:1] == b">" and (base == 0 or prev_last == b"\n"):
                cuts.append(base)
            pos = chunk.find(b"\n>")
            while pos >= 0:
                cuts.append(base + pos + 1)
                pos = chunk.find(b"\n>", pos + 1)
            parts.append(chunk)
            offs.append(base)
            size = base + len(chunk)
            prev_last = chunk[-1:]

        for c in carry:
            absorb(c)
        carry = []
        cut_at = -1
        n_rec = 0
        while True:
            nstarts = len(cuts)
            if batch_rows > 0 and nstarts >= batch_rows + 1:
                m = ((nstarts - 1) // batch_rows) * batch_rows
                if m >= batch_rows:
                    cut_at = cuts[m]
                    n_rec = m
                    break
            threshold = (
                STREAM_PIECE_CAP if batch_rows > 0 else STREAM_READ_BYTES
            )
            if size >= threshold and cuts and cuts[-1] > 0:
                cut_at = cuts[-1]
                n_rec = len(cuts) - 1
                break
            chunk = handle.read(STREAM_READ_BYTES)
            if not chunk:
                eof = True
                n_rec = len(cuts)
                break
            absorb(chunk)
        if cut_at > 0:
            # assemble the piece with ONE join ending exactly at the
            # cut; the tail of the split part + later parts carry over
            # unjoined (rescanned next round — carry is small)
            k = len(parts) - 1
            while offs[k] > cut_at:
                k -= 1
            local = cut_at - offs[k]
            piece_parts = parts[:k]
            if local:
                piece_parts.append(parts[k][:local])
            carry = (
                ([parts[k][local:]] if local < len(parts[k]) else [])
                + parts[k + 1:]
            )
            data = b"".join(piece_parts)
        else:
            data = b"".join(parts)
        if data:
            yield data, n_rec


def _parse_piece(data: bytes, width: int, want_tallies: bool,
                 n_rec: int = -1) -> tuple:
    """One dt_parse_fasta_fill pass over a piece (GIL released; safe to
    run concurrently — the C pass writes only its own out-buffers).
    Returns ("ok", n, matrix, id_offs, id_blob, tallies), or
    ("py", data) when the piece needs the exact-semantics Python replay
    (no records, or any parse error — rc != 0 re-raises there with the
    reference's error text and ordering)."""
    import ctypes

    from distance_tpu_torch._native import get_lib

    lib = get_lib()
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    # the reader already counted record starts ('>' at piece head /
    # after '\n' — the parser's exact boundary rule); counting every
    # '>' byte again would re-scan the whole stream
    max_records = data.count(b">") if n_rec < 0 else n_rec
    if max_records == 0:
        return ("py", data)
    arr = np.frombuffer(data, dtype=np.uint8)
    # np.empty, not zeros/create_string_buffer: the parser fills every
    # byte it reports (id/desc blobs up to their offsets, matrix rows of
    # complete records), and zeroing three data-sized buffers per piece
    # costs more memory traffic than the parse itself
    matrix = np.empty((max_records, width), dtype=np.uint8)
    ids_cap = len(data) + 16
    ids_buf = np.empty(ids_cap, dtype=np.uint8)
    descs_buf = np.empty(ids_cap, dtype=np.uint8)
    id_offs = np.zeros(max_records + 1, dtype=np.int64)
    desc_offs = np.zeros(max_records + 1, dtype=np.int64)
    n_out = np.zeros(1, dtype=np.int64)
    err_a = np.zeros(1, dtype=np.int64)
    err_b = np.zeros(1, dtype=np.int64)
    tallies = (
        np.zeros((max_records, 4), dtype=np.int64)
        if want_tallies else None
    )
    rc = lib.dt_parse_fasta_fill(
        arr.ctypes.data_as(p_u8), len(data), width, max_records,
        ENCODING.ctypes.data_as(p_u8),
        matrix.ctypes.data_as(p_u8),
        ids_buf.ctypes.data_as(p_u8), ids_cap,
        id_offs.ctypes.data_as(p_i64),
        descs_buf.ctypes.data_as(p_u8), ids_cap,
        desc_offs.ctypes.data_as(p_i64),
        n_out.ctypes.data_as(p_i64),
        err_a.ctypes.data_as(p_i64), err_b.ctypes.data_as(p_i64),
        tallies.ctypes.data_as(p_i64) if tallies is not None else None,
    )
    if rc != 0:
        return ("py", data)
    n = int(n_out[0])
    id_blob = ids_buf[: int(id_offs[n])].tobytes()
    return ("ok", n, matrix, id_offs, id_blob, tallies)


def _emit_piece(parsed: tuple, width: int,
                want_tallies: bool) -> Iterator[tuple]:
    """Yield a parsed piece's records (or replay it in Python — exact
    error text/order for parse failures, fastaio.rs:246-254)."""
    if parsed[0] == "py":
        yield from _stream_records_python_piece(
            parsed[1], width, want_tallies
        )
        return
    _tag, n, matrix, id_offs, id_blob, tallies = parsed
    for k in range(n):
        rid = id_blob[id_offs[k]:id_offs[k + 1]].decode(
            "utf-8", errors="replace"
        )
        yield rid, matrix[k], (
            tallies[k] if tallies is not None else None
        )


def _stream_records_native(
    handle: BinaryIO, width: int, want_tallies: bool = False,
    batch_rows: int = 0,
) -> Iterator[tuple]:
    """Chunked C parse+encode of a streamed FASTA.

    Reads ~STREAM_READ_BYTES pieces cut at record boundaries and parses
    them with dt_parse_fasta_fill (GIL released) on a small thread pool
    — pieces parse in parallel while records yield strictly in stream
    order, so output bytes and mid-stream error semantics are identical
    to the serial path (a failing piece replays through the Python
    per-record path AT ITS ORDERED POSITION, after every earlier
    record has been yielded).  The 1M-seq design-point run spent
    324.5 s in stream-parse-wait on the serial path (BASELINE.md);
    the reference's analog is its dedicated reader thread
    (reference/src/lib.rs:288-306)."""
    workers = _stream_parse_workers()
    if workers <= 1:
        for data, n_rec in _read_pieces(handle, batch_rows):
            yield from _emit_piece(
                _parse_piece(data, width, want_tallies, n_rec), width,
                want_tallies,
            )
        return
    import collections
    from concurrent.futures import ThreadPoolExecutor

    pend = collections.deque()
    ex = ThreadPoolExecutor(workers)
    try:
        reader = _read_pieces(handle, batch_rows)
        while True:
            try:
                data, n_rec = next(reader)
            except StopIteration:
                break
            except Exception:
                # READER failure mid-stream (handle.read raised): every
                # piece fully read BEFORE it must still be yielded first
                # (serial-path semantics — the serial loop emits each
                # piece synchronously before the next read).  If a
                # drained piece itself holds a bad record, its ordered
                # DistanceError wins, as it would serially.  Only the
                # reader is guarded: an emit-side DistanceError must NOT
                # drain later pieces (records after the bad one are
                # never yielded on the serial path either).
                while pend:
                    yield from _emit_piece(
                        pend.popleft().result(), width, want_tallies
                    )
                raise
            pend.append(
                ex.submit(_parse_piece, data, width, want_tallies, n_rec)
            )
            # bounded lookahead: ~(workers + 2) pieces in flight
            while len(pend) > workers + 2:
                yield from _emit_piece(
                    pend.popleft().result(), width, want_tallies
                )
        while pend:
            yield from _emit_piece(
                pend.popleft().result(), width, want_tallies
            )
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def _stream_records_python_piece(
    data: bytes, width: int, want_tallies: bool = False
) -> Iterator[tuple]:
    import io as _io

    for rid, _desc, seq in parse_fasta(_io.BytesIO(data)):
        # streamed records check width BEFORE encoding (fastaio.rs:246-254)
        if len(seq) != width:
            raise DistanceError(_err_different_lengths(len(seq), width))
        tally = _tally_atgc(seq) if want_tallies else None
        yield rid, encode_seq(rid, seq), tally


# ---------------------------------------------------------------------------
# Consensus
# ---------------------------------------------------------------------------

def consensus(alignments: Iterable[Alignment]) -> np.ndarray:
    """Per-column ATGC-majority consensus over all loaded records.

    Reference semantics (reference/src/fastaio.rs:289-336): every
    non-ACGT code tallies as A; ties break by fixed priority A > G > C > T
    (strict ``>`` keeps the first maximum).  Returns an encoded pure-AGCT
    pseudo-sequence of shape (L,).
    """
    mats = [a.matrix for a in alignments]
    width = mats[0].shape[1]
    # Tally order [A, G, C, T]; unknown codes fall into bucket 0 (A).
    lookup = np.zeros(256, dtype=np.uint8)
    lookup[A] = 0
    lookup[G] = 1
    lookup[C] = 2
    lookup[T] = 3
    counts = np.zeros((4, width), dtype=np.int64)
    for m in mats:
        mapped = lookup[m]
        for b in range(4):
            counts[b] += (mapped == b).sum(axis=0)
    back_translate = np.array([A, G, C, T], dtype=np.uint8)
    # np.argmax returns the first maximum — matches the strict-> loop.
    return back_translate[np.argmax(counts, axis=0)]
