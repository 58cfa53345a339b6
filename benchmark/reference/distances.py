"""TSV lines of chosen rows, computed from the FASTA files alone.

The output's row order is the reference CLI's: a square (one file) runs
over pairs i < j row by row; a rectangle (two files) over file 1's
records, then file 2's; a stream (``-i a -s b``) over the streamed
records, then the loaded ones.  Line 0 is the header; row r is line r + 1.
"""

from typing import Dict, List, Sequence

import numpy as np

from reference import measures
from reference.encoding import ENCODE

HEADER = b"sequence1\tsequence2\tdistance"

# Counted in chunks of pairs, so that a sample of thousands of pairs of
# 30 kb records stays within a few hundred MB.
PAIR_CHUNK = 256


class Fasta:
    """Record ids and sequence bytes of a FASTA file, as the reference CLI
    reads them: the id is the header line after '>', the sequence the
    following lines joined."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(b">"):
            raise ValueError(f"{path}: not FASTA")
        self.ids: List[str] = []
        self.seqs: List[bytes] = []
        for rec in data[1:].split(b"\n>"):
            head, _, body = rec.partition(b"\n")
            self.ids.append(head.strip().decode())
            self.seqs.append(body.replace(b"\n", b"").replace(b"\r", b""))

    def __len__(self) -> int:
        return len(self.ids)

    def rows(self, idx: np.ndarray) -> np.ndarray:
        """The raw bytes of records ``idx`` as a (k, L) uint8 matrix."""
        return np.stack([np.frombuffer(self.seqs[i], dtype=np.uint8)
                         for i in idx])


def pair_of_row(mode: str, n1: int, n2: int, rows: np.ndarray):
    """(i, j) of each 0-based output row: i indexes file 1 (the loaded
    file), j file 2 (the streamed one), or file 1 again in a square."""
    rows = np.asarray(rows, dtype=np.int64)
    if mode == "square":
        i_all = np.arange(n1 - 1, dtype=np.int64)
        first = i_all * n1 - i_all * (i_all + 1) // 2  # row of (i, i + 1)
        i = np.searchsorted(first, rows, side="right") - 1
        j = rows - first[i] + i + 1
        return i, j
    if mode == "rectangle":
        return rows // n2, rows % n2
    if mode == "stream":
        return rows % n1, rows // n1
    raise ValueError(mode)


def n_rows(mode: str, n1: int, n2: int) -> int:
    return n1 * (n1 - 1) // 2 if mode == "square" else n1 * n2


def counters(q: np.ndarray, t: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-pair site counts of two (k, L) code matrices, by the reference
    CLI's predicates."""
    qi, ti = q.astype(np.int32), t.astype(np.int32)
    diff = (qi & ti) < 16
    same = (qi == ti) & ((qi & 8) == 8)
    pur_q, pur_t = (qi & 55) == 0, (ti & 55) == 0
    pyr_q, pyr_t = (qi & 199) == 0, (ti & 199) == 0
    known = ((qi & 8) == 8) & ((ti & 8) == 8)
    ts = diff & ((pur_q & pur_t) | (pyr_q & pyr_t))
    tv = diff & ((pur_q & pyr_t) | (pyr_q & pur_t))
    dk = diff & known
    return {
        "diff": diff.sum(1), "same": same.sum(1), "ts": ts.sum(1),
        "tv": tv.sum(1), "kk": known.sum(1),
        "p1": (dk & ((qi | ti) == 200)).sum(1),
        "p2": (dk & ((qi | ti) == 56)).sum(1),
        "bytes_differ": (q != t).sum(1),
    }


def tallies(raw: np.ndarray, loaded: bool) -> np.ndarray:
    """tn93's (A, T, G, C) tallies of records given as raw bytes: the
    loaded side counts exact-base codes, the streamed side upper-case
    letters only (the reference CLI's two readers differ so)."""
    if loaded:
        codes = ENCODE[raw]
        return np.stack([(codes == c).sum(1) for c in (136, 24, 72, 40)], 1)
    return np.stack([(raw == ord(ch)).sum(1) for ch in "ATGC"], 1)


def _value(measure: str, c: Dict[str, int], qc, tc, control: bool):
    if measure in ("n", "n_high"):
        # The control for the integer measures breaks their stated
        # guarantee: it counts every byte that differs, blind to
        # ambiguity codes, N and gaps.
        return int(c["bytes_differ"] if control else c["diff"])
    if measure == "raw":
        f = measures.raw_f32 if control else measures.raw
        return f(c["diff"], c["same"])
    if measure == "jc69":
        f = measures.jc69_f32 if control else measures.jc69
        return f(c["diff"], c["same"])
    if measure == "k80":
        f = measures.k80_f32 if control else measures.k80
        return f(c["same"], c["ts"], c["tv"])
    if measure == "tn93":
        f = measures.tn93_f32 if control else measures.tn93
        return f(c["same"], c["kk"], c["p1"], c["p2"], qc, tc)
    raise ValueError(measure)


def expected_lines(measure: str, mode: str, paths: Sequence[str],
                   lines: Sequence[int], control: bool = False
                   ) -> Dict[int, bytes]:
    """The TSV's line of each line number in ``lines`` (0 = the header),
    without its newline.  ``control``: computed one step below the
    stated precision (float32 closed forms; for n and n_high, counts
    blind to ambiguity)."""
    a = Fasta(paths[0])
    b = a if mode == "square" else Fasta(paths[1])
    out: Dict[int, bytes] = {}
    rows = np.array([k - 1 for k in lines if k > 0], dtype=np.int64)
    if 0 in lines:
        out[0] = HEADER
    if not len(rows):
        return out
    i, j = pair_of_row(mode, len(a), len(b), rows)
    for c0 in range(0, len(rows), PAIR_CHUNK):
        sl = slice(c0, c0 + PAIR_CHUNK)
        qraw, traw = a.rows(i[sl]), b.rows(j[sl])
        cnt = counters(ENCODE[qraw], ENCODE[traw])
        qt = tt = None
        if measure == "tn93":
            qt = tallies(qraw, True)
            tt = tallies(traw, mode != "stream")
        for k in range(len(qraw)):
            c = {name: int(v[k]) for name, v in cnt.items()}
            v = _value(measure, c, None if qt is None else qt[k],
                       None if tt is None else tt[k], control)
            r = int(rows[c0 + k])
            out[r + 1] = (f"{a.ids[i[c0 + k]]}\t{b.ids[j[c0 + k]]}\t"
                          f"{measures.format_value(v)}").encode()
    return out

