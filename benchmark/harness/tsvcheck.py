"""What the check reads of each job's TSV, and the comparison.

Every job, the cold one too, writes its TSV into a FIFO that a process
of the harness drains, so that a run writes nothing of it to disk.  The
drain keeps only the byte count, a sum of the stream's 64-bit words and
the text of each line the check compares (found by counting newlines in
the cold job's TSV, and read at the same byte ranges in the window's),
so that its host work stays small beside a host-bound program; being a
process of its own, it takes no turn at the program's interpreter lock.
``python3 tsvcheck.py FIFO LINES CHUNK`` is that process.
"""

import fcntl
import json
import os
import queue
import subprocess
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

BLOCK = 4096
CHUNK = 4 << 20
MASK = (1 << 64) - 1
PIPE_BYTES = 1 << 20


@dataclass
class Seen:
    """What the check keeps of one job's TSV."""
    nbytes: int = 0
    wordsum: int = 0          # the little-endian 64-bit words, zero-padded
    n_lines: int = -1         # newlines; counted in the first job only
    texts: Dict[int, bytes] = field(default_factory=dict)


class _Words:
    """The running sum of a byte stream's 64-bit words, fed in pieces of
    any length."""

    def __init__(self):
        self.total = 0
        self.carry = b""

    def feed(self, chunk: memoryview) -> None:
        if self.carry:
            head = bytes(chunk[:8 - len(self.carry)])
            chunk = chunk[len(head):]
            self.carry += head
            if len(self.carry) < 8:
                return
            self.total += int.from_bytes(self.carry, "little")
            self.carry = b""
        k = len(chunk) // 8 * 8
        if k:
            s = np.frombuffer(chunk[:k], dtype="<u8").sum(dtype=np.uint64)
            self.total = (self.total + int(s)) & MASK
        self.carry = bytes(chunk[k:])

    def value(self) -> int:
        tail = int.from_bytes(self.carry.ljust(8, b"\0"), "little")
        return (self.total + tail) & MASK


def read_lines(f, mv: memoryview, lines: List[int]) -> tuple:
    """(Seen, ranges) of one job's stream ``f``, read to its end through
    ``mv``: its bytes, word sum and newlines, and the text of each line
    numbered in ``lines`` (sorted; 0 is the header) that a newline ends;
    ranges maps each of those lines to its (start, end) byte offsets,
    newline excluded.  A chunk's newlines are counted by blocks, so that
    a wanted line is found in its block alone."""
    words = _Words()
    texts: Dict[int, bytes] = {}
    ranges: Dict[int, tuple] = {}
    want = np.asarray(lines, dtype=np.int64)
    newline = np.empty(len(mv), dtype=bool)
    done = pos = 0             # newlines and bytes before this chunk
    partial: Optional[List[bytes]] = None  # the wanted line in progress
    opened = 0                 # where that line starts
    while True:
        n = f.readinto(mv)
        if not n:
            break
        chunk = mv[:n]
        words.feed(chunk)
        nl = np.equal(np.frombuffer(chunk, dtype=np.uint8), 10,
                      out=newline[:n])
        full = n // BLOCK * BLOCK
        per = np.add.reduce(nl[:full].view(np.uint8).reshape(-1, BLOCK),
                            axis=1, dtype=np.uint16)
        if full < n:
            per = np.append(per, np.count_nonzero(nl[full:]))
        ends = np.cumsum(per, dtype=np.int64)  # newlines to each block's end
        count = int(ends[-1])

        def nth(k: int) -> int:
            """The offset in the chunk of its newline ``k`` (from 0)."""
            blk = int(np.searchsorted(ends, k, side="right"))
            k -= int(ends[blk - 1]) if blk else 0
            return blk * BLOCK + int(
                np.flatnonzero(nl[blk * BLOCK:(blk + 1) * BLOCK])[k])

        # wanted lines that end in this chunk, and the one left open
        a, b = np.searchsorted(want, [done, done + count], side="left")
        for ln in want[a:b]:
            k = int(ln) - done
            start, end = nth(k - 1) + 1 if k else 0, nth(k)
            text = bytes(chunk[start:end])
            if k == 0 and partial is not None:
                text = b"".join(partial) + text
            texts[int(ln)] = text
            ranges[int(ln)] = (pos + start if k else opened, pos + end)
        if b < len(want) and want[b] == done + count:
            start = nth(count - 1) + 1 if count else 0
            if count or partial is None:
                partial, opened = [], pos + start
            partial.append(bytes(chunk[start:]))
        elif count:
            partial = None
        done += count
        pos += n
    return Seen(nbytes=pos, wordsum=words.value(), n_lines=done,
                texts=texts), ranges


def read_ranges(f, mv: memoryview, ranges: Dict[int, tuple]) -> Seen:
    """What the check keeps of a later job's stream ``f``: its bytes, word
    sum, and the bytes at each line's range in the first job's TSV (its
    newlines are not counted)."""
    order = sorted(ranges.items(), key=lambda kv: kv[1][0])
    lines = [ln for ln, _ in order]
    starts = [r[0] for _, r in order]
    ends = [r[1] for _, r in order]
    words = _Words()
    pieces: Dict[int, List[bytes]] = {ln: [] for ln in lines}
    pos, first = 0, 0
    while True:
        n = f.readinto(mv)
        if not n:
            break
        chunk = mv[:n]
        words.feed(chunk)
        end = pos + n
        # ranges that overlap [pos, end): they are sorted by start
        while first < len(ends) and ends[first] <= pos:
            first += 1
        r = first
        while r < len(starts) and starts[r] < end:
            a = max(starts[r], pos) - pos
            b = min(ends[r], end) - pos
            if b > a:
                pieces[lines[r]].append(bytes(chunk[a:b]))
            r += 1
        pos = end
    return Seen(nbytes=pos, wordsum=words.value(), n_lines=-1,
                texts={ln: b"".join(p) for ln, p in pieces.items()})


def _die_with_parent() -> None:
    """Asks Linux to end this process when its parent ends."""
    try:
        import ctypes
        import signal
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))
    except (OSError, AttributeError):
        pass


def serve(fifo: str, lines_path: str, chunk: int) -> None:
    """The drain process: reads job after job from ``fifo`` until it is
    ended, and writes for each one JSON line to standard output.  The
    first job's lines are found by counting newlines; later jobs are read
    at that job's byte ranges, which costs a host-bound program less."""
    _die_with_parent()
    with open(lines_path) as f:
        lines = sorted(int(ln) for ln in json.load(f))
    mv = memoryview(bytearray(chunk))
    out = sys.stdout
    ranges = None
    while True:
        fd = os.open(fifo, os.O_RDONLY)
        try:
            try:
                fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, PIPE_BYTES)
            except (OSError, AttributeError):
                pass
            with os.fdopen(fd, "rb", buffering=0) as f:
                if ranges is None:
                    seen, ranges = read_lines(f, mv, lines)
                else:
                    seen = read_ranges(f, mv, ranges)
            msg = {"nbytes": seen.nbytes, "wordsum": seen.wordsum,
                   "n_lines": seen.n_lines,
                   "texts": {str(ln): t.hex()
                             for ln, t in seen.texts.items()}}
        except Exception as e:  # handed to the harness
            msg = {"error": repr(e)}
        out.write(json.dumps(msg) + "\n")
        out.flush()


class Drain:
    """Reads job after job from a FIFO until stopped; for each job puts a
    Seen (or the exception that ended the read) on ``results``."""

    def __init__(self, fifo: str, lines):
        self.fifo = fifo
        self.lines = sorted(int(ln) for ln in lines)
        self.results: "queue.Queue" = queue.Queue()
        self._proc = None
        self._pump = None

    def start(self) -> None:
        path = self.fifo + ".lines.json"
        with open(path, "w") as f:
            json.dump(self.lines, f)
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.fifo, path,
             str(CHUNK)],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE)
        self._pump = threading.Thread(target=self._forward,
                                      name="tsv-drain", daemon=True)
        self._pump.start()

    def _forward(self) -> None:
        for line in self._proc.stdout:
            msg = json.loads(line)
            if "error" in msg:
                self.results.put(RuntimeError(msg["error"]))
                continue
            self.results.put(Seen(
                nbytes=msg["nbytes"], wordsum=msg["wordsum"],
                n_lines=msg["n_lines"],
                texts={int(ln): bytes.fromhex(t)
                       for ln, t in msg["texts"].items()}))

    def is_alive(self) -> bool:
        return ((self._proc is not None and self._proc.poll() is None)
                or (self._pump is not None and self._pump.is_alive()))

    def stop(self, timeout: float = 10.0) -> None:
        """Ends the drain process and waits for it; a job still in flight
        is read no further."""
        if self._proc is None:
            return
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        self._pump.join(timeout)
        self._proc.stdout.close()


def judge(expected: Dict[int, bytes], rows: int, cold: Optional[Seen],
          window: List[Optional[Seen]], rcs: List[int]) -> tuple:
    """(checks, failed): each number compared with its limit (exact
    comparisons, limit 0), and how many jobs failed any of them.

    jobs_failed: jobs whose CLI exit code was not 0.  rows_wrong: over the
    cold job and every window job, compared lines whose bytes are not the
    reference's.  lines_off: the cold job's line count less the header and
    the rows due.  jobs_unlike_cold: window jobs whose byte count or word
    sum differ from the cold job's TSV.
    """
    def wrong(seen):
        texts = seen.texts if seen is not None else {}
        return sum(texts.get(ln) != want for ln, want in expected.items())

    def unlike(w):
        return (w is None or cold is None
                or (w.nbytes, w.wordsum) != (cold.nbytes, cold.wordsum))

    lines_off = abs(cold.n_lines - (rows + 1)) if cold is not None else rows + 1
    bad = [rcs[0] != 0 or wrong(cold) > 0 or lines_off > 0]
    bad += [rc != 0 or wrong(w) > 0 or unlike(w)
            for rc, w in zip(rcs[1:], window)]
    checks = {"jobs_failed": (sum(rc != 0 for rc in rcs), 0),
              "rows_wrong": (sum(wrong(s) for s in [cold] + list(window)), 0),
              "lines_off": (lines_off, 0),
              "jobs_unlike_cold": (sum(unlike(w) for w in window), 0)}
    return checks, sum(bad)


if __name__ == "__main__":
    serve(sys.argv[1], sys.argv[2], int(sys.argv[3]))
