"""The check's reader: the drain keeps the same line count, lines and
word sum as a plain split of the bytes, however the writer cuts them,
and reads later jobs at the first job's byte ranges."""

import os
import threading

import numpy as np
import pytest

from harness import tsvcheck


def _tsv(rng, n, newline_at_end=True):
    rows = [b"sequence1\tsequence2\tdistance"] + [
        bytes(rng.integers(97, 122, size=int(rng.integers(0, 40)))
              .astype(np.uint8)) for _ in range(n)]
    return b"\n".join(rows) + (b"\n" if newline_at_end else b"")


def _words(data: bytes) -> int:
    padded = data + b"\0" * (-len(data) % 8)
    return int(np.frombuffer(padded, dtype="<u8").sum(dtype=np.uint64))


@pytest.mark.parametrize("chunk", [8, 64, 1000, 1 << 20])
@pytest.mark.parametrize("seed", range(6))
def test_drain_agrees_with_a_split(tmp_path, monkeypatch, chunk, seed):
    monkeypatch.setattr(tsvcheck, "CHUNK", chunk)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 2500))
    data = _tsv(rng, n, seed % 3 != 0)
    lines = np.unique(np.concatenate([rng.integers(0, n + 3, size=60),
                                      [0, n - 1, n, n + 1]]))
    complete = data.split(b"\n")[:-1]
    want = {int(ln): complete[ln] for ln in lines if ln < len(complete)}

    fifo = str(tmp_path / "f.fifo")
    os.mkfifo(fifo)
    drain = tsvcheck.Drain(fifo, lines.tolist())
    drain.start()

    def write(payload):
        with open(fifo, "wb") as f:
            p = 0
            while p < len(payload):
                q = p + int(rng.integers(1, 5000))
                f.write(payload[p:q])
                p = q

    try:
        # the first job's lines are counted; later jobs are read at its
        # byte ranges
        for i, payload in enumerate((data, data[:-7] + b"xxxxxxx", data,
                                     b"")):
            t = threading.Thread(target=write, args=(payload,))
            t.start()
            got = drain.results.get(timeout=30)
            t.join(30)
            assert got.nbytes == len(payload)
            assert got.wordsum == _words(payload)
            assert got.n_lines == (payload.count(b"\n") if i == 0 else -1)
            if payload is data:
                assert got.texts == want
    finally:
        drain.stop()
    assert not drain.is_alive()
