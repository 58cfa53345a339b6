"""A cell's inputs from its seed: the FASTA files, the CLI's arguments,
and the output lines the check compares."""

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from harness.layout import Layout
from reference.distances import n_rows


@dataclass
class Job:
    mode: str            # square, rectangle or stream
    measure: str
    argv: List[str]      # the CLI's arguments, less -o and --backend
    paths: List[str]     # FASTA files: file 1, then file 2 if any
    n1: int              # records of file 1 (the loaded file)
    n2: int              # records of file 2 (file 1 again in a square)
    rows: int            # output rows of one job
    chars: np.ndarray    # every record of the job, as characters
    lines: np.ndarray    # line numbers the check compares (0 = header)
    env: dict            # environment knobs of the traffic mix


def rng_seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def make_ids(cfg: dict, n: int, seed: int) -> List[bytes]:
    """Distinct accession-style ids of one width: the prefix and
    ``id_digits`` digits."""
    d = int(cfg["id_digits"])
    rng = np.random.default_rng([rng_seed(seed), 1])
    nums = rng.choice(9 * 10 ** (d - 1), size=n, replace=False) + 10 ** (d - 1)
    return [f"{cfg['id_prefix']}{v}".encode() for v in nums]


def write_fasta(path: str, ids: List[bytes], chars: np.ndarray) -> None:
    """One record a line pair, written in one call."""
    n, sites = chars.shape
    width = len(ids[0])
    rec = np.empty((n, width + sites + 3), dtype=np.uint8)
    rec[:, 0] = ord(">")
    rec[:, 1:1 + width] = np.frombuffer(b"".join(ids), np.uint8).reshape(
        n, width)
    rec[:, 1 + width] = ord("\n")
    rec[:, 2 + width:-1] = chars
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.data)


def sample_lines(rows: int, k: int, seed: int) -> np.ndarray:
    """The header, the first and the last row, and ``k`` rows drawn from
    the seed, as sorted line numbers."""
    rng = np.random.default_rng([rng_seed(seed), 2])
    drawn = rng.choice(rows, size=min(k, rows), replace=False) + 1
    return np.unique(np.concatenate([[0, 1, rows], drawn])).astype(np.int64)


def build(layout: Layout, cell: dict, seed: int, tmpdir: str) -> Job:
    cfg = layout.config(cell["config"])
    traffic = layout.traffic(cell["traffic"])
    mode, measure = traffic["mode"], traffic["measure"]
    if mode == "square":
        n1 = n2 = int(cfg["records"])
        total = n1
    else:
        n1, n2 = int(cfg["loaded_records"]), int(cfg["streamed_records"])
        total = n1 + n2
    chars = layout.recipe(cfg["recipe"]).make(cfg, total, rng_seed(seed))
    ids = make_ids(cfg, total, seed)
    if mode == "square":
        paths = [os.path.join(tmpdir, "aln.fasta")]
        write_fasta(paths[0], ids, chars)
        argv = [paths[0]]
    else:
        paths = [os.path.join(tmpdir, "loaded.fasta"),
                 os.path.join(tmpdir, "streamed.fasta")]
        write_fasta(paths[0], ids[:n1], chars[:n1])
        write_fasta(paths[1], ids[n1:], chars[n1:])
        argv = ([paths[0], "-s", paths[1]] if mode == "stream"
                else [paths[0], paths[1]])
    rows = n_rows(mode, n1, n2)
    return Job(mode=mode, measure=measure,
               argv=argv + ["-m", measure] + list(traffic.get("flags", [])),
               paths=paths, n1=n1, n2=n2, rows=rows, chars=chars,
               lines=sample_lines(rows, int(traffic["check_rows"]), seed),
               env=dict(traffic.get("env", {})))
