"""Randomized differential fuzz of the port's engine over the JAX fuzzer's
config lattice.

Each iteration derives a random configuration (measure x mode x shapes x
tiles x batchsize x budget knobs x packing/diff-upload toggles x parse
workers) from a seed with ``one_config``, a copy of the JAX fuzzer's
(``scripts/fuzz_differential.py``), runs the port's engine with the
configuration's knobs on the chosen backend, and byte-compares its TSV
against the port's ``--backend torch`` run of the plain configuration
(the default knobs).  ``--backend cuda`` holds the hand-written kernels
on the card against their plain versions on the CPU over the whole
lattice; ``--backend torch`` holds the plain path's out-of-core, staged,
packed and diff-uploaded layouts against its in-core run.  The JAX
fuzzer's knobs map onto the port's: ``HBM_BUDGET_BYTES`` is the port's
``DEVICE_BUDGET`` (its default 0 is the auto budget: none on the CPU,
half the card's free memory on a card), and ``HOST_BUF_BUDGET``,
``STAGED_ROWS_FLOOR``, ``FEATCACHE_BUDGET``, ``fastaio.STREAM_READ_BYTES``
and the three environment variables keep their names.  The script never
imports jax.

Usage:
    python scripts/fuzz_differential_torch.py [--backend cuda|torch]
        [--iters N | --seconds S] [--seed-base 0]

On a mismatch it prints the failing seed and its configuration and exits
1; re-run one seed with ``--iters 1 --seed-base <seed>``.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import distance_tpu_torch.engine as engine  # noqa: E402
import distance_tpu_torch.fastaio as fio  # noqa: E402
from distance_tpu_torch.engine import Setup, run  # noqa: E402
from distance_tpu_torch.fastaio import consensus as consensus_fn  # noqa: E402
from distance_tpu_torch.fastaio import load_fastas  # noqa: E402
from distance_tpu_torch.writer import TsvWriter  # noqa: E402

MEASURES = ["n", "n_high", "raw", "jc69", "k80", "tn93"]
# the JAX fuzzer's tile palette and widths
TILES = [2, 4, 8, 16, 32]
WIDTHS = [1, 3, 17, 64, 96, 127, 128, 129, 200, 256, 310]

# The port's knob defaults, under the JAX fuzzer's names.
DEFAULTS = dict(
    HBM_BUDGET_BYTES=engine.DEVICE_BUDGET,
    HOST_BUF_BUDGET=engine.HOST_BUF_BUDGET,
    FEATCACHE_BUDGET=engine.FEATCACHE_BUDGET,
    STAGED_ROWS_FLOOR=engine.STAGED_ROWS_FLOOR,
)
STREAM_READ_DEFAULT = fio.STREAM_READ_BYTES
ENV_KNOBS = ("DISTANCE_TPU_NO_DIFF_UPLOAD", "DISTANCE_TPU_NO_REL_PACK",
             "DISTANCE_TPU_STREAM_PARSE_WORKERS")


def one_config(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    mode = rng.choice(["square", "rect", "stream"], p=[0.4, 0.3, 0.3])
    cfg = dict(
        seed=seed,
        mode=str(mode),
        measure=str(rng.choice(MEASURES)),
        n1=int(rng.integers(2, 70)),
        n2=int(rng.integers(1, 50)),
        width=int(rng.choice(WIDTHS)),
        amb=float(rng.choice([0.0, 0.1, 0.3, 0.5])),
        ti=int(rng.choice(TILES)),
        tj=int(rng.choice(TILES)),
        batchsize=int(rng.integers(1, 7)),
        # tiny budgets force out-of-core / staged paths; huge = in-core
        hbm=int(rng.choice([5_000, 30_000, 200_000, DEFAULTS["HBM_BUDGET_BYTES"]])),
        hostbuf=int(rng.choice([4_000, 50_000, DEFAULTS["HOST_BUF_BUDGET"]])),
        staged_floor=int(rng.choice([2, 16, DEFAULTS["STAGED_ROWS_FLOOR"]])),
        featcache=int(rng.choice([0, DEFAULTS["FEATCACHE_BUDGET"]])),
        no_diffup=bool(rng.random() < 0.3),
        no_relpack=bool(rng.random() < 0.3),
        parse_workers=int(rng.choice([1, 3])),
        read_bytes=int(rng.choice([96, 512, STREAM_READ_DEFAULT])),
    )
    return cfg


def make_fasta(records) -> bytes:
    out = []
    for rid, seq in records:
        out.append(f">{rid}\n{seq}\n")
    return "".join(out).encode()


def random_seqs(rng, n, width, alphabet="ACGT", amb_frac=0.0):
    """Random alignment around a shared ancestor, optionally rich in
    ambiguity codes."""
    amb = "RMWSKYVHDBN-?"
    ancestor = rng.choice(list(alphabet), size=width)
    seqs = []
    for i in range(n):
        s = ancestor.copy()
        nmut = rng.integers(0, max(1, width // 4))
        pos = rng.choice(width, size=min(nmut, width), replace=False)
        for p in pos:
            if amb_frac and rng.random() < amb_frac:
                s[p] = rng.choice(list(amb))
            else:
                s[p] = rng.choice(list("ACGTacgt"))
        seqs.append("".join(s))
    return [(f"s{i}", seqs[i]) for i in range(n)]


def fuzz_inputs(cfg: dict) -> tuple:
    """The two FASTA files of a configuration, as the JAX fuzzer makes
    them from its seed."""
    rng = np.random.default_rng(cfg["seed"] + 10_000_000)
    f1 = make_fasta(
        random_seqs(rng, cfg["n1"], cfg["width"], amb_frac=cfg["amb"])
    )
    recs2 = [
        (f"t{i}", s)
        for i, (_r, s) in enumerate(
            random_seqs(rng, cfg["n2"], cfg["width"], amb_frac=cfg["amb"])
        )
    ]
    return f1, make_fasta(recs2)


def run_once(cfg: dict, backend: str, f1: bytes, f2: bytes) -> bytes:
    """The TSV of one configuration through the port's engine, as the JAX
    fuzzer's ``run_once`` runs its own."""
    handles = [io.BytesIO(f1)]
    stream = None
    if cfg["mode"] == "rect":
        handles.append(io.BytesIO(f2))
    elif cfg["mode"] == "stream":
        stream = io.BytesIO(f2)
    loaded = load_fastas(handles)
    cons = consensus_fn(loaded) if cfg["measure"] == "n" else None
    if cfg["measure"] == "tn93":
        for a in loaded:
            a.count_bases()
    out = io.BytesIO()
    setup = Setup(
        loaded=loaded,
        streamed=stream,
        writer=TsvWriter(out),
        measure=cfg["measure"],
        n_threads=1,
        batchsize=cfg["batchsize"],
        backend=backend,
        consensus=cons,
        tile_i=cfg["ti"],
        tile_j=cfg["tj"],
    )
    run(setup)
    return out.getvalue()


def apply_knobs(cfg: dict) -> None:
    engine.DEVICE_BUDGET = cfg["hbm"]
    engine.HOST_BUF_BUDGET = cfg["hostbuf"]
    engine.STAGED_ROWS_FLOOR = cfg["staged_floor"]
    engine.FEATCACHE_BUDGET = cfg["featcache"]
    fio.STREAM_READ_BYTES = cfg["read_bytes"]
    for k, v in (
        ("DISTANCE_TPU_NO_DIFF_UPLOAD", cfg["no_diffup"]),
        ("DISTANCE_TPU_NO_REL_PACK", cfg["no_relpack"]),
    ):
        if v:
            os.environ[k] = "1"
        else:
            os.environ.pop(k, None)
    os.environ["DISTANCE_TPU_STREAM_PARSE_WORKERS"] = str(
        cfg["parse_workers"]
    )


def restore_knobs() -> None:
    engine.DEVICE_BUDGET = DEFAULTS["HBM_BUDGET_BYTES"]
    engine.HOST_BUF_BUDGET = DEFAULTS["HOST_BUF_BUDGET"]
    engine.STAGED_ROWS_FLOOR = DEFAULTS["STAGED_ROWS_FLOOR"]
    engine.FEATCACHE_BUDGET = DEFAULTS["FEATCACHE_BUDGET"]
    fio.STREAM_READ_BYTES = STREAM_READ_DEFAULT
    for k in ENV_KNOBS:
        os.environ.pop(k, None)


def run_with_knobs(cfg: dict, backend: str, f1: bytes, f2: bytes) -> bytes:
    """``run_once`` under the configuration's knobs, restored after."""
    try:
        apply_knobs(cfg)
        return run_once(cfg, backend, f1, f2)
    finally:
        restore_knobs()


def fuzz_one(seed: int, backend: str) -> tuple:
    """(ok, cfg, detail): the seed's configuration on ``backend`` under its
    knobs against ``--backend torch`` under the default knobs."""
    cfg = one_config(seed)
    f1, f2 = fuzz_inputs(cfg)
    got = run_with_knobs(cfg, backend, f1, f2)
    want = run_once(cfg, "torch", f1, f2)
    if got != want:
        return False, cfg, f"{backend} (knobs) != torch (defaults)"
    return True, cfg, ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=engine.BACKENDS, default="cuda")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--iters", type=int, default=0)
    ap.add_argument("--seed-base", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.seconds and not args.iters:
        args.seconds = 300.0
    t0 = time.time()
    n = 0
    by_mode = {"square": 0, "rect": 0, "stream": 0}
    seed = args.seed_base
    while (n < args.iters if args.iters
           else time.time() - t0 < args.seconds):
        ok, cfg, detail = fuzz_one(seed, args.backend)
        by_mode[cfg["mode"]] += 1
        if not ok:
            print(f"\nFAIL seed={seed}: {detail}\nconfig: {cfg}")
            return 1
        n += 1
        seed += 1
        if n % 25 == 0:
            print(f"[fuzz] {n} configs ok in {time.time() - t0:.0f}s"
                  f" (square {by_mode['square']} / rect {by_mode['rect']}"
                  f" / stream {by_mode['stream']})", flush=True)
    print(f"[fuzz] PASS: {n} random configs byte-identical"
          f" ({args.backend} vs torch) in {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
