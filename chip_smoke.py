#!/usr/bin/env python3
"""Smoke run of distance_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the counter kernel from
``distance_tpu_torch/csrc``, holds it against its plain PyTorch version,
drives the port's CLI at the bench shape (``-m raw``, 8192 x 29904, a
SARS-CoV-2-scale synthetic alignment made from a seed), checks the
output, and times the kernel beside the plain version.  Phases:

1. environment: the card, torch, CUDA, nvcc; build the kernel;
2. the kernel against its plain version, exactly, for all six measures
   at ragged shapes, an empty side and a 512 x 512 block of the bench
   alignment;
3. the main path: the CLI on the 8192 x 29904 alignment, ``-m raw
   --backend cuda``; line count, 1200 random rows against the host
   oracle, and the kernel's launch count in that run;
4. all six measures end to end at 256 x 29904: ``--backend cuda`` and
   ``--backend torch`` write identical bytes;
5. the kernel against its plain version at the main path's block shape
   (2048 x 2048 x 29952 padded sites) for all six measures, both timed
   on the card; raw's times go into the result line.

Any failed check raises, and the script exits non-zero without a result.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.  Without a CUDA
device, or without the package beside it, it fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # the port must never import jax

import numpy as np

N_BENCH = 8192
L_BENCH = 29904
BLOCK = 2048
SEED = 0


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def make_alignment(n: int, width: int, seed: int = 0) -> np.ndarray:
    """Low-diversity alignment: shared ancestor + 40 mutations/seq,
    sprinkled with Ns and gaps (SARS-CoV-2-like).  The recipe of the JAX
    package's bench.make_alignment."""
    from distance_tpu_torch.encoding import A, C, G, GAP, N, T

    rng = np.random.default_rng(seed)
    bases = np.array([A, C, G, T], dtype=np.uint8)
    ancestor = rng.choice(bases, size=width)
    mat = np.tile(ancestor, (n, 1))
    n_mut = 40
    rows = np.repeat(np.arange(n), n_mut)
    cols = rng.integers(0, width, size=n * n_mut)
    vals = rng.choice(bases, size=n * n_mut)
    mat[rows, cols] = vals
    # ~0.5% N / gaps
    n_amb = int(0.005 * n * width / 100) * 100
    rows = rng.integers(0, n, size=n_amb)
    cols = rng.integers(0, width, size=n_amb)
    mat[rows, cols] = np.where(rng.random(n_amb) < 0.8, N, GAP).astype(np.uint8)
    return mat


def write_fasta(path: str, mat: np.ndarray) -> list:
    from distance_tpu_torch.encoding import CODE_TO_CHAR

    decode = np.zeros(256, dtype=np.uint8)
    for code, ch in CODE_TO_CHAR.items():
        decode[code] = ord(ch)
    ids = [f"seq{i}" for i in range(mat.shape[0])]
    chars = decode[mat]
    with open(path, "wb") as f:
        for rid, row in zip(ids, chars):
            f.write(b">" + rid.encode() + b"\n" + row.tobytes() + b"\n")
    return ids


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_environment() -> str:
    import torch

    from distance_tpu_torch._native import get_lib
    from distance_tpu_torch.ops import _build

    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    _build.load("counters")
    print(f"[1] counter kernel built and loaded in"
          f" {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    check(get_lib() is not None, "the native host library did not build")
    print(f"[1] native host library built and loaded in"
          f" {time.perf_counter() - t0:.3f} s")
    return card


def phase_kernel_vs_plain(bench: np.ndarray) -> int:
    """Exact equality of the kernel and its plain version on the card;
    returns the largest absolute difference seen (0)."""
    import torch

    from distance_tpu_torch.encoding import ALL_CODES
    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops.counters import counters_cuda, counters_torch
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda", 0)

    def codes(rows, width):
        return rng.choice(ALL_CODES, size=(rows, width)).astype(np.uint8)

    cases = [
        ("13x7x200", codes(13, 200), codes(7, 200)),
        ("130x257x1000", codes(130, 1000), codes(257, 1000)),
        ("0x5x128", codes(0, 128), codes(5, 128)),
        ("6x0x128", codes(6, 128), codes(0, 128)),
        ("bench 512x512x29904", bench[:512], bench[512:1024]),
    ]
    worst = 0
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        for name, x, y in cases:
            xd = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            yd = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
            got = counters_cuda(xd, yd, plan)
            torch.cuda.synchronize()
            want = counters_torch(xd, yd, plan)
            torch.cuda.synchronize()
            check(got.shape == want.shape,
                  f"{measure} {name}: shape {tuple(got.shape)}"
                  f" != {tuple(want.shape)}")
            if got.numel():
                err = int((got.long() - want.long()).abs().max())
                worst = max(worst, err)
                check(err == 0, f"{measure} {name}: max |kernel - plain|"
                                f" = {err}")
        print(f"[2] {measure}: kernel == plain on {len(cases)} shapes")
    return worst


def phase_main_path(tmp: str, bench: np.ndarray) -> int:
    """The CLI at the bench shape; returns the kernel launches of the run."""
    from distance_tpu_torch import cli, measures
    from distance_tpu_torch.ops import counters as kernels
    from distance_tpu_torch.utils import timing
    from distance_tpu_torch.writer import format_float

    n = bench.shape[0]
    fasta = os.path.join(tmp, "bench.fasta")
    out = os.path.join(tmp, "bench_raw.tsv")
    t0 = time.perf_counter()
    ids = write_fasta(fasta, bench)
    print(f"[3] wrote {n} x {bench.shape[1]} FASTA in"
          f" {time.perf_counter() - t0:.3f} s")

    timing.reset()
    kernels.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main([fasta, "-m", "raw", "--backend", "cuda", "-o", out])
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES
    check(rc == 0, f"main path exited {rc}")
    print("[3] host phase totals (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(timing.totals().items())))
    check(launches > 0, "the main path launched no counter kernel")
    pairs = n * (n - 1) // 2
    print(f"[3] main path: {pairs} pairs in {wall:.3f} s ="
          f" {pairs / wall:.6e} pairs/s end to end, {launches} kernel"
          f" launches ({gpu_line()})")

    with open(out, "rb") as f:
        data = f.read()
    nl = np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == 10)
    check(len(nl) == 1 + pairs,
          f"TSV has {len(nl)} lines, expected {1 + pairs}")
    check(data[: nl[0]] == b"sequence1\tsequence2\tdistance",
          "TSV header differs")
    rng = np.random.default_rng(SEED + 2)
    samples = 1200
    ii = rng.integers(0, n - 1, size=samples)
    jj = ii + 1 + (rng.random(samples) * (n - 1 - ii)).astype(np.int64)
    for i, j in zip(ii.tolist(), jj.tolist()):
        k = 1 + i * (2 * n - i - 1) // 2 + (j - i - 1)
        line = data[nl[k - 1] + 1 : nl[k]].decode()
        want = (f"{ids[i]}\t{ids[j]}\t"
                f"{format_float(measures.raw(bench[i], bench[j]))}")
        check(line == want, f"row ({i}, {j}): {line!r} != {want!r}")
    print(f"[3] {1 + pairs} lines; {samples} random rows equal the host"
          " oracle")
    return launches


def phase_six_measures(tmp: str, bench: np.ndarray) -> None:
    from distance_tpu_torch import cli
    from distance_tpu_torch.measures import MEASURES

    sub = bench[:256]
    fasta = os.path.join(tmp, "six.fasta")
    write_fasta(fasta, sub)
    for measure in MEASURES:
        outs = {}
        for backend in ("cuda", "torch"):
            outs[backend] = os.path.join(tmp, f"six_{measure}_{backend}.tsv")
            t0 = time.perf_counter()
            rc = cli.main([fasta, "-m", measure, "--backend", backend,
                           "-o", outs[backend]])
            check(rc == 0, f"{measure} --backend {backend} exited {rc}")
            print(f"[4] {measure} --backend {backend}:"
                  f" {time.perf_counter() - t0:.3f} s")
        with open(outs["cuda"], "rb") as a, open(outs["torch"], "rb") as b:
            check(a.read() == b.read(),
                  f"{measure}: cuda and torch TSVs differ")
        print(f"[4] {measure}: 256 x {sub.shape[1]} TSV byte-identical")


def phase_timing(bench: np.ndarray):
    """The kernel against its plain version at the main path's block
    shape (rows of the bench alignment, sites zero-padded to a multiple
    of 128 as the engine uploads them), for every measure: equal, and
    timed with CUDA events in turns (plain, kernel, kernel, plain).
    Returns raw's (kernel ms, plain ms) and the largest |kernel - plain|.
    """
    import torch

    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops.counters import counters_cuda, counters_torch
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch

    dev = torch.device("cuda", 0)
    l_pad = -(-bench.shape[1] // 128) * 128
    padded = np.zeros((2 * BLOCK, l_pad), dtype=np.uint8)
    padded[:, : bench.shape[1]] = bench[: 2 * BLOCK]
    x = torch.from_numpy(padded[:BLOCK]).to(dev)
    y = torch.from_numpy(padded[BLOCK:]).to(dev)
    pair_sites = BLOCK * BLOCK * bench.shape[1]

    def timed(fn, plan, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(x, y, plan)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    times = {}
    worst = 0
    for measure in MEASURES:
        plan = plan_to_torch(get_plan(measure), dev)
        got = counters_cuda(x, y, plan)
        torch.cuda.synchronize()
        err = int((got.long() - counters_torch(x, y, plan).long())
                  .abs().max())
        worst = max(worst, err)
        check(err == 0, f"{measure} {BLOCK} x {BLOCK} x {l_pad}: max"
                        f" |kernel - plain| = {err}")
        plain_ms, kern_ms = [], []
        for fn, reps, acc in ((counters_torch, 1, plain_ms),
                              (counters_cuda, 5, kern_ms),
                              (counters_cuda, 5, kern_ms),
                              (counters_torch, 1, plain_ms)):
            acc.append(timed(fn, plan, reps))
        ms_k, ms_p = float(np.mean(kern_ms)), float(np.mean(plain_ms))
        times[measure] = (ms_k, ms_p)
        print(f"[5] {measure} {BLOCK} x {BLOCK} x {l_pad}: kernel =="
              f" plain; kernel {kern_ms} ms, plain {plain_ms} ms; kernel"
              f" {pair_sites / ms_k / 1e9:.3f} T pair-sites/s")
    print(f"[5] timed on {gpu_line()}")
    return times["raw"][0], times["raw"][1], worst


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "distance_tpu_torch")):
        print("chip_smoke: distance_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_environment()
    t0 = time.perf_counter()
    bench = make_alignment(N_BENCH, L_BENCH, SEED)
    print(f"[2] bench alignment {bench.shape} made in"
          f" {time.perf_counter() - t0:.3f} s")
    max_err = phase_kernel_vs_plain(bench)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(tmp, bench)
    with tempfile.TemporaryDirectory() as tmp:
        phase_six_measures(tmp, bench)
    ms, plain_ms, err = phase_timing(bench)
    max_err = max(max_err, err)
    print(f"chip_smoke: all phases passed in"
          f" {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "counters",
        "route": "cuda",
        "source": "distance_tpu_torch/csrc/counters.cu",
        "replaces": "distance_tpu/ops/pairwise_pallas.py:110",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
