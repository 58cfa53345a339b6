#!/usr/bin/env python3
"""Smoke run of distance_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the counter kernel from
``distance_tpu_torch/csrc``, holds it against its plain PyTorch version,
drives the port's CLI on SARS-CoV-2-scale synthetic alignments made from
a seed (29904 sites) in its three modes, checks the output, and times the
kernel beside the plain version.  Phases:

1. environment: the card, torch, CUDA, nvcc; build the kernel;
2. the kernel against its plain version, exactly, for all six measures
   at ragged shapes, the stream's narrow widths (1, 3 and 129 sites), an
   empty side, a 512 x 512 block of the bench alignment and the stream
   phase's launches (2000 loaded rows against groups of 8000 and 384
   rows, sites padded as the engine uploads them);
3. the square path: the CLI on the 8192 x 29904 alignment, ``-m raw
   --backend cuda``; line count, 1200 random rows against the host
   oracle, and the kernel's launch count in that run;
4. all six measures end to end at 256 x 29904: ``--backend cuda`` and
   ``--backend torch`` write identical bytes;
5. the kernel against its plain version at the square path's block
   shape (2048 x 2048 x 29952 padded sites) for all six measures, both
   timed on the card; raw's times go into the result line;
6. the rectangle path: the CLI on 4096 x 8192 x 29904 (two files cut
   from one alignment), ``-m raw``; line count, 1200 random rows, launch
   count, and a ``torch.profiler`` split of a second run's device time
   into the kernel, H2D and D2H;
7. the stream path: 2000 loaded x 16384 streamed x 29904 with ``-b
   1000``, ``-m raw``: groups of 8000, 8000 and 384 records, so group
   ends are ragged and a pinned buffer is refilled; line count, 1200
   random rows, one launch per group, and the profiler split;
8. all six measures, ``--backend cuda`` against ``--backend torch``:
   identical bytes for a 128 x 256 rectangle and a 128-loaded x
   300-streamed stream with ``-b 7``.

Any failed check raises, and the script exits non-zero without a result.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches per path, errors and times.
Without a CUDA device, or without the package beside it, it fails.

    python3 chip_smoke.py --measure

builds the kernel and measures instead of checking: the rectangle and
the stream above for each of the six measures, the stream with ``-b 1``
and ``-b 100``, and a stream of 131072 records (wall, host phase totals
and the profiler split).
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
N_RECT = (4096, 8192)
N_STREAM = (2000, 16384)
STREAM_BATCH = 1000
# The groups the stream phase forms: whole -b batches, up to the engine's
# cap of 8192 records a group (the card's budget allows more).
STREAM_GROUPS = (8000, 8000, 384)
N_STREAM_LONG = 131072
SAMPLES = 1200


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


def write_fasta(path: str, mat: np.ndarray, prefix: str = "seq") -> list:
    from distance_tpu_torch.encoding import CODE_TO_CHAR

    decode = np.zeros(256, dtype=np.uint8)
    for code, ch in CODE_TO_CHAR.items():
        decode[code] = ord(ch)
    ids = [f"{prefix}{i}" for i in range(mat.shape[0])]
    chars = decode[mat]
    with open(path, "wb") as f:
        for rid, row in zip(ids, chars):
            f.write(b">" + rid.encode() + b"\n" + row.tobytes() + b"\n")
    return ids


def read_tsv(path: str, n_lines: int):
    """The TSV's bytes and the offsets of its newlines, once its line
    count and header are checked."""
    with open(path, "rb") as f:
        data = f.read()
    nl = np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == 10)
    check(len(nl) == n_lines, f"TSV has {len(nl)} lines, expected {n_lines}")
    check(data[: nl[0]] == b"sequence1\tsequence2\tdistance",
          "TSV header differs")
    return data, nl


def tsv_line(data: bytes, nl: np.ndarray, k: int) -> str:
    """Line k of the TSV, the header being line 0."""
    return data[nl[k - 1] + 1 : nl[k]].decode()


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

    l_pad = -(-bench.shape[1] // 128) * 128
    loaded = np.zeros((N_STREAM[0], l_pad), dtype=np.uint8)
    loaded[:, : bench.shape[1]] = bench[: N_STREAM[0]]
    stream_cases = []
    for rows in sorted(set(STREAM_GROUPS)):
        group = np.zeros((rows, l_pad), dtype=np.uint8)
        group[:, : bench.shape[1]] = bench[-rows:]
        stream_cases.append((f"stream {N_STREAM[0]}x{rows}x{l_pad}", loaded,
                             group))
    cases = [
        ("13x7x200", codes(13, 200), codes(7, 200)),
        ("130x257x1000", codes(130, 1000), codes(257, 1000)),
        ("2000x383x1", codes(2000, 1), codes(383, 1)),
        ("77x1001x3", codes(77, 3), codes(1001, 3)),
        ("129x65x129", codes(129, 129), codes(65, 129)),
        ("0x5x128", codes(0, 128), codes(5, 128)),
        ("6x0x128", codes(6, 128), codes(0, 128)),
        ("bench 512x512x29904", bench[:512], bench[512:1024]),
        *stream_cases,
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


def run_cli(tag: str, args: list, measure: str = "raw") -> tuple:
    """One CLI run with --backend cuda: (wall s, kernel launches), after
    printing the host phase totals."""
    from distance_tpu_torch import cli
    from distance_tpu_torch.ops import counters as kernels
    from distance_tpu_torch.utils import timing

    timing.reset()
    kernels.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(args + ["-m", measure, "--backend", "cuda"])
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES
    check(rc == 0, f"{tag} exited {rc}")
    check(launches > 0, f"{tag} launched no counter kernel")
    print(f"{tag} host phase totals (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(timing.totals().items())))
    return wall, launches


def phase_main_path(tmp: str, bench: np.ndarray) -> int:
    """The CLI at the bench shape; returns the kernel launches of the run."""
    from distance_tpu_torch import measures
    from distance_tpu_torch.writer import format_float

    n = bench.shape[0]
    fasta = os.path.join(tmp, "bench.fasta")
    out = os.path.join(tmp, "bench_raw.tsv")
    t0 = time.perf_counter()
    ids = write_fasta(fasta, bench)
    print(f"[3] wrote {n} x {bench.shape[1]} FASTA in"
          f" {time.perf_counter() - t0:.3f} s")
    wall, launches = run_cli("[3]", [fasta, "-o", out])
    pairs = n * (n - 1) // 2
    print(f"[3] main path: {pairs} pairs in {wall:.3f} s ="
          f" {pairs / wall:.6e} pairs/s end to end, {launches} kernel"
          f" launches ({gpu_line()})")

    data, nl = read_tsv(out, 1 + pairs)
    rng = np.random.default_rng(SEED + 2)
    ii = rng.integers(0, n - 1, size=SAMPLES)
    jj = ii + 1 + (rng.random(SAMPLES) * (n - 1 - ii)).astype(np.int64)
    for i, j in zip(ii.tolist(), jj.tolist()):
        k = 1 + i * (2 * n - i - 1) // 2 + (j - i - 1)
        want = (f"{ids[i]}\t{ids[j]}\t"
                f"{format_float(measures.raw(bench[i], bench[j]))}")
        check(tsv_line(data, nl, k) == want, f"row ({i}, {j}):"
              f" {tsv_line(data, nl, k)!r} != {want!r}")
    print(f"[3] {1 + pairs} lines; {SAMPLES} random rows equal the host"
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


def write_inputs(tmp: str, tag: str, n1: int, n2: int, seed: int,
                 prefix2: str) -> tuple:
    """Two FASTA files cut from one alignment, so they share ancestry as
    real inputs do: (alignment, ids1, ids2, path1, path2)."""
    t0 = time.perf_counter()
    mat = make_alignment(n1 + n2, L_BENCH, seed)
    f1 = os.path.join(tmp, "a.fasta")
    f2 = os.path.join(tmp, f"{prefix2}.fasta")
    ids1 = write_fasta(f1, mat[:n1], "a")
    ids2 = write_fasta(f2, mat[n1:], prefix2)
    print(f"{tag} wrote {n1} + {n2} x {L_BENCH} FASTA in"
          f" {time.perf_counter() - t0:.3f} s")
    return mat, ids1, ids2, f1, f2


def device_split(prof) -> dict:
    """Device time (us) of a profiled run by kind, and the union of the
    device's busy intervals."""
    from torch.autograd import DeviceType

    split = {"K1": 0.0, "H2D": 0.0, "D2H": 0.0, "other": 0.0}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        spans.append((t0, t1))
        kind = ("K1" if "counters_kernel" in ev.name
                else "H2D" if "HtoD" in ev.name
                else "D2H" if "DtoH" in ev.name else "other")
        split[kind] += t1 - t0
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    split["busy"] = busy
    return split


def profiled_run(tag: str, args: list) -> None:
    """One more ``-m raw`` CLI run under torch.profiler: its device time
    split into the kernel, H2D and D2H, and the device's busy share of
    the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distance_tpu_torch import cli

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(args + ["-m", "raw", "--backend", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"{tag} profiled run exited {rc}")
    split = device_split(prof)
    check(split["K1"] > 0, f"{tag} the profiler saw no counter kernel")
    total = sum(v for k, v in split.items() if k != "busy")
    print(f"{tag} profiled run: wall {wall:.3f} s; device time (ms):"
          f" K1 {split['K1'] / 1e3:.3f}, H2D {split['H2D'] / 1e3:.3f},"
          f" D2H {split['D2H'] / 1e3:.3f}, other {split['other'] / 1e3:.3f};"
          f" H2D share of device time {split['H2D'] / total:.4f}; device"
          f" busy {split['busy'] / 1e6:.3f} s ="
          f" {split['busy'] / 1e6 / wall:.4f} of the wall ({gpu_line()})")


def phase_rectangle(tmp: str) -> int:
    """The CLI on two files cut from one alignment; returns the kernel
    launches of the run."""
    from distance_tpu_torch import measures
    from distance_tpu_torch.writer import format_float

    n1, n2 = N_RECT
    mat, ids1, ids2, f1, f2 = write_inputs(tmp, "[6]", n1, n2, SEED + 3, "b")
    args = [f1, f2, "-o", os.path.join(tmp, "rect.tsv")]
    wall, launches = run_cli("[6]", args)
    pairs = n1 * n2
    print(f"[6] rectangle: {pairs} pairs in {wall:.3f} s ="
          f" {pairs / wall:.6e} pairs/s end to end, {launches} kernel"
          f" launches ({gpu_line()})")
    data, nl = read_tsv(args[-1], 1 + pairs)
    rng = np.random.default_rng(SEED + 4)
    for i, j in zip(rng.integers(0, n1, SAMPLES).tolist(),
                    rng.integers(0, n2, SAMPLES).tolist()):
        want = (f"{ids1[i]}\t{ids2[j]}\t"
                f"{format_float(measures.raw(mat[i], mat[n1 + j]))}")
        got = tsv_line(data, nl, 1 + i * n2 + j)
        check(got == want, f"rectangle row ({i}, {j}): {got!r} != {want!r}")
    print(f"[6] {1 + pairs} lines; {SAMPLES} random rows equal the host"
          " oracle")
    del data
    profiled_run("[6]", args)
    return launches


def phase_stream(tmp: str) -> int:
    """The CLI streaming records against a loaded file, both cut from one
    alignment; returns the kernel launches of the run."""
    from distance_tpu_torch import measures
    from distance_tpu_torch.writer import format_float

    n1, n2 = N_STREAM
    check(sum(STREAM_GROUPS) == n2, "STREAM_GROUPS do not cover the stream")
    mat, ids1, ids2, f1, f2 = write_inputs(tmp, "[7]", n1, n2, SEED + 5, "s")
    args = [f1, "-s", f2, "-b", str(STREAM_BATCH),
            "-o", os.path.join(tmp, "stream.tsv")]
    wall, launches = run_cli("[7]", args)
    check(launches == len(STREAM_GROUPS),
          f"{launches} stream launches, expected one for each of the groups"
          f" {STREAM_GROUPS}")
    pairs = n1 * n2
    print(f"[7] stream: {pairs} pairs in {wall:.3f} s ="
          f" {pairs / wall:.6e} pairs/s end to end, groups {STREAM_GROUPS},"
          f" {launches} kernel launches ({gpu_line()})")
    data, nl = read_tsv(args[-1], 1 + pairs)
    rng = np.random.default_rng(SEED + 6)
    for i, r in zip(rng.integers(0, n1, SAMPLES).tolist(),
                    rng.integers(0, n2, SAMPLES).tolist()):
        want = (f"{ids1[i]}\t{ids2[r]}\t"
                f"{format_float(measures.raw(mat[i], mat[n1 + r]))}")
        got = tsv_line(data, nl, 1 + r * n1 + i)
        check(got == want, f"stream pair ({i}, {r}): {got!r} != {want!r}")
    print(f"[7] {1 + pairs} lines; {SAMPLES} random rows equal the host"
          " oracle")
    del data
    profiled_run("[7]", args)
    return launches


def phase_cuda_vs_torch(tmp: str, bench: np.ndarray) -> None:
    from distance_tpu_torch import cli
    from distance_tpu_torch.measures import MEASURES

    fa, fb, fs = (os.path.join(tmp, f"{k}.fasta") for k in "abs")
    write_fasta(fa, bench[:128], "a")
    write_fasta(fb, bench[128:384], "b")
    write_fasta(fs, bench[384:684], "s")
    modes = {"rectangle 128 x 256": [fa, fb],
             "stream 128 x 300 -b 7": [fa, "-s", fs, "-b", "7"]}
    for measure in MEASURES:
        for mode, args in modes.items():
            outs = {}
            for backend in ("cuda", "torch"):
                outs[backend] = os.path.join(tmp, f"{backend}.tsv")
                rc = cli.main(args + ["-m", measure, "--backend", backend,
                                      "-o", outs[backend]])
                check(rc == 0, f"{measure} {mode} --backend {backend}"
                               f" exited {rc}")
            with open(outs["cuda"], "rb") as a, open(outs["torch"], "rb") as b:
                check(a.read() == b.read(),
                      f"{measure} {mode}: cuda and torch TSVs differ")
        print(f"[8] {measure}: cuda and torch TSVs byte-identical for the"
              f" {' and the '.join(modes)}")


def measure_mode() -> None:
    """Walls and host phase totals of the rectangle and the stream for
    each measure and batch size, and of a longer stream; no checks."""
    from distance_tpu_torch.measures import MEASURES

    def timed(tag, args, pairs, measure="raw"):
        wall, launches = run_cli(tag, args, measure)
        print(f"{tag}: {pairs} pairs in {wall:.3f} s = {pairs / wall:.6e}"
              f" pairs/s, {launches} kernel launches")

    n1, n2 = N_RECT
    with tempfile.TemporaryDirectory() as tmp:
        _, _, _, f1, f2 = write_inputs(tmp, "[m]", n1, n2, SEED + 3, "b")
        for measure in MEASURES:
            timed(f"[m] rectangle {measure}",
                  [f1, f2, "-o", os.path.join(tmp, "o.tsv")], n1 * n2,
                  measure)
    for n1, n2 in (N_STREAM, (N_STREAM[0], N_STREAM_LONG)):
        with tempfile.TemporaryDirectory() as tmp:
            _, _, _, f1, f2 = write_inputs(tmp, "[m]", n1, n2, SEED + 5,
                                           "s")
            args = [f1, "-s", f2, "-o", os.path.join(tmp, "o.tsv")]
            tag = f"[m] stream {n1} x {n2}"
            if n2 == N_STREAM_LONG:
                timed(f"{tag} raw -b {STREAM_BATCH}",
                      args + ["-b", str(STREAM_BATCH)], n1 * n2)
                profiled_run(tag, args + ["-b", str(STREAM_BATCH)])
                continue
            for measure in MEASURES:
                timed(f"{tag} {measure} -b {STREAM_BATCH}",
                      args + ["-b", str(STREAM_BATCH)], n1 * n2, measure)
            for batch in (1, 100):
                timed(f"{tag} raw -b {batch}", args + ["-b", str(batch)],
                      n1 * n2)


def main(argv: list) -> int:
    if argv not in ([], ["--measure"]):
        print("usage: chip_smoke.py [--measure]", file=sys.stderr)
        return 2
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
    if argv:
        measure_mode()
        print(f"chip_smoke --measure: done in"
              f" {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    t0 = time.perf_counter()
    bench = make_alignment(N_BENCH, L_BENCH, SEED)
    print(f"[2] bench alignment {bench.shape} made in"
          f" {time.perf_counter() - t0:.3f} s")
    max_err = phase_kernel_vs_plain(bench)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        launches["square"] = phase_main_path(tmp, bench)
    with tempfile.TemporaryDirectory() as tmp:
        phase_six_measures(tmp, bench)
    ms, plain_ms, err = phase_timing(bench)
    max_err = max(max_err, err)
    with tempfile.TemporaryDirectory() as tmp:
        launches["rectangle"] = phase_rectangle(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        launches["stream"] = phase_stream(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cuda_vs_torch(tmp, bench)
    print(f"chip_smoke: all phases passed in"
          f" {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "counters",
        "route": "cuda",
        "source": "distance_tpu_torch/csrc/counters.cu",
        "replaces": "distance_tpu/ops/pairwise_pallas.py:110",
        "launches": sum(launches.values()),
        "paths": list(launches),
        "launches_by_path": launches,
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
    sys.exit(main(sys.argv[1:]))
