#!/usr/bin/env python3
"""One run of one benchmark cell of distance_tpu_torch on the card.

    python3 benchmark/run.py --workload sq8k-raw --seed 7 --seconds 10 --trace 0

A run builds the program's kernels if the checkout has none yet, makes
the cell's FASTA inputs from the seed under TMPDIR, then times a cold
job: the first import of ``distance_tpu_torch`` (and torch) and one
whole ``distance_tpu_torch.cli.main`` job with ``--backend cuda``.  That
is set-up (``setup_s``).  The window runs the same job back to back for
``--seconds`` (the job in flight finishes).  Every job writes its TSV
into a FIFO that a process of the harness drains.  Then the plain NumPy
reference judges the chosen lines of every job's TSV, and the last line
of standard output is the result as one JSON object.  ``--trace 1``
profiles the window and reports the per-layer metrics instead of the
end-to-end ones.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when JAX or the JAX package was loaded.
"""

import argparse
import contextlib
import gc
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

T_START = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import counts, inputs, layout, roofline, tracing, tsvcheck  # noqa: E402
from reference.distances import expected_lines  # noqa: E402

# Top-level module names that may not be loaded once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "distance_tpu")
# Builds every csrc/*.cu and the native host library in a process of its
# own, so that this one first imports the program inside the cold job.
BUILD = """
import concurrent.futures, glob, os, sys
from distance_tpu_torch.ops import _build
from distance_tpu_torch import _native
names = sorted(os.path.basename(p)[:-3]
               for p in glob.glob(os.path.join(_build.CSRC, "*.cu")))
with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
    list(ex.map(_build.build, names))
if _native.get_lib() is None:
    sys.exit("the native host library did not build")
"""
DRAIN_WAIT_S = 120.0


class NoCard(Exception):
    """No CUDA card, or fewer than the cell asks for."""


class Forbidden(Exception):
    """JAX or the JAX package was loaded in the measuring process."""


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line(chips: int) -> str:
    """nvidia-smi's name and power limit of the first card, before torch
    is loaded; raises NoCard without the tool or enough cards."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NoCard(f"nvidia-smi: {e}") from None
    cards = [ln for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or len(cards) < chips:
        raise NoCard(f"nvidia-smi lists {len(cards)} card(s), the cell asks"
                     f" for {chips}: {out.stderr.strip()}")
    return cards[0].strip()


def build_program() -> None:
    proc = subprocess.run([sys.executable, "-c", BUILD], cwd=ROOT,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the program failed:\n{proc.stderr}"
                           f"{proc.stdout}")


def forbidden_modules() -> list:
    """Loaded modules of those names (an entry set to None only blocks an
    import)."""
    return sorted(m for m, mod in list(sys.modules.items())
                  if mod is not None and m.split(".")[0] in FORBIDDEN)


def call(cli, argv: list) -> int:
    """One CLI job; an exception is the job's failure, not the run's."""
    try:
        return cli.main(argv)
    except Exception:
        traceback.print_exc()
        return 1


def wait_seen(drain, rc: int):
    """The drained TSV of the job just run (None if it never came)."""
    if rc != 0:
        gc.collect()  # closes an output the failed job left open
    try:
        seen = drain.results.get(timeout=DRAIN_WAIT_S if rc == 0 else 5.0)
    except queue.Empty:
        return None
    if isinstance(seen, Exception):
        log(f"the drain failed: {seen!r}")
        return None
    return seen


def run(lay: layout.Layout, name: str, seed: int, seconds: float,
        trace: bool, backend: str = "cuda") -> dict:
    """One run of cell ``name``; returns the result object with the
    checks under ``checks``, last.  ``backend="torch"`` skips the card
    and the build: the CPU tests drive the harness so."""
    cell = lay.cell(name)
    chips = int(cell["chips"])
    card = card_line(chips) if backend == "cuda" else "no card (CPU)"
    if backend == "cuda":
        build_program()
    tmp = tempfile.mkdtemp(prefix="distance-bench-")
    try:
        return _run(lay, cell, seed, seconds, trace, backend, chips, card,
                    tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(lay, cell, seed, seconds, trace, backend, chips, card, tmp):
    job = inputs.build(lay, cell, seed, tmp)
    os.environ.update(job.env)
    log(f"{cell['name']}: {job.mode} -m {job.measure}, {job.n1} x {job.n2}"
        f" records of {job.chars.shape[1]} sites, {job.rows} rows a job;"
        f" inputs in {time.perf_counter() - T_START:.3f} s since start")

    # Every job's TSV goes into a FIFO that the drain reads.
    fifo = os.path.join(tmp, "tsv.fifo")
    os.mkfifo(fifo)
    drain = tsvcheck.Drain(fifo, job.lines)
    drain.start()
    try:
        # The cold job: the program's first import, then one whole job.
        t_cold = time.perf_counter()
        import torch

        from distance_tpu_torch import cli, engine  # noqa: F401
        from distance_tpu_torch.utils import timing
        import_s = time.perf_counter() - t_cold
        cuda = backend == "cuda"
        if cuda and not (torch.cuda.is_available()
                         and torch.cuda.device_count() >= chips):
            raise NoCard(f"torch sees {torch.cuda.device_count()} CUDA"
                         f" device(s), the cell asks for {chips}")
        argv = job.argv + ["-o", fifo, "--backend", backend]
        before = counts.read()
        rc_cold = call(cli, argv)
        if cuda:
            torch.cuda.synchronize()
        cold_job_s = time.perf_counter() - t_cold
        log(f"cold job: exit {rc_cold}, {cold_job_s:.4f} s (import"
            f" {import_s:.4f} s); counts"
            f" {counts.delta(before, counts.read())}")
        cold = wait_seen(drain, rc_cold)

        spans = tracing.PhaseSpans() if trace else None
        prof: dict = {}
        walls, rcs, phases, window = [], [rc_cold], [], []
        before = counts.read()
        w0 = time.perf_counter()
        setup_s = w0 - T_START
        if rc_cold == 0:
            if spans is not None:
                spans.install()
            with (tracing.profiled(prof) if trace
                  else contextlib.nullcontext()):
                w0 = time.perf_counter()
                while True:
                    timing.reset()
                    j0 = time.perf_counter()
                    rc = call(cli, argv)
                    if cuda:
                        torch.cuda.synchronize()
                    j1 = time.perf_counter()
                    walls.append(j1 - j0)
                    phases.append(timing.totals())
                    rcs.append(rc)
                    window.append(wait_seen(drain, rc))
                    if rc != 0 or j1 - w0 >= seconds:
                        break
            w1 = j1
            if spans is not None:
                spans.remove()
        else:
            w1 = w0
    finally:
        drain.stop()
    window_counts = counts.delta(before, counts.read())
    peak = 0
    kind = "cpu"
    if cuda:
        kind = torch.cuda.get_device_name(0)
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(torch.cuda.device_count()))
    bad = forbidden_modules()
    if bad:
        raise Forbidden(f"loaded in the measuring process: {bad}")
    log(f"window: {len(walls)} jobs in {w1 - w0:.4f} s, walls"
        f" {[round(w, 4) for w in walls]}; counts {window_counts}")

    # The check, with the program's state freed first.
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    expected = expected_lines(job.measure, job.mode, job.paths,
                              job.lines.tolist())
    checks, failed = tsvcheck.judge(expected, job.rows, cold, window, rcs)
    log(f"reference: {len(expected)} lines in"
        f" {time.perf_counter() - t_ref:.3f} s")

    done = sum(rc == 0 for rc in rcs[1:])
    units = lay.metric_units()
    metrics = {}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(rcs), "failed": failed}
    if not trace:
        values = {"pairs_per_s": job.rows * done / (w1 - w0) if done else 0.0,
                  "setup_s": setup_s}
        for m in lay.end_to_end(cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    else:
        red = tracing.reduce(prof.get("device", []), spans.spans, w0, w1)
        record = {"import_s": import_s, "cold_job_s": cold_job_s,
                  "job_walls_s": walls, "phases": phases,
                  "trace": dict(red, jobs=done),
                  "work": {"measure": job.measure, "pairs": job.rows,
                           "records": job.chars.shape[0],
                           "variable_sites":
                               roofline.variable_sites(job.chars)}}
        log("record: " + json.dumps(record))
        for m in lay.per_layer(cell["name"]):
            v = lay.metric(m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        device.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result["breakdown"] = red["breakdown"]
        log(f"counter kernels {red['counter_kernel_s']:.6f} s over {done}"
            f" jobs; variable sites {record['work']['variable_sites']};"
            f" peaks: int8 {roofline.PEAK_INT8_OPS:.4g} op/s, memory"
            f" {roofline.PEAK_BYTES:.4g} B/s; card {card}")
    result.update(metrics=metrics, device=device)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(layout.Layout(), args.workload, args.seed, args.seconds,
                     bool(args.trace))
    except NoCard as e:
        log(f"no result: {e}")
        return 2
    except Forbidden as e:
        log(f"no result: {e}")
        return 3
    for k, v in result["checks"].items():
        log(f"{k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
