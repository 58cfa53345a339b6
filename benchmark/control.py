#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the program's
place and computed one step below the precision the configuration
states, judged by the same comparison as the program's TSV.

    python3 benchmark/control.py --workload sq8k-raw --seeds 11 12 13

For each seed it makes the cell's inputs as a run does and prints one
JSON line with the control's ``rows_wrong`` over the lines a run
compares.  The float measures' control evaluates their closed forms in
float32; n and n_high state integer counts, for which a narrower integer
changes nothing at these sizes, so their control breaks the stated
guarantee instead and counts every byte that differs, blind to ambiguity
codes, N and gaps.  It needs no card and never runs the program.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from harness import inputs, layout  # noqa: E402
from reference.distances import expected_lines  # noqa: E402


def control_reading(lay: layout.Layout, name: str, seed: int) -> dict:
    tmp = tempfile.mkdtemp(prefix="distance-control-")
    try:
        job = inputs.build(lay, lay.cell(name), seed, tmp)
        t0 = time.perf_counter()
        lines = job.lines.tolist()
        want = expected_lines(job.measure, job.mode, job.paths, lines)
        got = expected_lines(job.measure, job.mode, job.paths, lines,
                             control=True)
        return {"workload": name, "seed": seed, "rows_compared": len(want),
                "rows_wrong": sum(got[k] != v for k, v in want.items()),
                "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    lay = layout.Layout()
    for seed in args.seeds:
        print(json.dumps(control_reading(lay, args.workload, seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
