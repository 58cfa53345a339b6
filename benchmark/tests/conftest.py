"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's
folders whose configurations are cut to a few dozen records of a few
hundred sites, so that the harness runs end to end on the CPU with the
program's plain PyTorch backend."""

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"records": 40, "loaded_records": 7, "streamed_records": 30,
        "sites": 300, "mutations_per_record": 5, "ambiguous_share": 0.05}
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    _SPEC = json.load(_f)
# The traffic mix kept for a later cell (PERF.md, Open questions) is run
# here as one more cell of the tiny copy.
KEPT = {"name": "sq8k-tn93", "config": "sarscov2-8k",
        "traffic": "square-tn93", "chips": 1, "why": "kept mix"}
CELLS = tuple(w["name"] for w in _SPEC["workloads"]) + (KEPT["name"],)


def tiny_copy(dest: str) -> str:
    """A copy of the benchmark (``dest/benchmark``, ``dest/BENCHMARK.json``)
    with every configuration cut to TINY's sizes; returns the copy's
    benchmark folder."""
    bench = os.path.join(dest, "benchmark")
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(dict(_SPEC, workloads=_SPEC["workloads"] + [KEPT]), f)
    cdir = os.path.join(bench, "configs")
    for name in os.listdir(cdir):
        path = os.path.join(cdir, name)
        with open(path) as f:
            cfg = json.load(f)
        cfg.update({k: v for k, v in TINY.items() if k in cfg})
        with open(path, "w") as f:
            json.dump(cfg, f)
    return bench


@pytest.fixture
def tiny(tmp_path):
    from harness import layout

    bench = tiny_copy(str(tmp_path))
    return layout.Layout(bench, str(tmp_path))
