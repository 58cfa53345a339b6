"""Finds a cell's parts by name.

``BENCHMARK.json`` at the repository's root names the cells; each names
a configuration (``configs/<name>.json``, whose ``recipe`` names
``recipes/<recipe>.py``) and a traffic mix (``traffic/<name>.json``);
each per-layer metric is ``metrics/<name>.py``.  Adding any of them is
adding files and entries: nothing here lists them.
"""

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str) -> ModuleType:
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Layout:
    """The benchmark's files under ``bench_dir``, with ``BENCHMARK.json``
    at ``root``."""

    def __init__(self, bench_dir: str = BENCH_DIR, root: str = ROOT):
        self.bench_dir = bench_dir
        self.spec = _json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(os.path.join(self.bench_dir, "configs", f"{name}.json"))

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.bench_dir, "traffic", f"{name}.json"))

    def recipe(self, name: str) -> ModuleType:
        return _module(os.path.join(self.bench_dir, "recipes", f"{name}.py"),
                       f"bench_recipe_{name}")

    def metric(self, name: str) -> ModuleType:
        return _module(os.path.join(self.bench_dir, "metrics", f"{name}.py"),
                       f"bench_metric_{name.replace('.', '_')}")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    def metric_units(self) -> Dict[str, str]:
        return {m["name"]: m["unit"]
                for m in self.spec["end_to_end"] + self.spec["per_layer"]}
