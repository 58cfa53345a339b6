"""Nothing the benchmark runs loads JAX or the JAX package, the
reference loads nothing of the program, and without a card the command
exits non-zero and prints no result."""

import ast
import glob
import json
import os
import subprocess
import sys
import types

import run

from conftest import BENCH_DIR, ROOT, tiny_copy

BLOCKED = ("jax", "jaxlib", "flax", "distance_tpu")

AFTER_RUN = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
from harness import layout
r = run.run(layout.Layout({bench!r}, {dest!r}), "stream2k-n", 3, 0.2, True,
            backend="torch")
assert r["correct"], r
print(json.dumps(sorted(m for m, v in sys.modules.items()
                        if v is not None and m.split(".")[0] in {blocked!r})))
"""


def test_no_jax_after_a_run(tmp_path):
    bench = tiny_copy(str(tmp_path))
    code = AFTER_RUN.format(bench=bench, root=ROOT, dest=str(tmp_path),
                            blocked=BLOCKED)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in ("numpy", "math", "typing",
                                              "reference"), (path, name)
    code = ("import sys; sys.path.insert(0, %r); import reference.distances;"
            " print(sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('distance_tpu_torch', 'distance_tpu', 'jax', 'torch')))"
            % BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    assert not [m for m in run.forbidden_modules()
                if m.split(".")[0] == "distance_tpu_torch"]
    monkeypatch.setitem(sys.modules, "distance_tpu_torch_fake",
                        types.ModuleType("distance_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxlib.fake",
                        types.ModuleType("jaxlib.fake"))
    monkeypatch.setitem(sys.modules, "distance_tpu", None)
    assert "jaxlib.fake" in run.forbidden_modules()
    assert "distance_tpu_torch_fake" not in run.forbidden_modules()
    assert "distance_tpu" not in run.forbidden_modules()


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sq8k-raw",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_without_a_card_no_result():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    out = _command(ROOT, env)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "memory_peak_bytes" not in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    tiny_copy(str(tmp_path))
    out = _command(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout == ""
