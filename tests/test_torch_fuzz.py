"""The JAX differential fuzzer's config lattice through the port.

``scripts/fuzz_differential_torch.py`` holds a copy of the JAX fuzzer's
``one_config`` (pinned in ``test_torch_host_copies.py``) and runs the
port's engine under each configuration's knobs.  Each seed's
``--backend torch`` TSV must equal, byte for byte, the JAX fuzzer's own
``run_once(cfg, "numpy")`` (its source, run here without importing the
script, whose import sets ``XLA_FLAGS``) and, for the square and the
rectangle, the serial oracle.
"""

import ast
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distance_tpu.engine as jax_engine  # noqa: E402
import distance_tpu.fastaio as jax_fastaio  # noqa: E402
from distance_tpu.writer import TsvWriter  # noqa: E402
from tests.conftest import oracle_tsv  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEEDS = range(0, 60)


def load_port_fuzzer():
    spec = importlib.util.spec_from_file_location(
        "fuzz_differential_torch",
        ROOT / "scripts" / "fuzz_differential_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fuzz = load_port_fuzzer()


def jax_functions(*names, **namespace):
    """Functions of the JAX fuzzer, compiled from its source text into
    ``namespace``."""
    tree = ast.parse((ROOT / "scripts" / "fuzz_differential.py").read_text())
    nodes = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name in names]
    exec(compile(ast.Module(nodes, []), "fuzz_differential.py", "exec"),
         namespace)
    return [namespace[name] for name in names]


(jax_run_once,) = jax_functions(
    "run_once", io=io, Setup=jax_engine.Setup, run=jax_engine.run,
    load_fastas=jax_fastaio.load_fastas, consensus_fn=jax_fastaio.consensus,
    TsvWriter=TsvWriter)


@pytest.mark.parametrize("seed", SEEDS)
def test_lattice_seed_equals_jax_numpy_and_oracle(seed):
    cfg = fuzz.one_config(seed)
    f1, f2 = fuzz.fuzz_inputs(cfg)
    got = fuzz.run_with_knobs(cfg, "torch", f1, f2)
    want = jax_run_once(cfg, "numpy", f1, f2)
    assert got == want, cfg
    if cfg["mode"] in ("square", "rect"):
        handles = [io.BytesIO(f1)]
        if cfg["mode"] == "rect":
            handles.append(io.BytesIO(f2))
        loaded = jax_fastaio.load_fastas(handles)
        if cfg["measure"] == "tn93":
            for a in loaded:
                a.count_bases()
        ora = oracle_tsv(cfg["measure"], loaded[0],
                         loaded[1] if cfg["mode"] == "rect" else None)
        assert want == ora, cfg


def test_lattice_is_the_jax_fuzzers():
    """The copy draws the JAX fuzzer's configurations: every field equal,
    the device budget's default choice the port's default (0, the auto
    budget) where the JAX one draws its own."""
    (jax_one_config,) = jax_functions(
        "one_config", np=np, MEASURES=fuzz.MEASURES, TILES=fuzz.TILES,
        WIDTHS=fuzz.WIDTHS, STREAM_READ_DEFAULT=fuzz.STREAM_READ_DEFAULT,
        DEFAULTS=dict(HBM_BUDGET_BYTES=jax_engine.HBM_BUDGET_BYTES,
                      HOST_BUF_BUDGET=jax_engine.HOST_BUF_BUDGET,
                      FEATCACHE_BUDGET=jax_engine.FEATCACHE_BUDGET,
                      STAGED_ROWS_FLOOR=jax_engine.STAGED_ROWS_FLOOR))
    for seed in range(200):
        port, jax_cfg = fuzz.one_config(seed), jax_one_config(seed)
        if jax_cfg["hbm"] == jax_engine.HBM_BUDGET_BYTES:
            jax_cfg["hbm"] = fuzz.DEFAULTS["HBM_BUDGET_BYTES"]
        assert port == jax_cfg
    assert fuzz.DEFAULTS == dict(HBM_BUDGET_BYTES=0, HOST_BUF_BUDGET=4 << 30,
                                 FEATCACHE_BUDGET=8 << 30,
                                 STAGED_ROWS_FLOOR=256)


def test_fuzz_one_compares_knobs_with_the_plain_run(monkeypatch):
    """``fuzz_one`` runs the backend under the configuration's knobs and
    the plain configuration under the defaults, restoring the knobs."""
    runs = []
    real = fuzz.run_once

    def spy(cfg, backend, f1, f2):
        runs.append((backend, fuzz.engine.DEVICE_BUDGET,
                     fuzz.engine.FEATCACHE_BUDGET))
        return real(cfg, backend, f1, f2)

    monkeypatch.setattr(fuzz, "run_once", spy)
    seed = next(s for s in SEEDS if fuzz.one_config(s)["hbm"] == 5_000)
    ok, cfg, detail = fuzz.fuzz_one(seed, "torch")
    assert ok and detail == ""
    assert runs == [("torch", 5_000, cfg["featcache"]),
                    ("torch", 0, 8 << 30)]
    assert fuzz.engine.DEVICE_BUDGET == 0


def test_fuzzer_main_on_the_cpu(capsys):
    assert fuzz.main(["--backend", "torch", "--iters", "3",
                      "--seed-base", "7"]) == 0
    assert "PASS: 3 random configs" in capsys.readouterr().out
