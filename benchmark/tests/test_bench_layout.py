"""The harness finds a cell's parts by name: a configuration, recipe,
traffic mix or metric dropped into a copy of the folders is found
without an edit of any file that is there."""

import json
import os

import pytest

from harness import layout

import run


def _add_cell(root, bench, cell):
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["workloads"].append(cell)
    spec["per_layer"].append(
        {"name": "extra.rows_per_job", "unit": "rows", "better": "higher",
         "source": "host_clock", "layer": "extra", "moves": "pairs_per_s",
         "workloads": [cell["name"]]})
    with open(path, "w") as f:
        json.dump(spec, f)


def test_new_files_are_found_by_name(tiny, tmp_path):
    bench = tiny.bench_dir
    with open(os.path.join(bench, "configs", "sarscov2-8k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny-rect", recipe="flat", loaded_records=5,
               streamed_records=9)
    with open(os.path.join(bench, "configs", "tiny-rect.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "recipes", "flat.py"), "w") as f:
        f.write("import numpy as np\n\n\ndef make(cfg, records, seed):\n"
                "    rng = np.random.default_rng(seed)\n"
                "    b = np.frombuffer(b'ACGT', np.uint8)\n"
                "    return rng.choice(b, size=(records, cfg['sites']))\n")
    with open(os.path.join(bench, "traffic", "rect-k80.json"), "w") as f:
        json.dump({"mode": "rectangle", "measure": "k80", "flags": [],
                   "env": {}, "check_rows": 1000}, f)
    with open(os.path.join(bench, "metrics", "extra.rows_per_job.py"),
              "w") as f:
        f.write('LAYER = "extra"\nUNIT = "rows"\nMOVES = "pairs_per_s"\n\n\n'
                'def read(record):\n    return float(record["work"]["pairs"])\n')
    root = str(tmp_path)
    _add_cell(root, bench, {"name": "rect-k80", "config": "tiny-rect",
                            "traffic": "rect-k80", "chips": 1, "why": "test"})
    lay = layout.Layout(bench, root)
    assert lay.config("tiny-rect")["loaded_records"] == 5
    assert lay.traffic("rect-k80")["mode"] == "rectangle"
    assert hasattr(lay.recipe("flat"), "make")
    assert [m["name"] for m in lay.per_layer("rect-k80")] == [
        "extra.rows_per_job"]
    r = run.run(lay, "rect-k80", 3, 0.2, True, backend="torch")
    assert r["correct"]
    assert r["metrics"]["extra.rows_per_job"]["value"] == 45.0
    r = run.run(lay, "rect-k80", 4, 0.2, False, backend="torch")
    assert r["correct"] and set(r["metrics"]) == {
        "pairs_per_s", "setup_s"}


def test_missing_part_raises(tiny):
    with pytest.raises(FileNotFoundError):
        tiny.metric("no.such_metric")
    with pytest.raises(KeyError):
        tiny.cell("no-such-cell")


def test_benchmark_json_matches_the_files():
    lay = layout.Layout()
    spec = lay.spec
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(layout.ROOT, c["file"]))
        assert lay.config(c["name"])["name"] == c["name"]
        for key in c["reduced"]:
            assert key in lay.config(c["name"])["reduced"]
    for w in spec["workloads"]:
        lay.traffic(w["traffic"])
        lay.recipe(lay.config(w["config"])["recipe"])
    for m in spec["per_layer"]:
        mod = lay.metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
            m["layer"], m["unit"], m["moves"])
