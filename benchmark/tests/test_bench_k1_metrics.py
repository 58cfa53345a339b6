"""The readers of the square past the g cache: ``sweep.load_fill_s`` (the
in-core sweep's serial head, phase ``load-fill``) and
``kernels.k1_roofline`` (K1's own share of its roofline) on a recorded
``sq16k-raw`` run, on records that lack what they read, and in traced
runs of the harness on the CPU."""

import copy
import json
import os

import pytest

from harness import layout

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FILL, K1 = "sweep.load_fill_s", "kernels.k1_roofline"


def _load(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def _read(name, record):
    return layout.Layout().metric(name).read(record)


@pytest.fixture(scope="module")
def record():
    return _load("k1_record_sample.json")


def test_load_fill_is_the_mean_over_the_jobs(record):
    fills = [1.3210354670000015, 1.097609896999984, 1.0561566129999846,
             1.1322250600001098, 1.142842900000005, 1.0927409050000279,
             1.0939558690001832]
    assert [j["load-fill"] for j in record["phases"]] == fills
    assert _read(FILL, record) == pytest.approx(sum(fills) / 7)


def test_k1_roofline_by_hand(record):
    # 134,209,536 pairs x 29,903 variable sites x 18 channels x 2
    # operations at 1979e12 int8 op/s: 0.0730054 s a job, 7 jobs, over
    # counters_kernel's 1.0000583 s of the window
    least = 2 * 134_209_536 * 29_903 * 18 / 1979e12
    assert least == pytest.approx(0.0730054, rel=1e-6)
    assert _read(K1, record) == pytest.approx(
        100 * least * 7 / 1.0000582739999118)
    assert 0 < _read(K1, record) < 100


def _without_k1(record):
    bare = copy.deepcopy(record)
    ops = bare["trace"]["breakdown"]["device_ops"]
    ops[:] = [op for op in ops if op[0] != "counters_kernel"]
    return bare


@pytest.mark.parametrize("name, sample", [
    (FILL, "record_sample.json"),
    (FILL, "phase_record_sample.json"),
    (FILL, "fill_record_sample.json"),
    (K1, "record_sample.json"),
    (K1, "no counters_kernel"),
    (K1, "no trace"),
])
def test_nothing_to_read_gives_none(record, name, sample):
    """Records of programs without the phase, or of windows in which
    counters_kernel did not run (the cached path's K5 and K6), give
    nothing and raise nothing."""
    if sample == "no counters_kernel":
        rec = _without_k1(record)
    elif sample == "no trace":
        rec = dict(record, trace=None)
    else:
        rec = _load(sample)
    assert _read(name, rec) is None


def test_the_metrics_list_their_cells():
    spec = layout.Layout().spec
    entries = {m["name"]: m for m in spec["per_layer"]}
    assert entries[FILL]["workloads"] == ["sq8k-raw", "sq16k-raw"]
    assert entries[K1]["workloads"] == ["sq16k-raw"]
    assert (entries[FILL]["layer"], entries[K1]["layer"]) == (
        "sweep", "kernels")
    assert {entries[FILL]["moves"], entries[K1]["moves"]} == {"pairs_per_s"}


@pytest.mark.parametrize("cell", ["sq8k-raw", "sq16k-raw"])
def test_a_traced_square_run_reports_the_fill(tiny, cell):
    """run.py's traced run on the CPU: the fill is read in both squares;
    the CPU's trace has no counters_kernel, so K1's share is left out."""
    import run

    result = run.run(tiny, cell, 2**31 + 37, 0.5, True, backend="torch")
    assert result["correct"]
    assert 0 < result["metrics"][FILL]["value"]
    assert result["metrics"][FILL]["unit"] == "s"
    assert K1 not in result["metrics"]
