"""The readers of the sweep's, emission's and stream producer's new
phases on a sample whose numbers are worked by hand (a square job and a
stream job), and in a traced run of the harness on the CPU."""

import json
import os

import pytest

from harness import layout

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SWEEP = ("sweep.dispatch_s", "sweep.fetch_wait_s", "sweep.finish_s",
         "emit.sweep_wait_s")
STREAM = ("parse.stream_produce_s",)


def _load(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def record():
    return _load("phase_record_sample.json")


def _read(name, record):
    return layout.Layout().metric(name).read(record)


@pytest.mark.parametrize("name, want", [
    ("sweep.dispatch_s", (0.1 + 0.2) / 2),
    ("sweep.fetch_wait_s", (0.3 + 0.2) / 2),
    ("sweep.finish_s", (0.2 + 0.3) / 2),
    ("emit.sweep_wait_s", (0.7 + 0.8 + 0.3) / 2),
    # the square has no producer: it counts as 0 s in the mean
    ("parse.stream_produce_s", (0.0 + 0.4) / 2),
])
def test_reader(record, name, want):
    assert _read(name, record) == pytest.approx(want)


@pytest.mark.parametrize("name", SWEEP + STREAM)
def test_reader_finds_nothing_in_a_record_without_them(name):
    """The record of a program without these phases (record_sample.json)
    gives nothing, and raises nothing."""
    assert _read(name, _load("record_sample.json")) is None


@pytest.mark.parametrize("cell", ["sq8k-raw", "stream2k-raw"])
def test_a_traced_run_reports_them(tiny, cell):
    """run.py's traced run on the CPU reports each new metric its cell
    lists, read from the window's phase totals."""
    import run

    result = run.run(tiny, cell, 2**31 + 11, 0.5, True, backend="torch")
    assert result["correct"]
    want = set(SWEEP) | (set(STREAM) if cell.startswith("stream") else set())
    assert want <= set(result["metrics"])
    assert all(result["metrics"][m]["value"] >= 0 for m in want)
