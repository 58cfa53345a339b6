"""The reader of the stream's fill (``sweep.stream_fill_s``) on a sample
whose numbers are worked by hand, on a record of a program without the
phase, and in a traced run of the harness on the CPU."""

import json
import os

import pytest

from harness import layout

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
NAME = "sweep.stream_fill_s"


def _read(sample):
    with open(os.path.join(DATA, sample)) as f:
        return layout.Layout().metric(NAME).read(json.load(f))


def test_reader_takes_the_mean_over_the_jobs():
    # the square job has no fill: it counts as 0 s in the mean
    assert _read("fill_record_sample.json") == pytest.approx(
        (0.25 + 0.35 + 0.0) / 3)


@pytest.mark.parametrize("sample", ["record_sample.json",
                                    "phase_record_sample.json"])
def test_reader_finds_nothing_without_the_phase(sample):
    """The records of programs without the phase give nothing and raise
    nothing."""
    assert _read(sample) is None


def test_the_metric_is_listed_for_the_stream_cells():
    spec = layout.Layout().spec
    entry, = (m for m in spec["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["stream2k-raw", "stream2k-n"]
    assert (entry["layer"], entry["moves"]) == ("sweep", "pairs_per_s")


@pytest.mark.parametrize("cell", ["stream2k-raw", "stream2k-n"])
def test_a_traced_stream_run_reports_it(tiny, cell):
    """run.py's traced run on the CPU reports the fill of a stream cell."""
    import run

    result = run.run(tiny, cell, 2**31 + 29, 0.5, True, backend="torch")
    assert result["correct"]
    assert 0 < result["metrics"][NAME]["value"]
    assert result["metrics"][NAME]["unit"] == "s"


def test_a_traced_square_run_leaves_it_out(tiny):
    """The square cell does not list the metric."""
    import run

    result = run.run(tiny, "sq8k-raw", 2**31 + 31, 0.5, True,
                     backend="torch")
    assert result["correct"] and NAME not in result["metrics"]
