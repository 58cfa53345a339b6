"""Each per-layer metric's reader on a recorded sample, and the trace's
reduction on known events."""

import json
import os
import statistics

import pytest

from harness import layout, roofline, tracing

SAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "record_sample.json")


@pytest.fixture(scope="module")
def record():
    with open(SAMPLE) as f:
        return json.load(f)


def _read(name, record):
    return layout.Layout().metric(name).read(record)


def _per_job(record, *phases):
    return statistics.mean(sum(j.get(p, 0.0) for p in phases)
                           for j in record["phases"])


def test_start_up(record):
    assert _read("start.import_s", record) == record["import_s"]
    assert _read("start.cold_job_s", record) == record["cold_job_s"]
    assert _read("start.first_use_s", record) == pytest.approx(
        record["cold_job_s"] - record["import_s"]
        - statistics.median(record["job_walls_s"]))


def test_phase_readers(record):
    assert _read("parse.load_encode_s", record) == pytest.approx(
        _per_job(record, "load+encode"))
    assert _read("emit.values_s", record) == pytest.approx(
        _per_job(record, "keys", "finalize"))
    assert _read("emit.write_s", record) == pytest.approx(
        _per_job(record, "write:assemble", "write:io"))
    # a square records no stream phase: the reader finds nothing to read
    assert _read("parse.stream_wait_s", record) is None


def test_device_readers(record):
    t, w = record["trace"], record["work"]
    least = roofline.counter_least_s(w["pairs"], w["variable_sites"],
                                     w["records"], w["measure"])
    assert _read("kernels.counter_roofline", record) == pytest.approx(
        100 * least * t["jobs"] / t["counter_kernel_s"])
    assert 0 < _read("kernels.counter_roofline", record) < 100
    assert _read("device.idle_share", record) == pytest.approx(
        100 * (1 - t["busy_s"] / t["window_s"]))


def test_readers_find_nothing_without_a_trace(record):
    bare = dict(record, trace={"busy_s": 0, "window_s": 1.0,
                               "counter_kernel_s": 0, "jobs": 2})
    assert _read("kernels.counter_roofline", bare) is None
    assert _read("device.idle_share", bare) is None
    assert _read("emit.values_s", dict(record, phases=[])) is None


def test_reduce_busy_gaps_and_kernels():
    device = [("void (anonymous namespace)::contract_kernel<1>(Params)",
               1.0, 1.5),
              ("features_kernel<true>(Params)", 1.4, 1.6),
              ("Memcpy DtoH", 3.0, 3.1)]
    spans = [("load-sweep", "MainThread", 0.0, 4.0),
             ("write:io", "emitter", 1.7, 2.9),
             ("load+encode", "MainThread", 3.2, 3.9)]
    red = tracing.reduce(device, spans, 0.5, 4.0)
    assert red["busy_s"] == pytest.approx(0.7)
    assert red["window_s"] == pytest.approx(3.5)
    assert red["counter_kernel_s"] == pytest.approx(0.7)
    ops = dict(red["breakdown"]["device_ops"])
    assert ops["contract_kernel"] == pytest.approx(0.5)
    gaps = dict(red["breakdown"]["idle_gaps"])
    # three gaps: [0.5, 1.0) under load-sweep alone; [1.6, 3.0) under
    # load-sweep, with write:io over [1.7, 2.9); [3.1, 4.0) under
    # load-sweep, with load+encode innermost over [3.2, 3.9)
    assert gaps["load-sweep (x3)"] == pytest.approx(0.5 + 0.2 + 0.2)
    assert gaps["load-sweep | write:io (x1)"] == pytest.approx(1.2)
    assert gaps["load+encode (x1)"] == pytest.approx(0.7)
    assert sum(gaps.values()) == pytest.approx(3.5 - 0.7)
