"""Seconds a job of the phase timer ``stream-parse-wait``: the sweep
waiting on the stream's parse threads (fastaio, _native)."""

from harness.tracing import per_job

LAYER = "parse and encode"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("stream-parse-wait",)


def read(record: dict):
    return per_job(record, PHASES)
