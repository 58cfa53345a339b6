"""Seconds a job of the phase timer ``fetch-wait``: the sweep blocked on a
strip's or a stream group's device-to-host copy (``_fetch_strip``)."""

from harness.tracing import per_job

LAYER = "sweep"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("fetch-wait",)


def read(record: dict):
    return per_job(record, PHASES)
