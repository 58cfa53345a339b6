"""Seconds a job of the phase timer ``dispatch``: the sweep's host time
queueing a strip's or a stream group's device work (``_Strip``, the
group's g features, the asynchronous fetch) in ``engine``."""

from harness.tracing import per_job

LAYER = "sweep"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("dispatch",)


def read(record: dict):
    return per_job(record, PHASES)
