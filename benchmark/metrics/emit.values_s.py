"""Seconds a job of the phase timers ``keys`` and ``finalize``: the keyed
memo and the float64 closed forms (emit, finalize)."""

from harness.tracing import per_job

LAYER = "emission"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("keys", "finalize")


def read(record: dict):
    return per_job(record, PHASES)
