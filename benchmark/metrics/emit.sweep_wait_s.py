"""Seconds a job of the phase timers ``emit-submit-wait`` and
``emit-drain``: the sweep blocked on the emitter's full queue, and the
job's tail waiting for the last writes (``engine._AsyncEmitter``)."""

from harness.tracing import per_job

LAYER = "emission"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("emit-submit-wait", "emit-drain")


def read(record: dict):
    return per_job(record, PHASES)
