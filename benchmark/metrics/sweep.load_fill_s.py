"""Seconds a job of the phase ``load-fill``: an in-core square's or
rectangle's serial head, from the start of its sweep to its first strip's
hand-off to the emitter (``engine._sweep_load``; one total a job, added
by ``timing.add``).  A program without that phase gives nothing."""

from harness.tracing import per_job

LAYER = "sweep"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("load-fill",)


def read(record: dict):
    return per_job(record, PHASES)
