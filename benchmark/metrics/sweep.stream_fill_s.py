"""Seconds a job of the phase ``stream-fill``: a stream job's wait from the
start of its sweep to its first group's hand-off to the emitter
(``engine._run_stream``; one total a job, added by ``timing.add``).  A
program without that phase gives nothing."""

from harness.tracing import per_job

LAYER = "sweep"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("stream-fill",)


def read(record: dict):
    return per_job(record, PHASES)
