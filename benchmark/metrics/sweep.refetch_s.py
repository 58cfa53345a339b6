"""Seconds a job of the phase timer ``refetch``: a saturated strip's
redispatch at the next rung of the pack ladder, its wait and its unpack
(inside ``finish``).  A program without the span gives nothing."""

from harness.tracing import per_job

LAYER = "sweep"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("refetch",)


def read(record: dict):
    return per_job(record, PHASES)
