"""Seconds a job of the phase timer ``finish``: the packed host finish of
a fetched strip or stream group (``_finish_fetched``: the rel4, rel or
narrow unpack, the native rel4 finish, refetches after a saturation)."""

from harness.tracing import per_job

LAYER = "sweep"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("finish",)


def read(record: dict):
    return per_job(record, PHASES)
