"""Seconds a job of the phase timer ``load+encode``: parse and encode of
the loaded files (fastaio, _native, via engine.set_up)."""

from harness.tracing import per_job

LAYER = "parse and encode"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("load+encode",)


def read(record: dict):
    return per_job(record, PHASES)
