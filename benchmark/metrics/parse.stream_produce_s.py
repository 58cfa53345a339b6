"""Seconds a job of the phase timer ``stream-produce``: the stream's read,
parse and encode of each batch on its producer thread, without the hand-
off to the sweep (``engine._produced`` over ``fastaio.stream_fasta``)."""

from harness.tracing import per_job

LAYER = "parse and encode"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("stream-produce",)


def read(record: dict):
    return per_job(record, PHASES)
