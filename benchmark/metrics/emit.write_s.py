"""Seconds a job of the writer's phase timers ``write:assemble`` and
``write:io``: rows formatted and assembled, and handed to the output.
(The square's outer ``write`` phase also holds the memo's finalize
callback, and the stream has none, so it is not read.)"""

from harness.tracing import per_job

LAYER = "emission"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("write:assemble", "write:io")


def read(record: dict):
    return per_job(record, PHASES)
