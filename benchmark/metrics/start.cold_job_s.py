"""Seconds of the cold job: from just before the process's first import
of the program (and torch) to the end of one whole job, its TSV written
into the harness's FIFO as the window's are.  What a user pays for each
invocation, less the interpreter's own start; it is part of set-up."""

LAYER = "start-up"
UNIT = "s"
MOVES = "setup_s"


def read(record: dict):
    return record.get("cold_job_s")
