"""Seconds a job of the unkeyed emission: the tn93 memo's bail-out
(the total ``keys-bail``: the memo's seconds up to it), the float64
closed forms of every pair (``finalize``) and the writer's unkeyed
formatting (``write:format``).  A program without the ``keys-bail``
total gives nothing."""

from harness.tracing import per_job

LAYER = "emission"
UNIT = "s"
MOVES = "pairs_per_s"
PHASES = ("keys-bail", "finalize", "write:format")


def read(record: dict):
    if not any("keys-bail" in j for j in record.get("phases") or []):
        return None
    return per_job(record, PHASES)
