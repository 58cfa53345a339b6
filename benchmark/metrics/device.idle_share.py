"""Percent of the traced window in which no operation ran on the card:
1 less the union of the profiler's device intervals over the window."""

LAYER = "device"
UNIT = "%"
MOVES = "pairs_per_s"


def read(record: dict):
    trace = record.get("trace")
    if not trace or trace.get("busy_s", 0) <= 0 or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
