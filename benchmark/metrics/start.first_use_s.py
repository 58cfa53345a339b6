"""The cold job less its import, less the median of the window's jobs:
the CUDA context, the kernel libraries' loads and first allocations."""

import statistics

LAYER = "start-up"
UNIT = "s"
MOVES = "setup_s"


def read(record: dict):
    walls = record.get("job_walls_s") or []
    if record.get("cold_job_s") is None or not walls:
        return None
    return (record["cold_job_s"] - record["import_s"]
            - statistics.median(walls))
