"""Percent: the least time the traced jobs' counter work needs
(roofline.counter_least_s) over the profiler's device time of the
counter kernels (K5, K6 and its mix, K1) in those jobs."""

from harness.roofline import counter_least_s

LAYER = "kernels"
UNIT = "%"
MOVES = "pairs_per_s"


def read(record: dict):
    trace, work = record.get("trace"), record.get("work")
    if not trace or not work or trace.get("counter_kernel_s", 0) <= 0:
        return None
    least = counter_least_s(work["pairs"], work["variable_sites"],
                            work["records"], work["measure"])
    return 100.0 * least * trace["jobs"] / trace["counter_kernel_s"]
