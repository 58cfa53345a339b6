"""Percent: the least time the traced jobs' counter work needs
(roofline.counter_least_s) over the profiler's device time of K1
(``counters_kernel``) alone in those jobs, as the breakdown's device
operations name it.  A window without that kernel gives nothing."""

from harness.roofline import counter_least_s

LAYER = "kernels"
UNIT = "%"
MOVES = "pairs_per_s"
KERNEL = "counters_kernel"


def read(record: dict):
    trace, work = record.get("trace"), record.get("work")
    if not trace or not work:
        return None
    ops = dict(trace.get("breakdown", {}).get("device_ops", []))
    if ops.get(KERNEL, 0) <= 0:
        return None
    least = counter_least_s(work["pairs"], work["variable_sites"],
                            work["records"], work["measure"])
    return 100.0 * least * trace["jobs"] / ops[KERNEL]
