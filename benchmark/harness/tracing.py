"""The traced run's readings: host phase spans, the profiler's device
events, and their reduction to busy time, kernel time and idle gaps.

The program's phase timers keep totals only.  In a traced run the
harness wraps ``phase_timer`` in the program's loaded modules so that
each phase also leaves a span (name, thread, start, end) on the host's
clock.  A profiler range opened at a known host time maps the device
events onto that clock.
"""

import contextlib
import re
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from harness.roofline import COUNTER_KERNELS

PACKAGE = "distance_tpu_torch"
MARK = "bench.window"


class PhaseSpans:
    """Wraps the program's ``phase_timer`` while installed."""

    def __init__(self):
        self.spans: List[Tuple[str, str, float, float]] = []
        self._saved: List[tuple] = []

    def install(self) -> None:
        from distance_tpu_torch.utils import timing

        original = timing.phase_timer
        spans = self.spans

        @contextlib.contextmanager
        def phase_timer(name):
            t0 = time.perf_counter()
            try:
                with original(name):
                    yield
            finally:
                spans.append((name, threading.current_thread().name, t0,
                              time.perf_counter()))

        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").split(".")[0] == PACKAGE
                    and getattr(mod, "phase_timer", None) is original):
                self._saved.append((mod, original))
                mod.phase_timer = phase_timer

    def remove(self) -> None:
        for mod, original in self._saved:
            mod.phase_timer = original
        self._saved.clear()


@contextlib.contextmanager
def profiled(out: dict):
    """Profiles the block; on exit fills ``out["device"]`` with the device
    events as (name, start, end) on the host's perf_counter clock.  The
    marking range itself shows on the device's timeline too (as a user
    annotation) and is left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(MARK):
            t_mark = time.perf_counter()
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.events()
    base = next(ev.time_range.start for ev in events if ev.name == MARK)
    shift = t_mark - base / 1e6
    out["device"] = [
        (ev.name, ev.time_range.start / 1e6 + shift,
         ev.time_range.end / 1e6 + shift)
        for ev in events
        if ev.device_type == DeviceType.CUDA and ev.name != MARK]


def per_job(record: dict, phases) -> Optional[float]:
    """The mean over the window's jobs of the named phase timers' sum,
    or None where no job recorded any of them."""
    jobs = record.get("phases") or []
    if not any(p in j for j in jobs for p in phases):
        return None
    return sum(sum(j.get(p, 0.0) for p in phases) for j in jobs) / len(jobs)


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The merged intervals, clipped to [lo, hi]."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_by_phase(gaps, spans) -> Dict[str, List[float]]:
    """Idle seconds of the gaps by what the host was doing over each
    moment of them: each thread's innermost phase in progress, the main
    thread's first.  Also counts the gaps each label touched."""
    events = sorted([(t0, 1, i) for i, (_, _, t0, _) in enumerate(spans)]
                    + [(t1, 0, i) for i, (_, _, _, t1) in enumerate(spans)])
    active: Dict[str, List[int]] = defaultdict(list)
    idle: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    touched: Dict[str, set] = defaultdict(set)
    g, t = 0, float("-inf")

    def label() -> str:
        inner = {th: spans[ids[-1]][0] for th, ids in active.items() if ids}
        order = sorted(inner, key=lambda th: (th != "MainThread", th))
        return " | ".join(inner[th] for th in order) or "no phase"

    for when, starts, i in events + [(float("inf"), 0, -1)]:
        # the segment [t, when) has one label: add its overlap with gaps
        name = None
        while g < len(gaps) and gaps[g][0] < when:
            a, b = max(gaps[g][0], t), min(gaps[g][1], when)
            if b > a:
                name = name or label()
                idle[name][0] += b - a
                touched[name].add(g)
            if gaps[g][1] <= when:
                g += 1
            else:
                break
        t = when
        if i < 0:
            break
        ids = active[spans[i][1]]
        if starts:
            ids.append(i)
        elif i in ids:
            ids.remove(i)
    for name, slot in idle.items():
        slot[1] = len(touched[name])
    return idle


def reduce(device: list, spans: list, lo: float, hi: float,
           top: int = 10) -> dict:
    """busy_s, window_s, counter kernel seconds, and the breakdown: the
    device operations that took most time, and idle seconds by what the
    host was doing (with the count of gaps each label touched)."""
    busy = union([(a, b) for _, a, b in device], lo, hi)
    by_op: Dict[str, float] = defaultdict(float)
    counter_s = 0.0
    for name, a, b in device:
        by_op[short_name(name)] += b - a
        if any(k in name for k in COUNTER_KERNELS):
            counter_s += b - a
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    idle = idle_by_phase(gaps, spans)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gap_rows = sorted(idle.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "busy_s": sum(b - a for a, b in busy),
        "window_s": hi - lo,
        "counter_kernel_s": counter_s,
        "breakdown": {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[f"{n} (x{c})", s] for n, (s, c) in gap_rows],
        },
    }

