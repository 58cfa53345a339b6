"""Per-phase timing instrumentation.

The reference has no observability at all (SURVEY.md section 5.1); the
engine records wall time per phase (parse/encode, precompute, device
sweep, finalize, write) when ``DISTANCE_TPU_TRACE=1``, printing one line
per phase to stderr and accumulating totals for the benchmark harness.
``DISTANCE_TPU_TRACE_SUMMARY=1`` skips the per-occurrence lines and
prints one accumulated per-phase total at process exit — the right mode
for full-run phase breakdowns (a 1M-seq stream run times thousands of
phase occurrences).

``record_spans(True)`` also keeps each phase as a ``Span`` (start, end,
thread, parent, job) until ``take_spans()`` hands them over; ``job()``
numbers the jobs of a process and opens each one's root span.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional

_TOTALS: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)


class Span(NamedTuple):
    """One phase as it ran: ``t0`` and ``t1`` on ``time.perf_counter()``'s
    clock; ``parent`` the ``id`` of the innermost span open on the same
    thread, or for a thread's outermost span the root of the job it ran
    in; ``job`` that job's ordinal (None outside a job)."""

    id: int
    name: str
    thread: str
    t0: float
    t1: float
    parent: Optional[int]
    job: Optional[int]


_recording = False
_spans: List[Span] = []
_span_ids = itertools.count()
_job_ids = itertools.count()
_job: Optional[int] = None  # the open job's ordinal
_root: Optional[int] = None  # the open job's root span
_open = threading.local()  # .ids: the thread's open, recorded spans


def enabled() -> bool:
    return os.environ.get("DISTANCE_TPU_TRACE", "") not in ("", "0")


def summary_enabled() -> bool:
    return os.environ.get("DISTANCE_TPU_TRACE_SUMMARY", "") not in ("", "0")


@atexit.register
def _print_summary() -> None:
    if not _TOTALS or not (enabled() or summary_enabled()):
        return
    items = sorted(_TOTALS.items(), key=lambda kv: -kv[1])
    parts = "  ".join(
        f"{k}={v:.1f}s/{_COUNTS[k]}" for k, v in items
    )
    print(f"[distance-tpu] phase totals (s/count): {parts}",
          file=sys.stderr)


@contextlib.contextmanager
def phase_timer(name: str) -> Iterator[None]:
    span = _enter() if _recording else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _TOTALS[name] += dt
        _COUNTS[name] += 1
        if span is not None:
            _leave(span, name, t0, t0 + dt)
        if enabled():
            print(f"[distance-tpu] {name}: {dt * 1e3:.2f} ms", file=sys.stderr)


def _enter() -> tuple:
    """A recorded span opens: (id, parent, job), its id pushed on the
    thread's stack."""
    ids = getattr(_open, "ids", None)
    if ids is None:
        ids = _open.ids = []
    sid = next(_span_ids)
    span = (sid, ids[-1] if ids else _root, _job)
    ids.append(sid)
    return span


def _leave(span: tuple, name: str, t0: float, t1: float) -> None:
    sid, parent, job = span
    _open.ids.remove(sid)
    _spans.append(Span(sid, name, threading.current_thread().name, t0, t1,
                       parent, job))


def totals() -> Dict[str, float]:
    return dict(_TOTALS)


def reset() -> None:
    _TOTALS.clear()
    _COUNTS.clear()


def record_spans(on: bool = True) -> None:
    """Keep a ``Span`` of every phase that opens from now on (``on``), or
    of none (off, the default); ``take_spans()`` hands them over."""
    global _recording
    _recording = bool(on)


def take_spans() -> List[Span]:
    """The spans kept since the last call, in the order they closed."""
    global _spans
    spans, _spans = _spans, []
    return spans


def recording() -> bool:
    """Whether phases are kept as spans (``record_spans``)."""
    return _recording


def add(name: str, seconds: float, count: int) -> None:
    """Adds ``count`` occurrences of phase ``name``, ``seconds`` in all,
    timed by the caller, to the totals: a phase too short and frequent
    for a timer each.  It keeps no span."""
    _TOTALS[name] += seconds
    _COUNTS[name] += count


@contextlib.contextmanager
def job() -> Iterator[int]:
    """One job of the process: the next ordinal, which every span that
    opens until the job ends carries, and, while spans are recorded, the
    job's root span ``job``, the parent of each other thread's outermost
    spans.  The root is no phase: it adds no total."""
    global _job, _root
    outer = _job, _root
    _job = next(_job_ids)
    span = _enter() if _recording else None
    _root = None if span is None else span[0]
    t0 = time.perf_counter()
    try:
        yield _job
    finally:
        if span is not None:
            _leave(span, "job", t0, time.perf_counter())
        _job, _root = outer


class ProgressMeter:
    """Stderr progress line for long sweeps.

    Active when DISTANCE_TPU_PROGRESS=1 or stderr is a terminal; prints
    at most once per second.  Weights let strips of different pair
    counts advance the bar proportionally.
    """

    def __init__(self, label: str, weights) -> None:
        self._weights = list(weights)
        self._total = sum(self._weights) or 1
        self._done = 0.0
        self._count = 0
        self._label = label
        self._t0 = time.perf_counter()
        self._last_print = 0.0
        env = os.environ.get("DISTANCE_TPU_PROGRESS", "")
        if env not in ("", "0"):
            self._on = env != "0" and env != ""
        else:
            self._on = bool(getattr(sys.stderr, "isatty", lambda: False)())

    def tick(self) -> None:
        if self._count < len(self._weights):
            self._done += self._weights[self._count]
        self._count += 1
        if not self._on:
            return
        now = time.perf_counter()
        if now - self._last_print < 1.0 and self._count < len(self._weights):
            return
        self._last_print = now
        frac = self._done / self._total
        elapsed = now - self._t0
        eta = elapsed / frac - elapsed if frac > 0 else 0.0
        print(
            f"\r[distance-tpu] {self._label} {frac * 100:5.1f}%"
            f" ({self._count}/{len(self._weights)})"
            f" elapsed {elapsed:.0f}s eta {eta:.0f}s",
            end="",
            file=sys.stderr,
        )
        if self._count >= len(self._weights):
            print(file=sys.stderr)
