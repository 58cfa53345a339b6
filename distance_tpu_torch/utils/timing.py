"""Per-phase timing instrumentation.

The reference has no observability at all (SURVEY.md section 5.1); the
engine records wall time per phase (parse/encode, precompute, device
sweep, finalize, write) when ``DISTANCE_TPU_TRACE=1``, printing one line
per phase to stderr and accumulating totals for the benchmark harness.
``DISTANCE_TPU_TRACE_SUMMARY=1`` skips the per-occurrence lines and
prints one accumulated per-phase total at process exit — the right mode
for full-run phase breakdowns (a 1M-seq stream run times thousands of
phase occurrences).
"""

from __future__ import annotations

import atexit
import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator

_TOTALS: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)


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
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _TOTALS[name] += dt
        _COUNTS[name] += 1
        if enabled():
            print(f"[distance-tpu] {name}: {dt * 1e3:.2f} ms", file=sys.stderr)


def totals() -> Dict[str, float]:
    return dict(_TOTALS)


def reset() -> None:
    _TOTALS.clear()
    _COUNTS.clear()


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
