"""Checkpoint/resume for long runs.

The reference is all-or-nothing (SURVEY.md section 5.4); at 1M-sequence
scale a run takes hours and the output is terabytes, so the engine
checkpoints cheaply: after each emitted strip (or streamed batch) it
atomically rewrites a tiny sidecar ``<output>.progress`` recording how
many emission units are complete and the output byte offset.  ``--resume``
truncates the output to that offset and skips the completed units —
emission order is deterministic, so the resumed file is byte-identical to
an uninterrupted run.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class ProgressTracker:
    """Sidecar progress state for one output file."""

    path: str
    units_done: int = 0
    byte_offset: int = 0
    config: Optional[dict] = None

    @property
    def sidecar(self) -> str:
        return self.path + ".progress"

    def load(self) -> bool:
        """Read the sidecar; returns True if prior progress exists."""
        try:
            with open(self.sidecar) as f:
                d = json.load(f)
            self.units_done = int(d["units_done"])
            self.byte_offset = int(d["byte_offset"])
            self.config = d.get("config")
            return True
        except (OSError, ValueError, KeyError):
            return False

    def check_config(self, config: dict) -> Optional[str]:
        """Mismatch description if the resumed run's settings differ."""
        if self.config is not None and self.config != config:
            return f"progress file was written with {self.config}, run has {config}"
        self.config = config
        return None

    def record(self, units_done: int, byte_offset: int) -> None:
        tmp = self.sidecar + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "units_done": units_done,
                    "byte_offset": byte_offset,
                    "config": self.config,
                },
                f,
            )
        os.replace(tmp, self.sidecar)
        self.units_done = units_done
        self.byte_offset = byte_offset

    def clear(self) -> None:
        try:
            os.remove(self.sidecar)
        except OSError:
            pass
