"""Straggler mitigation: :class:`StragglerMonitor`, a per-step wall-time
EMA that flags steps slower than ``threshold``x the EMA (the training
driver can then skip the all-reduce for that replica or re-dispatch data,
and the monitor records the event for the ops log).

Port of ``repro/train/elastic.py``'s monitor.  Its ``remesh`` and
``shrink_mesh`` reshard onto a mesh, which the port does not have yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["StragglerMonitor"]


@dataclass
class StragglerMonitor:
    threshold: float = 2.0
    decay: float = 0.9
    ema: Optional[float] = None
    events: List[dict] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        """Returns True if this step was a straggler."""
        dt = time.monotonic() - (self._t0 or time.monotonic())
        is_straggler = self.ema is not None and dt > self.threshold * self.ema
        if is_straggler:
            self.events.append({"step": step, "duration_s": dt,
                                "ema_s": self.ema})
        # EMA excludes straggler steps (they would poison the baseline)
        if not is_straggler:
            self.ema = dt if self.ema is None else \
                self.decay * self.ema + (1 - self.decay) * dt
        return is_straggler
