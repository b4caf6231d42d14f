"""Fault tolerance: heartbeats and straggler detection (``repro/ft/failures.py``).

Pure Python and hardware-independent: a fake clock drives it in tests; the
train loop feeds it step timings.

* **Heartbeat liveness**: a host missing ``timeout`` seconds of beats is
  declared dead.
* **Straggler detection**: per-step durations in a rolling window; hosts
  slower than ``straggler_factor`` x the median are flagged.

The elastic resize planner (``plan_elastic_mesh``) waits for the port's
mesh work (``ROADMAP.md``, queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List

__all__ = ["FailureEvent", "HeartbeatMonitor", "StragglerDetector"]


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    kind: str              # "dead" | "straggler"
    host: int
    at_step: int
    detail: str = ""


class HeartbeatMonitor:
    """Declares hosts dead after ``timeout`` seconds without a beat."""

    def __init__(self, num_hosts: int, timeout: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last_beat: Dict[int, float] = {h: clock() for h in
                                            range(num_hosts)}
        self.dead: set = set()

    def beat(self, host: int) -> None:
        if host not in self.dead:
            self.last_beat[host] = self.clock()

    def check(self, at_step: int = -1) -> List[FailureEvent]:
        now = self.clock()
        events = []
        for host, t in self.last_beat.items():
            if host not in self.dead and now - t > self.timeout:
                self.dead.add(host)
                events.append(FailureEvent("dead", host, at_step,
                                           f"no beat for {now - t:.1f}s"))
        return events

    @property
    def alive(self) -> List[int]:
        return [h for h in self.last_beat if h not in self.dead]


class StragglerDetector:
    """Rolling-window per-host step-time tracking."""

    def __init__(self, window: int = 16, straggler_factor: float = 1.5,
                 min_samples: int = 4):
        self.window = window
        self.factor = straggler_factor
        self.min_samples = min_samples
        self.times: Dict[int, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, host: int, step_time: float) -> None:
        self.times[host].append(step_time)

    def check(self, at_step: int = -1) -> List[FailureEvent]:
        medians = {h: statistics.median(ts) for h, ts in self.times.items()
                   if len(ts) >= self.min_samples}
        if len(medians) < 2:
            return []
        global_median = statistics.median(medians.values())
        return [FailureEvent("straggler", h, at_step,
                             f"{m / global_median:.2f}x median")
                for h, m in medians.items()
                if m > self.factor * global_median]
