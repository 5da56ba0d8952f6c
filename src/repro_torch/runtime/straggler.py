"""Straggler detection/mitigation bookkeeping.

At multi-pod scale the slowest host sets the step time (synchronous SPMD).
The framework-level mitigations we implement:

  * StepMonitor — rolling median step time; flags steps (or, in multi-host
    deployments, hosts reporting their local step segment) slower than
    `threshold x median`. The launcher reacts by (a) logging the event,
    (b) counting strikes per host, and (c) after `max_strikes`, recommending
    an elastic remesh that excludes the host (runtime.elastic).
  * Data re-issue — the token pipeline is stateless per (seed, step)
    (data.tokens), so a replacement host can recompute any step's shard
    without coordination — no data loss on failover.

The monitor is deliberately host-side and dependency-free: on real
clusters the same logic consumes per-host heartbeats.
"""

from __future__ import annotations

import dataclasses
import statistics
import time


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    duration: float
    median: float


class StepMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 32,
                 max_strikes: int = 3, num_hosts: int = 1):
        self.threshold = threshold
        self.window = window
        self.max_strikes = max_strikes
        self.durations: list[float] = []
        self.strikes = [0] * num_hosts
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int, host: int = 0,
             duration: float | None = None) -> StragglerEvent | None:
        """Record a step duration (measured or injected for tests)."""
        if duration is None:
            if self._t0 is None:
                raise RuntimeError("stop() without start()")
            duration = time.perf_counter() - self._t0
            self._t0 = None
        self.durations.append(duration)
        recent = self.durations[-self.window:]
        if len(recent) < 5:
            return None
        med = statistics.median(recent[:-1])
        if duration > self.threshold * med:
            self.strikes[host] += 1
            ev = StragglerEvent(step=step, host=host, duration=duration,
                                median=med)
            self.events.append(ev)
            return ev
        return None

    def hosts_to_evict(self) -> list[int]:
        return [h for h, s in enumerate(self.strikes)
                if s >= self.max_strikes]
