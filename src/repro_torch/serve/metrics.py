"""Metrics surface of the streaming AlignmentService.

A thread-safe accumulator shared by the client threads (submit) and the
dispatcher thread (flush / finalize). `snapshot()` renders the counters
into the metrics dict the service exposes — the numbers an operator
watches to see whether the co-processor is kept fed:

  requests_per_s     completed requests over the service's wall clock
  p50_ms / p99_ms    request latency percentiles (submit -> result)
  fill_ratio         real pairs / padded dispatch slots, cumulative —
                     1.0 means every dispatch ran with its compute
                     memory full (paper Fig. 6's stated goal)
  bytes_fetched      device->host bytes actually materialised by
                     finalize (padded slice rows included — the bytes
                     the host really paid for, accumulated per flush,
                     so the counter is strictly monotone in dispatches)
  rejected           pairs the engine's xdrop rule retired early
  rejected_fraction  rejected / completed — an operator watching this
                     gauge sees the candidate-filter quality of the
                     upstream seeding stage (0.0 when xdrop is off)
  flush_*            flush-cause counters: fill / timeout / stall /
                     priority / shutdown (see serve.policy)
  priority           per-SLA-class sub-dict: completed count and
                     p50/p99 latency for interactive / normal / bulk

Latencies are kept in bounded reservoirs (the most recent
`LATENCY_WINDOW` samples, overall and per priority class) so a
long-lived service never grows without bound; percentiles are over
those windows.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from repro_torch.serve.policy import FLUSH_CAUSES, PRIORITIES

#: Latency samples retained for the percentile window.
LATENCY_WINDOW = 100_000


def _percentiles(lat: np.ndarray) -> dict:
    out = {}
    for name, q in (("p50_ms", 50.0), ("p99_ms", 99.0)):
        out[name] = (float(np.percentile(lat, q)) * 1e3
                     if lat.size else 0.0)
    out["mean_ms"] = float(lat.mean()) * 1e3 if lat.size else 0.0
    return out


class ServiceMetrics:
    """Thread-safe counters + latency reservoirs for one service."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t_start = time.perf_counter()
        self._latencies = collections.deque(maxlen=LATENCY_WINDOW)
        self._latencies_by_priority = {
            p: collections.deque(maxlen=LATENCY_WINDOW) for p in PRIORITIES}
        self.submitted = 0
        self.completed = 0
        self.dispatches = 0        # device dispatch groups enqueued
        self.real_pairs = 0        # true pairs across all dispatches
        self.padded_slots = 0      # padded slots across all dispatches
        self.bytes_fetched = 0     # host bytes materialised by finalize
        self.rejected = 0          # pairs retired by xdrop (status != 0)
        self.flush_causes = collections.Counter()  # cause -> flushes
        self.completed_by_priority = collections.Counter()

    # -- recording (called by service internals) -----------------------
    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_flush(self, cause: str) -> None:
        with self._lock:
            self.flush_causes[cause] += 1

    def record_dispatch(self, num_real: int, num_slots: int) -> None:
        with self._lock:
            self.dispatches += 1
            self.real_pairs += num_real
            self.padded_slots += num_slots

    def record_results(self, latencies_s, nbytes: int,
                       priorities=None, statuses=None) -> None:
        """One finalized group's request latencies and its *actual*
        device->host fetch traffic (padded rows included — accumulated
        per flush, never overwritten). `priorities` optionally labels
        each latency sample with its request's SLA class; `statuses`
        optionally carries each request's xdrop verdict (nonzero =
        retired early, counted into the `rejected` counter)."""
        with self._lock:
            self.completed += len(latencies_s)
            self.bytes_fetched += int(nbytes)
            if statuses is not None:
                self.rejected += sum(1 for s in statuses if s)
            self._latencies.extend(latencies_s)
            if priorities is not None:
                for lat, prio in zip(latencies_s, priorities):
                    self.completed_by_priority[prio] += 1
                    self._latencies_by_priority[prio].append(lat)

    # -- rendering -----------------------------------------------------
    def _raw(self) -> dict:
        """A consistent copy of every counter and latency reservoir
        (one lock acquisition) — the unit `snapshot` renders and
        `aggregate_metrics` merges across replicas."""
        with self._lock:
            return {
                "elapsed_s": max(time.perf_counter() - self._t_start, 1e-9),
                "latencies": list(self._latencies),
                "latencies_by_priority": {
                    p: list(d)
                    for p, d in self._latencies_by_priority.items()},
                "submitted": self.submitted,
                "completed": self.completed,
                "dispatches": self.dispatches,
                "real_pairs": self.real_pairs,
                "padded_slots": self.padded_slots,
                "bytes_fetched": self.bytes_fetched,
                "rejected": self.rejected,
                "flush_causes": dict(self.flush_causes),
                "completed_by_priority": dict(self.completed_by_priority),
            }

    def snapshot(self) -> dict:
        """The service metrics dict (a point-in-time copy, safe to keep)."""
        return _render(self._raw())


def _render(raw: dict) -> dict:
    """Render one raw counter copy (or a merge of several) into the
    metrics dict surface."""
    out = {
        "submitted": raw["submitted"],
        "completed": raw["completed"],
        "dispatches": raw["dispatches"],
        "requests_per_s": raw["completed"] / raw["elapsed_s"],
        "fill_ratio": (raw["real_pairs"] / raw["padded_slots"]
                       if raw["padded_slots"] else 0.0),
        "real_pairs": raw["real_pairs"],
        "padded_slots": raw["padded_slots"],
        "bytes_fetched": raw["bytes_fetched"],
        "rejected": raw["rejected"],
        "rejected_fraction": (raw["rejected"] / raw["completed"]
                              if raw["completed"] else 0.0),
        "elapsed_s": raw["elapsed_s"],
    }
    for cause in FLUSH_CAUSES:
        out[f"flush_{cause}"] = raw["flush_causes"].get(cause, 0)
    out.update(_percentiles(np.asarray(raw["latencies"], np.float64)))
    out["priority"] = {
        p: {"completed": raw["completed_by_priority"].get(p, 0),
            **_percentiles(np.asarray(d, np.float64))}
        for p, d in raw["latencies_by_priority"].items() if d}
    return out


def aggregate_metrics(metrics) -> dict:
    """Exact cross-replica aggregate of several `ServiceMetrics`.

    Counters sum; the fill ratio is recomputed from the summed real /
    padded pair counts (never an average of ratios); latency
    percentiles are over the concatenated reservoirs, so the aggregate
    p99 is the tier's true tail, not some replica's. `elapsed_s` is the
    longest-lived replica's clock — the tier's wall time — and
    `requests_per_s` is total completions over it. Used by the
    replicated serving tier's `AlignmentRouter.stats()`; note a
    failed-over request is counted `submitted` once per replica that
    accepted it (the router's `reroutes` counter tracks the overlap).
    """
    raws = [m._raw() for m in metrics]
    merged = {
        "elapsed_s": max((r["elapsed_s"] for r in raws), default=1e-9),
        "latencies": [x for r in raws for x in r["latencies"]],
        "latencies_by_priority": {
            p: [x for r in raws
                for x in r["latencies_by_priority"].get(p, [])]
            for p in PRIORITIES},
        "flush_causes": {
            c: sum(r["flush_causes"].get(c, 0) for r in raws)
            for c in FLUSH_CAUSES},
        "completed_by_priority": {
            p: sum(r["completed_by_priority"].get(p, 0) for r in raws)
            for p in PRIORITIES},
    }
    for key in ("submitted", "completed", "dispatches", "real_pairs",
                "padded_slots", "bytes_fetched", "rejected"):
        merged[key] = sum(r[key] for r in raws)
    return _render(merged)


__all__ = ["ServiceMetrics", "aggregate_metrics", "LATENCY_WINDOW"]
