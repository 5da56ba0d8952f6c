"""Flush policies and pipeline-depth autotuning for the AlignmentService.

The service's original flush rule was open-loop: a single global
`min_fill` / `max_wait_ms` pair, blind to how requests actually arrive.
Under bursty or sub-saturation offered rates that rule fires too
eagerly — BENCH_engine.json's open-loop sweep showed the batch fill
ratio collapsing from 1.00 (closed loop) to 0.38–0.60 while the
dispatch count nearly tripled, exactly the host-side feeding failure
the DiMSA framework paper calls out for real PIM deployments.

This module closes the loop:

* `FlushPolicy` — the protocol the service's dispatcher consults every
  scheduling round. A policy sees the pending requests (their length
  class, submit time, and SLA priority) and answers two questions:
  which requests flush *now* (and why — the cause lands in the
  flush-cause counters), and when the decision should be revisited if
  nothing new arrives.

* `StaticFlushPolicy` — the legacy deterministic rule (total pending
  >= min_fill, or the oldest non-bulk request waited max_wait).
  Existing tests and latency-predictable deployments keep this.

* `AdaptiveFlushPolicy` — per-length-class controllers. Each class
  tracks an EWMA of its inter-arrival time and jitter (fed from request
  *submit* timestamps, so it measures the arrival process rather than
  the dispatcher's drain cadence). When the predicted time-to-fill a
  dispatch slice fits inside the latency budget, the class holds for
  fill; when arrivals stall (no arrival for `stall_factor` EWMA
  inter-arrival times + jitter), it flushes early instead of burning
  the budget on a batch that is not going to fill.

* `DepthAutotuner` — closes the second open loop: the pipeline depth
  (`max_inflight_groups`) was a hardcoded constant. The tuner keeps
  per-dispatch-signature EWMAs of the host-side enqueue latency vs the
  blocking finalize latency and suggests a depth matched to the
  measured compute/fetch overlap ratio.

Priority classes (`submit(..., priority=)`):

  interactive   a lone latency-sensitive read: preempts batching — its
                length class flushes on the next scheduling round.
  normal        policy-controlled (the default).
  bulk          throughput traffic: never *causes* an early flush; it
                waits for a fill (or rides along when a normal/
                interactive classmate triggers one) and is always
                drained by shutdown.

Flush causes recorded into `ServiceMetrics`: "fill", "timeout",
"stall", "priority", "shutdown".
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, runtime_checkable

#: Valid request priorities, lowest-latency first.
PRIORITIES = ("interactive", "normal", "bulk")

#: Flush causes a policy may emit ("shutdown" is the service's own).
FLUSH_CAUSES = ("fill", "timeout", "stall", "priority", "shutdown")


@runtime_checkable
class PendingRequest(Protocol):
    """What a policy may read off each pending request."""

    cls: int          # length class key (padded-length bucket edge)
    t_submit: float   # submission timestamp (service clock)
    priority: str     # one of PRIORITIES


#: One decide() outcome: (positions in `pending` to flush, cause).
FlushBatch = tuple[list[int], str]


class FlushPolicy(Protocol):
    """The dispatcher's flush controller.

    The service calls `note_arrival` once per request as it drains the
    queue, and `decide` once per scheduling round. Both run only on
    the dispatcher thread — implementations need no locking.
    """

    name: str

    def note_arrival(self, cls_key: int, t_submit: float) -> None:
        """Observe one arrival of length class `cls_key`."""
        ...

    def decide(self, pending: Sequence[PendingRequest],
               now: float) -> tuple[list[FlushBatch], float | None]:
        """Pick the batches to flush now.

        Returns `(batches, wait_until)`: each batch is a list of
        positions into `pending` plus its flush cause; `wait_until` is
        the absolute time at which the decision should be re-evaluated
        when no new request arrives first (None = no deadline — wait
        for the next arrival or shutdown).
        """
        ...


def _min_deadline(a: float | None, b: float) -> float:
    return b if a is None else min(a, b)


@dataclasses.dataclass
class StaticFlushPolicy:
    """The legacy open-loop rule, kept deterministic for tests and for
    deployments that want a fixed latency bound.

    Flushes *everything* pending when total pending >= `min_fill`, when
    an interactive request is present, or when the oldest non-bulk
    request has waited `max_wait_s`. Bulk-only backlogs wait for fill
    (or shutdown)."""

    min_fill: int
    max_wait_s: float
    name: str = "static"

    def note_arrival(self, cls_key: int, t_submit: float) -> None:
        pass  # open-loop: arrival history does not inform the decision

    def decide(self, pending, now):
        if not pending:
            return [], None
        everyone = list(range(len(pending)))
        if len(pending) >= self.min_fill:
            return [(everyone, "fill")], None
        if any(r.priority == "interactive" for r in pending):
            return [(everyone, "priority")], None
        deadlines = [r.t_submit + self.max_wait_s for r in pending
                     if r.priority != "bulk"]
        if not deadlines:
            return [], None  # all bulk: hold for fill or shutdown
        oldest = min(deadlines)
        if now >= oldest:
            return [(everyone, "timeout")], None
        return [], oldest


@dataclasses.dataclass
class _ClassRate:
    """Arrival-process estimate for one length class."""

    ewma_dt: float | None = None      # EWMA inter-arrival time (s)
    ewma_jitter: float = 0.0          # EWMA |dt - ewma_dt| (s)
    t_last: float | None = None       # newest arrival's submit time


@dataclasses.dataclass
class AdaptiveFlushPolicy:
    """Arrival-rate-aware per-length-class flush controllers.

    Per class, each scheduling round:

      1. `fill`: the class holds at least one full dispatch slice
         (`fill_target` pairs) — flush the oldest whole slices (the
         remainder keeps accumulating so every dispatched slice runs
         with its compute memory full).
      2. `priority`: an interactive request is present — flush the
         class now (classmates ride along for free).
      3. `timeout`: the oldest non-bulk request's latency budget
         (`latency_budget_s`) is spent — flush.
      4. `stall`: no arrival for `stall_factor * (EWMA dt + jitter) +
         min_hold_s` — the burst is over; flush early rather than hold
         a batch that will not fill inside the budget.
      5. otherwise hold: the EWMA predicts the slice fills within the
         budget, so waiting buys fill ratio at bounded latency cost.

    Classes with fewer than two observed arrivals have no rate
    estimate yet; they fall back to the static `fallback_wait_s`
    deadline (a fresh service behaves like the static policy until the
    EWMAs warm up).
    """

    fill_target: int                  # pairs that make a full dispatch slice
    latency_budget_s: float           # max hold time for a non-bulk request
    fallback_wait_s: float            # pre-warm-up static deadline
    stall_factor: float = 4.0         # stall after this many EWMA dts
    min_hold_s: float = 2e-3          # jitter floor for the stall clock
    alpha: float = 0.25               # EWMA weight of the newest sample
    name: str = "adaptive"

    def __post_init__(self):
        self._rates: dict[int, _ClassRate] = {}

    # -- arrival-process tracking --------------------------------------
    def note_arrival(self, cls_key: int, t_submit: float) -> None:
        st = self._rates.setdefault(cls_key, _ClassRate())
        if st.t_last is not None:
            dt = max(t_submit - st.t_last, 0.0)
            if st.ewma_dt is None:
                st.ewma_dt = dt
            else:
                st.ewma_jitter += self.alpha * (abs(dt - st.ewma_dt)
                                                - st.ewma_jitter)
                st.ewma_dt += self.alpha * (dt - st.ewma_dt)
        st.t_last = max(t_submit, st.t_last or t_submit)

    def rate_estimate(self, cls_key: int) -> _ClassRate | None:
        """The class's current arrival estimate (None before warm-up)."""
        return self._rates.get(cls_key)

    # -- the controller ------------------------------------------------
    def decide(self, pending, now):
        by_cls: dict[int, list[int]] = {}
        for i, r in enumerate(pending):
            by_cls.setdefault(r.cls, []).append(i)
        batches: list[FlushBatch] = []
        wait_until: float | None = None
        for cls_key, pos in by_cls.items():
            reqs = [pending[i] for i in pos]
            if len(reqs) >= self.fill_target:
                # Flush whole dispatch slices only: a 20-request class
                # with a 16-slot slice sends the oldest 16 and keeps
                # accumulating the 4 — flushing all 20 would make plan()
                # emit a 16-slice plus a 4/16 partial, which is exactly
                # the fill-ratio loss this policy exists to avoid.
                n_full = (len(pos) // self.fill_target) * self.fill_target
                batches.append((pos[:n_full], "fill"))
                pos, reqs = pos[n_full:], reqs[n_full:]
                if not pos:
                    continue
            if any(r.priority == "interactive" for r in reqs):
                batches.append((pos, "priority"))
                continue
            t0s = [r.t_submit for r in reqs if r.priority != "bulk"]
            if not t0s:
                continue  # bulk-only class: fill or shutdown drains it
            budget_deadline = min(t0s) + self.latency_budget_s
            if now >= budget_deadline:
                batches.append((pos, "timeout"))
                continue
            st = self._rates.get(cls_key)
            if st is None or st.ewma_dt is None:
                # No inter-arrival estimate yet: static fallback.
                deadline = min(t0s) + self.fallback_wait_s
                if now >= deadline:
                    batches.append((pos, "timeout"))
                else:
                    wait_until = _min_deadline(wait_until, deadline)
                continue
            stall_deadline = (st.t_last
                              + self.stall_factor
                              * (st.ewma_dt + st.ewma_jitter)
                              + self.min_hold_s)
            if now >= stall_deadline:
                batches.append((pos, "stall"))
                continue
            # Hold for fill: the next arrival re-runs decide, so the
            # only wake-ups needed are the stall and budget deadlines.
            wait_until = _min_deadline(
                wait_until, min(stall_deadline, budget_deadline))
        return batches, wait_until


def resolve_policy(policy, *, min_fill: int, max_wait_s: float,
                   latency_budget_s: float | None = None) -> FlushPolicy:
    """Turn the service's `policy=` argument into a FlushPolicy.

    Accepts a ready-made policy object (duck-typed on note_arrival /
    decide) or the names "static" / "adaptive" parameterised from the
    service's own knobs. The adaptive latency budget defaults to
    10x max_wait: the static deadline becomes the *floor* a cold class
    pays, and a warmed-up class may hold up to the budget for fill.
    """
    if not isinstance(policy, str):
        if not (hasattr(policy, "decide") and hasattr(policy, "note_arrival")):
            raise TypeError(f"policy object {policy!r} does not implement "
                            "the FlushPolicy protocol")
        return policy
    if policy == "static":
        return StaticFlushPolicy(min_fill=min_fill, max_wait_s=max_wait_s)
    if policy == "adaptive":
        return AdaptiveFlushPolicy(
            fill_target=min_fill,
            latency_budget_s=(latency_budget_s if latency_budget_s is not None
                              else 10.0 * max_wait_s),
            fallback_wait_s=max_wait_s)
    raise ValueError(f"unknown flush policy {policy!r}: expected 'static', "
                     "'adaptive', or a FlushPolicy object")


@dataclasses.dataclass
class _SignatureTiming:
    enqueue_s: float
    finalize_s: float


class DepthAutotuner:
    """Autotunes the service's pipeline depth (`max_inflight_groups`).

    The depth-k pipeline exists so device compute overlaps the host's
    blocking finalize (fetch + RLE join). The right k is set by how
    much host time a group costs relative to how quickly groups can be
    enqueued: per dispatch signature the tuner keeps EWMAs of the
    enqueue latency E (host staging + async launch) and the finalize
    latency F (block-until-done + fetch + decode) and suggests

        depth = clamp(ceil(F / max(E, eps)), min_depth, max_depth)

    — when finalize dominates (F >> E, the usual case: fetch/decode is
    the host bottleneck) the pipeline deepens so the device never goes
    hungry while the host drains results; when enqueue and finalize
    cost alike there is nothing to overlap and the depth stays shallow.
    The suggestion is the max over signatures observed so the heaviest
    traffic class sets the depth.
    """

    def __init__(self, *, default_depth: int = 2, min_depth: int = 1,
                 max_depth: int = 4, alpha: float = 0.25):
        self.default_depth = default_depth
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.alpha = alpha
        self._timings: dict[tuple, _SignatureTiming] = {}

    def note(self, signature: tuple, enqueue_s: float,
             finalize_s: float) -> None:
        """Record one group's measured enqueue / finalize latencies."""
        st = self._timings.get(signature)
        if st is None:
            self._timings[signature] = _SignatureTiming(enqueue_s, finalize_s)
            return
        st.enqueue_s += self.alpha * (enqueue_s - st.enqueue_s)
        st.finalize_s += self.alpha * (finalize_s - st.finalize_s)

    def signature_depth(self, signature: tuple) -> int:
        """Suggested depth for one signature."""
        st = self._timings.get(signature)
        if st is None:
            return self.default_depth
        ratio = st.finalize_s / max(st.enqueue_s, 1e-6)
        return max(self.min_depth,
                   min(self.max_depth, int(-(-ratio // 1))))

    def depth(self) -> int:
        """The depth the service should run at: the max suggestion over
        every signature seen (the heaviest class must stay fed)."""
        if not self._timings:
            return self.default_depth
        return max(self.signature_depth(sig) for sig in self._timings)

    def snapshot(self) -> dict:
        """Per-signature EWMAs for the stats surface."""
        return {str(sig): {"enqueue_ms": st.enqueue_s * 1e3,
                           "finalize_ms": st.finalize_s * 1e3,
                           "depth": self.signature_depth(sig)}
                for sig, st in self._timings.items()}


__all__ = ["FlushPolicy", "StaticFlushPolicy", "AdaptiveFlushPolicy",
           "DepthAutotuner", "resolve_policy", "PRIORITIES",
           "FLUSH_CAUSES"]
