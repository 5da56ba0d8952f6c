"""`repro_torch.serve.policy`: flush policies, depth autotuning, and the
adaptive controller under a deterministic fake clock, ported from the JAX
package's tests onto the port's policy module and its service over the
CPU engine (`backend="reference"`, `device="cpu"`).

Three layers: pure-policy units (decide() on synthetic pending lists —
no service, no engine), a deterministic event-driven simulation that
replays one bursty arrival schedule through both policies (the adaptive
controller must convert static's timeout flushes into fill/stall
flushes), and service-level tests with an injected `time_fn` (the
dispatcher holds while the fake clock is frozen, so flush timing is
asserted exactly, not raced). The bursty replay also runs the JAX
package's two policies on the same schedule: same flushes, same sizes."""

import collections
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro.serve import policy as jax_policy
from repro_torch.core.engine import AlignmentEngine
from repro_torch.serve import AlignmentService
from repro_torch.serve.policy import (AdaptiveFlushPolicy, DepthAutotuner,
                                      FLUSH_CAUSES, StaticFlushPolicy,
                                      resolve_policy)


def _req(cls=128, t=0.0, priority="normal"):
    return SimpleNamespace(cls=cls, t_submit=t, priority=priority)


# ----------------------------------------------------------------------
# StaticFlushPolicy units.
# ----------------------------------------------------------------------
class TestStaticPolicy:
    def test_fill_flushes_everything_immediately(self):
        pol = StaticFlushPolicy(min_fill=3, max_wait_s=10.0)
        batches, wait = pol.decide([_req(t=0.0)] * 3, now=0.0)
        assert batches == [([0, 1, 2], "fill")]
        assert wait is None

    def test_interactive_preempts_before_fill(self):
        pol = StaticFlushPolicy(min_fill=100, max_wait_s=10.0)
        pending = [_req(t=0.0), _req(t=0.0, priority="interactive")]
        batches, _ = pol.decide(pending, now=0.0)
        assert batches == [([0, 1], "priority")]

    def test_oldest_nonbulk_timeout(self):
        pol = StaticFlushPolicy(min_fill=100, max_wait_s=1.0)
        pending = [_req(t=0.0), _req(t=0.9)]
        batches, wait = pol.decide(pending, now=0.5)
        assert batches == [] and wait == pytest.approx(1.0)
        batches, _ = pol.decide(pending, now=1.0)
        assert batches == [([0, 1], "timeout")]

    def test_bulk_only_holds_forever(self):
        pol = StaticFlushPolicy(min_fill=100, max_wait_s=0.001)
        pending = [_req(t=0.0, priority="bulk")] * 2
        batches, wait = pol.decide(pending, now=1e9)
        assert batches == [] and wait is None

    def test_bulk_rides_along_with_normal_timeout(self):
        pol = StaticFlushPolicy(min_fill=100, max_wait_s=1.0)
        pending = [_req(t=0.0, priority="bulk"), _req(t=0.0)]
        batches, _ = pol.decide(pending, now=2.0)
        assert batches == [([0, 1], "timeout")]


# ----------------------------------------------------------------------
# AdaptiveFlushPolicy units (synthetic clocks, no service).
# ----------------------------------------------------------------------
def _warm_policy(fill_target=8, budget=0.050, fallback=0.005, *,
                 cls=128, n=4, dt=0.001):
    """An adaptive policy whose EWMA saw `n` arrivals spaced `dt`."""
    pol = AdaptiveFlushPolicy(fill_target=fill_target,
                              latency_budget_s=budget,
                              fallback_wait_s=fallback)
    for k in range(n):
        pol.note_arrival(cls, k * dt)
    return pol


class TestAdaptivePolicy:
    def test_ewma_tracks_steady_rate(self):
        pol = _warm_policy(n=16, dt=0.002)
        st = pol.rate_estimate(128)
        assert st.ewma_dt == pytest.approx(0.002)
        assert st.ewma_jitter == pytest.approx(0.0, abs=1e-9)

    def test_holds_for_fill_inside_budget(self):
        # 3 arrivals at 1ms spacing; the static fallback (5ms) would
        # flush at t=6ms — the warm controller holds instead.
        pol = _warm_policy(n=3)
        pending = [_req(t=k * 0.001) for k in range(3)]
        batches, wait = pol.decide(pending, now=0.006)
        assert batches == []
        assert wait is not None  # stall/budget deadline, not forever

    def test_fill_flushes_per_class(self):
        pol = _warm_policy(fill_target=3, n=3)
        pending = [_req(cls=128, t=k * 0.001) for k in range(3)]
        pending += [_req(cls=256, t=0.0)]
        batches, _ = pol.decide(pending, now=0.002)
        assert ([0, 1, 2], "fill") in batches
        assert all(3 not in sel for sel, _ in batches)  # 256 class holds

    def test_stall_flushes_after_arrivals_dry_up(self):
        pol = _warm_policy(n=3)  # t_last=2ms, stall ~ 2 + 4*1 + 2 = 8ms
        pending = [_req(t=k * 0.001) for k in range(3)]
        batches, _ = pol.decide(pending, now=0.020)
        assert batches == [([0, 1, 2], "stall")]

    def test_budget_timeout_caps_the_hold(self):
        # Keep arrivals fresh (no stall) but let the oldest request age
        # past the budget: the flush cause is the latency bound.
        pol = AdaptiveFlushPolicy(fill_target=100, latency_budget_s=0.040,
                                  fallback_wait_s=0.005)
        for k in range(60):
            pol.note_arrival(128, k * 0.001)
        pending = [_req(t=k * 0.001) for k in range(42)]
        batches, _ = pol.decide(pending, now=0.0401)
        assert batches == [(list(range(42)), "timeout")]

    def test_interactive_preempts_a_holding_class(self):
        pol = _warm_policy(n=3)
        pending = [_req(t=0.001), _req(t=0.002, priority="interactive")]
        batches, _ = pol.decide(pending, now=0.003)
        assert batches == [([0, 1], "priority")]

    def test_bulk_only_class_never_stalls_or_times_out(self):
        pol = _warm_policy(n=3, budget=0.001)
        pending = [_req(t=0.0, priority="bulk")] * 2
        batches, wait = pol.decide(pending, now=1e9)
        assert batches == [] and wait is None

    def test_cold_class_falls_back_to_static_deadline(self):
        pol = AdaptiveFlushPolicy(fill_target=8, latency_budget_s=0.050,
                                  fallback_wait_s=0.005)
        pol.note_arrival(128, 0.0)  # one arrival: no dt estimate yet
        pending = [_req(t=0.0)]
        batches, wait = pol.decide(pending, now=0.004)
        assert batches == [] and wait == pytest.approx(0.005)
        batches, _ = pol.decide(pending, now=0.005)
        assert batches == [([0], "timeout")]


def test_resolve_policy_names_objects_and_errors():
    static = resolve_policy("static", min_fill=4, max_wait_s=0.005)
    assert isinstance(static, StaticFlushPolicy) and static.min_fill == 4
    adaptive = resolve_policy("adaptive", min_fill=4, max_wait_s=0.005)
    assert isinstance(adaptive, AdaptiveFlushPolicy)
    assert adaptive.latency_budget_s == pytest.approx(0.050)  # 10x max_wait
    custom = StaticFlushPolicy(min_fill=1, max_wait_s=1.0)
    assert resolve_policy(custom, min_fill=9, max_wait_s=9.0) is custom
    with pytest.raises(ValueError):
        resolve_policy("fancy", min_fill=4, max_wait_s=0.005)
    with pytest.raises(TypeError):
        resolve_policy(object(), min_fill=4, max_wait_s=0.005)


# ----------------------------------------------------------------------
# Deterministic bursty replay: adaptive vs static.
# ----------------------------------------------------------------------
def _simulate(policy, arrivals, horizon=10.0):
    """Drive `policy` through the dispatcher's decide loop against a
    synthetic arrival schedule [(t, cls, priority), ...]. Event-driven
    and fully deterministic: time advances only to the next arrival or
    the policy's own wait_until deadline. Returns (flush-cause Counter,
    flushed batch sizes, leftover pending)."""
    causes = collections.Counter()
    sizes = []
    pending = []
    k, now = 0, 0.0
    while True:
        while k < len(arrivals) and arrivals[k][0] <= now + 1e-12:
            t, cls, prio = arrivals[k]
            pending.append(_req(cls=cls, t=t, priority=prio))
            policy.note_arrival(cls, t)
            k += 1
        batches, wait_until = policy.decide(pending, now)
        if batches:
            keep = set(range(len(pending)))
            for sel, cause in batches:
                causes[cause] += 1
                sizes.append(len(sel))
                keep.difference_update(sel)
            pending = [pending[i] for i in sorted(keep)]
            continue
        nxt = arrivals[k][0] if k < len(arrivals) else None
        deadlines = [d for d in (nxt, wait_until) if d is not None]
        if not deadlines or now > horizon:
            return causes, sizes, pending
        now = max(now + 1e-9, min(deadlines))


def _bursty_schedule(n_bursts=12, burst=4, intra=0.001, gap=0.003):
    """Bursts of `burst` arrivals spaced `intra`, `gap` between bursts —
    sub-saturation traffic whose bursts individually undershoot the
    fill target but pair up inside any reasonable latency budget."""
    arr, t = [], 0.0
    for _ in range(n_bursts):
        for _ in range(burst):
            arr.append((t, 128, "normal"))
            t += intra
        t += gap
    return arr


def test_bursty_arrivals_adaptive_beats_static_on_timeouts():
    """The satellite's headline property: on the same bursty schedule
    the adaptive controller times out strictly less often than the
    static rule, reaches full slices, and flushes nothing twice."""
    arrivals = _bursty_schedule()
    fill = 8  # each 4-burst undershoots; two bursts make a full slice
    static = StaticFlushPolicy(min_fill=fill, max_wait_s=0.005)
    s_causes, s_sizes, s_left = _simulate(static, arrivals)
    adaptive = AdaptiveFlushPolicy(fill_target=fill, latency_budget_s=0.050,
                                   fallback_wait_s=0.005)
    a_causes, a_sizes, a_left = _simulate(adaptive, arrivals)

    assert s_causes["timeout"] > 0          # static burns its deadline
    assert s_causes["fill"] == 0            # ...and never fills a slice
    assert a_causes["timeout"] < s_causes["timeout"]
    assert a_causes["fill"] > 0             # adaptive reaches full slices
    assert max(a_sizes) > max(s_sizes)      # bigger batches, fewer flushes
    # Conservation: every arrival is flushed exactly once or left pending.
    assert sum(s_sizes) + len(s_left) == len(arrivals)
    assert sum(a_sizes) + len(a_left) == len(arrivals)
    # The JAX package's policies decide the same on the same schedule.
    js = _simulate(jax_policy.StaticFlushPolicy(min_fill=fill,
                                                max_wait_s=0.005), arrivals)
    ja = _simulate(jax_policy.AdaptiveFlushPolicy(
        fill_target=fill, latency_budget_s=0.050, fallback_wait_s=0.005),
        arrivals)
    assert (js[0], js[1], len(js[2])) == (s_causes, s_sizes, len(s_left))
    assert (ja[0], ja[1], len(ja[2])) == (a_causes, a_sizes, len(a_left))


# ----------------------------------------------------------------------
# DepthAutotuner units.
# ----------------------------------------------------------------------
class TestDepthAutotuner:
    def test_default_depth_before_any_observation(self):
        assert DepthAutotuner().depth() == 2

    def test_depth_is_ceil_of_finalize_over_enqueue(self):
        tuner = DepthAutotuner()
        tuner.note(("sig",), enqueue_s=0.001, finalize_s=0.0025)
        assert tuner.signature_depth(("sig",)) == 3  # ceil(2.5)

    def test_depth_clamps_both_ends(self):
        tuner = DepthAutotuner(min_depth=1, max_depth=4)
        tuner.note(("heavy",), enqueue_s=0.001, finalize_s=1.0)
        assert tuner.signature_depth(("heavy",)) == 4
        tuner.note(("light",), enqueue_s=0.010, finalize_s=0.001)
        assert tuner.signature_depth(("light",)) == 1

    def test_service_depth_is_max_over_signatures(self):
        tuner = DepthAutotuner()
        tuner.note(("a",), 0.001, 0.001)   # depth 1
        tuner.note(("b",), 0.001, 0.0035)  # depth 4
        assert tuner.depth() == 4
        assert set(tuner.snapshot()) == {"('a',)", "('b',)"}

    def test_ewma_converges_to_the_new_regime(self):
        tuner = DepthAutotuner()
        tuner.note(("s",), 0.001, 0.004)   # starts at depth 4
        for _ in range(40):                # regime change: fetch got cheap
            tuner.note(("s",), 0.001, 0.0005)
        assert tuner.signature_depth(("s",)) == 1


# ----------------------------------------------------------------------
# Service-level controller tests under an injected fake clock.
# ----------------------------------------------------------------------
class FakeClock:
    """A manually advanced service clock (seconds)."""

    def __init__(self, t=0.0):
        self.t = t

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _pairs(n, L=50, seed=3):
    rng = np.random.default_rng(seed)
    reads = [rng.integers(0, 4, L).astype(np.int8) for _ in range(n)]
    refs = [r.copy() for r in reads]
    return reads, refs


def _engine(capacity=4):
    return AlignmentEngine(backend="reference", device="cpu",
                           capacity=capacity)


def _settle():
    """Give the real-time dispatcher poll (2ms) time to run a few
    scheduling rounds against the frozen fake clock."""
    time.sleep(0.05)


def test_stats_surface_all_flush_cause_counters():
    clock = FakeClock()
    with AlignmentService(_engine(), time_fn=clock) as svc:
        stats = svc.stats()
    for cause in FLUSH_CAUSES:
        assert stats[f"flush_{cause}"] == 0, cause


def test_static_holds_on_frozen_clock_then_times_out_on_advance():
    """With the service clock frozen no amount of real time may trigger
    the max-wait flush; advancing the fake clock past max_wait must."""
    reads, refs = _pairs(2)
    clock = FakeClock()
    svc = AlignmentService(_engine(capacity=64), max_wait_ms=10.0,
                           min_fill=64, time_fn=clock)
    try:
        futs = [svc.submit(q, r) for q, r in zip(reads, refs)]
        _settle()
        assert not any(f.done() for f in futs)
        assert svc.stats()["flush_timeout"] == 0
        clock.advance(0.011)  # past max_wait on the service clock
        for f in futs:
            f.result(timeout=60)
        stats = svc.stats()
        assert stats["flush_timeout"] == 1
        assert stats["flush_fill"] == 0
    finally:
        svc.close()


def test_adaptive_holds_where_static_times_out_then_fills():
    """Three warm 1ms-spaced arrivals, clock at 6ms: the static rule
    (max_wait 5ms) would have flushed a 3/4 batch; the adaptive
    controller holds, and the 4th arrival completes a fill flush with
    zero timeouts."""
    reads, refs = _pairs(4)
    clock = FakeClock()
    svc = AlignmentService(_engine(capacity=4), max_wait_ms=5.0,
                           policy="adaptive", time_fn=clock)
    try:
        futs = []
        for q, r in zip(reads[:3], refs[:3]):
            futs.append(svc.submit(q, r))
            _settle()  # dispatcher notes this arrival before the next
            clock.advance(0.001)
        clock.advance(0.003)  # now=6ms: past static max_wait, no stall yet
        _settle()
        assert not any(f.done() for f in futs)
        assert svc.stats()["dispatches"] == 0
        futs.append(svc.submit(reads[3], refs[3]))  # 4/4: fill
        for f in futs:
            f.result(timeout=60)
        stats = svc.stats()
        assert stats["flush_fill"] == 1
        assert stats["flush_timeout"] == 0
        assert stats["fill_ratio"] == pytest.approx(1.0)
    finally:
        svc.close()


def test_adaptive_stall_flush_when_the_burst_ends():
    """Same warm 3-arrival class, but the clock jumps far past the
    stall deadline (~8ms) while staying inside the latency budget: the
    controller flushes early with cause 'stall', not 'timeout'."""
    reads, refs = _pairs(3)
    clock = FakeClock()
    svc = AlignmentService(_engine(capacity=4), max_wait_ms=5.0,
                           policy="adaptive", time_fn=clock)
    try:
        futs = []
        for q, r in zip(reads, refs):
            futs.append(svc.submit(q, r))
            _settle()
            clock.advance(0.001)
        clock.advance(0.020)  # past stall, well inside the 50ms budget
        for f in futs:
            f.result(timeout=60)
        stats = svc.stats()
        assert stats["flush_stall"] == 1
        assert stats["flush_timeout"] == 0
        assert stats["flush_fill"] == 0
    finally:
        svc.close()


def test_interactive_preempts_batching_on_frozen_clock():
    """A held normal request is released the moment an interactive
    classmate arrives — no clock movement required."""
    reads, refs = _pairs(2)
    clock = FakeClock()
    svc = AlignmentService(_engine(capacity=64), max_wait_ms=10_000.0,
                           min_fill=64, time_fn=clock)
    try:
        f1 = svc.submit(reads[0], refs[0])
        _settle()
        assert not f1.done()
        f2 = svc.submit(reads[1], refs[1], priority="interactive")
        f1.result(timeout=60)
        f2.result(timeout=60)
        assert svc.stats()["flush_priority"] == 1
    finally:
        svc.close()


def test_bulk_waits_for_shutdown_not_the_wait_clock():
    """Bulk-only pending traffic ignores max_wait entirely (real clock,
    tiny max_wait): only the shutdown drain dispatches it."""
    reads, refs = _pairs(2)
    svc = AlignmentService(_engine(capacity=64), max_wait_ms=1.0,
                           min_fill=64)
    futs = [svc.submit(q, r, priority="bulk")
            for q, r in zip(reads, refs)]
    time.sleep(0.2)  # many max_wait periods
    assert not any(f.done() for f in futs)
    assert svc.stats()["dispatches"] == 0
    svc.close()
    stats = svc.stats()
    assert all(f.done() for f in futs)
    assert stats["flush_shutdown"] == 1
    assert stats["flush_timeout"] == 0
    assert stats["priority"]["bulk"]["completed"] == 2
