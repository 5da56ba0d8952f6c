"""Replicated serving tier of the port (`repro_torch.serve.router`):
routing, drain, failover, metrics — the JAX package's fault-injection
suite ported onto the port's router over CPU engines
(`backend="reference"`, `device="cpu"`). The fault injection and the
fake clock are host code and carry over unchanged. The claims under test
are the tier's robustness contract:

  * bit-identity — an N-replica router returns exactly what a
    single-engine `AlignmentService` returns, pipelined and persistent,
    and what the JAX package's router returns on the same seeded stream
    (the router only picks WHICH replica serves a request, never touches
    data);
  * slice routing — a length class stays pinned to one replica for a
    full dispatch slice, so no dispatch group ever straddles replicas;
  * crash failover — killing a replica's dispatcher mid-flight makes
    its never-dispatched requests complete bit-identically on the
    survivors (same Future objects), while requests already enqueued on
    the dead replica's device raise the dispatcher's error: every
    accepted future resolves exactly once, nothing hangs;
  * drain — under sustained load a drain finishes every accepted
    request, keeps the tier serving, and leaves the fill ratio
    unchanged; a drained-then-restarted replica reuses the SAME engine
    object and starts no kernel build, and its first request stays
    within the warm-start bound;
  * metrics — `stats()` aggregates exactly across replicas and keeps
    retired counters across restarts;
  * determinism hooks — the injected `time_fn` clock reaches every
    replica's flush controller.

Faults are injected through `FaultyEngine`, whose `_Ctl` events make a
dispatcher crash at a chosen pipeline stage: `fail_enqueue` kills the
flush before anything reaches the device (nothing may be lost),
`hold_finalize` + `fail_finalize` kills it with a group in flight
(exactly that group may be lost). All timing is handled by polling
observable state — no sleep-and-hope.
"""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.engine import AlignmentEngine as JaxEngine
from repro.serve import AlignmentRouter as JaxRouter
from repro_torch.core.engine import AlignmentEngine
from repro_torch.kernels import build
from repro_torch.launch import serve as serve_launcher
from repro_torch.serve import (AlignmentRouter, AlignmentService,
                               ServiceMetrics, aggregate_metrics)

#: The port's engine on the CPU: the routers' engine_opts.
CPU = dict(backend="reference", device="cpu")

SCALARS = ("score", "final_lo", "best_score", "best_i", "best_j")


def _mixed_pairs(n_pairs, lengths=(40, 90, 150), seed=3):
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    for k in range(n_pairs):
        L = lengths[k % len(lengths)]
        read = rng.integers(0, 4, L).astype(np.int8)
        ref = read.copy()
        mut = rng.integers(0, L, max(L // 20, 1))
        ref[mut] = (ref[mut] + 1) % 4
        reads.append(read)
        refs.append(ref)
    return reads, refs


def _wait(cond, timeout=60.0, what="condition"):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


class _Ctl:
    """Fault switchboard for one FaultyEngine."""

    def __init__(self):
        self.hold_finalize = threading.Event()  # cleared = block finalize
        self.hold_finalize.set()
        self.fail_enqueue = threading.Event()
        self.fail_finalize = threading.Event()


class FaultyEngine(AlignmentEngine):
    """Engine with deterministic crash injection: `fail_enqueue` raises
    before a group reaches the device (the whole flush is still
    undispatched), `hold_finalize`+`fail_finalize` raises with the
    group already enqueued (that group is truly lost)."""

    def __init__(self, ctl, **opts):
        super().__init__(**opts)
        self._ctl = ctl

    def enqueue_group(self, *args, **kwargs):
        if self._ctl.fail_enqueue.is_set():
            raise RuntimeError("injected enqueue fault")
        return super().enqueue_group(*args, **kwargs)

    def finalize_group(self, pd, **kwargs):
        assert self._ctl.hold_finalize.wait(timeout=120.0)
        if self._ctl.fail_finalize.is_set():
            raise RuntimeError("injected finalize fault")
        return super().finalize_group(pd, **kwargs)


def _faulty_router(n, *, capacity=4, **service_opts):
    ctls = [_Ctl() for _ in range(n)]

    def factory(i):
        return FaultyEngine(ctls[i], capacity=capacity, **CPU)

    router = AlignmentRouter(n, engine_factory=factory, trace_routes=True,
                             **service_opts)
    return router, ctls


# ----------------------------------------------------------------------
# Identity and routing invariants.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dispatch", ["pipelined", "persistent"])
def test_router_bit_identical_to_single_service(dispatch):
    """A 2-replica router returns exactly what a single-engine
    AlignmentService returns — every scalar, the band, the CIGAR — and
    what the JAX package's 2-replica router returns on the same seeded
    stream. The router adds placement, never computation."""
    reads, refs = _mixed_pairs(10)
    opts = dict(capacity=4, dispatch=dispatch)
    with AlignmentService(AlignmentEngine(**CPU, **opts),
                          collect_tb=True, max_wait_ms=2.0) as svc:
        single = [f.result(timeout=300) for f in
                  [svc.submit(q, r) for q, r in zip(reads, refs)]]
    with AlignmentRouter(2, engine_opts=dict(CPU, **opts), collect_tb=True,
                         max_wait_ms=2.0, seed=1) as router:
        routed = [f.result(timeout=300) for f in
                  [router.submit(q, r) for q, r in zip(reads, refs)]]
        assert router.stats()["replicas_serving"] == 2
        assert all(r.engine.device.type == "cpu"
                   for r in router.pool.replicas)
        # No card: no dispatcher stream.
        assert all(r.service.stream is None for r in router.pool.replicas)
    with JaxRouter(2, engine_opts=dict(backend="reference", **opts),
                   collect_tb=True, max_wait_ms=2.0, seed=1) as jrouter:
        jax_routed = [f.result(timeout=300) for f in
                      [jrouter.submit(q, r) for q, r in zip(reads, refs)]]
    for i in range(len(reads)):
        for k in SCALARS:
            assert int(routed[i][k]) == int(single[i][k]) \
                == int(jax_routed[i][k]), (i, k)
        assert int(routed[i]["band"]) == int(single[i]["band"]) \
            == int(jax_routed[i]["band"]), i
        assert routed[i]["cigar"] == single[i]["cigar"] \
            == jax_routed[i]["cigar"], i


def test_router_submit_stream_arrival_order():
    """submit_stream through the tier yields results in arrival order
    even though replicas complete their micro-batches independently."""
    reads, refs = _mixed_pairs(24, lengths=(30, 200, 60), seed=31)
    oracle = AlignmentEngine(**CPU, capacity=4).align(
        reads, refs)
    with AlignmentRouter(2, engine_opts=dict(CPU, capacity=4),
                         max_wait_ms=1.0) as router:
        out = list(router.submit_stream(zip(reads, refs)))
    assert len(out) == len(reads)
    for i in range(len(reads)):
        assert int(out[i]["score"]) == int(oracle["score"][i]), i


def test_dispatch_slices_never_straddle_replicas():
    """Per length class, every consecutive run of `slice_pairs`
    routing decisions lands on a single replica — the invariant that
    lets each replica's service always form full dispatch groups."""
    router = AlignmentRouter(3, engine_opts=dict(CPU, capacity=4),
                             max_wait_ms=1.0, trace_routes=True, seed=2)
    try:
        reads, refs = _mixed_pairs(24, lengths=(40, 200), seed=29)
        futs = [router.submit(q, r) for q, r in zip(reads, refs)]
        for f in futs:
            f.result(timeout=120)
    finally:
        router.close()
    assert len(router.route_trace) == len(reads)  # no retries happened
    per_cls = {}
    for cls, idx in router.route_trace:
        per_cls.setdefault(cls, []).append(idx)
    assert len(per_cls) == 2
    for cls, seq in per_cls.items():
        for k in range(0, len(seq), router.slice_pairs):
            chunk = seq[k:k + router.slice_pairs]
            assert len(set(chunk)) == 1, (cls, k, chunk)


# ----------------------------------------------------------------------
# Crash failover.
# ----------------------------------------------------------------------
def test_crash_mid_flight_loses_only_the_enqueued_group():
    """Kill replica 0's dispatcher with one group on the device and
    three requests still undispatched: the in-flight four raise the
    dispatcher's error, the undispatched three fail over to replica 1
    and resolve bit-identically through their ORIGINAL futures."""
    router, ctls = _faulty_router(2, capacity=4, max_wait_ms=10_000.0)
    reads, refs = _mixed_pairs(8, lengths=(60,), seed=13)
    oracle = AlignmentEngine(**CPU, capacity=4).align(
        reads, refs)
    try:
        replica0 = router.pool.replicas[0]
        router.drain(1)                    # force all traffic onto 0
        ctls[0].hold_finalize.clear()      # pin the group in flight
        doomed = [router.submit(reads[i], refs[i]) for i in range(4)]
        _wait(lambda: replica0.service.stats()["dispatches"] == 1,
              what="the doomed group to dispatch")
        stranded = [router.submit(reads[i], refs[i]) for i in range(4, 7)]
        router.restart(1)                  # the survivor
        ctls[0].fail_finalize.set()
        ctls[0].hold_finalize.set()        # release -> dispatcher dies
        _wait(lambda: not replica0.serving, what="replica 0 to die")
        _wait(lambda: router.reroutes == 3, what="failover handoff")

        # The enqueued group is truly lost: its futures carry the error.
        for f in doomed:
            with pytest.raises(RuntimeError, match="injected finalize"):
                f.result(timeout=60)
        # A same-class filler completes the survivors' dispatch slice.
        filler = router.submit(reads[7], refs[7])
        for i, f in zip((4, 5, 6, 7), stranded + [filler]):
            res = f.result(timeout=60)
            for k in SCALARS:
                assert int(res[k]) == int(oracle[k][i]), (i, k)

        st = router.stats()
        assert st["reroutes"] == 3
        assert st["routed"] == 8
        assert st["replicas"]["0"]["state"] == "dead"
        assert "injected finalize" in st["replicas"]["0"]["error"]
        assert st["replicas_serving"] == 1
    finally:
        router.close()


def test_crash_before_device_loses_nothing():
    """An enqueue-stage crash strands the whole flush before it reaches
    the device — every request fails over and completes; zero errors."""
    router, ctls = _faulty_router(2, capacity=4, max_wait_ms=10_000.0)
    reads, refs = _mixed_pairs(4, lengths=(60,), seed=37)
    oracle = AlignmentEngine(**CPU, capacity=4).align(
        reads, refs)
    try:
        replica0 = router.pool.replicas[0]
        router.drain(1)
        # Half a slice: pends on replica 0 (min_fill=4, huge max_wait).
        futs = [router.submit(reads[i], refs[i]) for i in range(2)]
        ctls[0].fail_enqueue.set()
        router.restart(1)
        # Completing the slice triggers the doomed flush; the class is
        # still pinned to replica 0 (mid-slice), so both land there.
        futs += [router.submit(reads[i], refs[i]) for i in range(2, 4)]
        _wait(lambda: not replica0.serving, what="replica 0 to die")
        for i, f in enumerate(futs):
            res = f.result(timeout=60)     # no losses — all fail over
            for k in SCALARS:
                assert int(res[k]) == int(oracle[k][i]), (i, k)
        assert router.stats()["reroutes"] == 4
    finally:
        router.close()


def test_death_with_no_survivors_fails_futures_then_restart_recovers():
    """With no healthy replica left, stranded futures fail promptly
    (never hang), submit raises, and a restart brings the tier back."""
    router, ctls = _faulty_router(1, capacity=4, max_wait_ms=10_000.0)
    reads, refs = _mixed_pairs(8, lengths=(60,), seed=41)
    oracle = AlignmentEngine(**CPU, capacity=4).align(
        reads, refs)
    try:
        ctls[0].fail_enqueue.set()
        futs = [router.submit(reads[i], refs[i]) for i in range(4)]
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=60)
        _wait(lambda: not router.pool.replicas[0].serving,
              what="the only replica to die")
        with pytest.raises(RuntimeError, match="no serving replicas"):
            router.submit(reads[0], refs[0])

        ctls[0].fail_enqueue.clear()
        router.restart(0)
        futs = [router.submit(reads[i], refs[i]) for i in range(4, 8)]
        for i, f in zip(range(4, 8), futs):
            assert int(f.result(timeout=60)["score"]) == \
                int(oracle["score"][i])
        assert router.pool.replicas[0].restarts == 1
    finally:
        router.close()


# ----------------------------------------------------------------------
# Drain and restart.
# ----------------------------------------------------------------------
def test_drain_under_load_completes_everything_fill_unchanged():
    """Draining a replica mid-stream: every accepted request resolves,
    the tier keeps serving on the survivor, and the aggregate fill
    ratio is unchanged (capacity 1 -> every dispatch runs full, so any
    drop below 1.0 would mean the drain padded or split a batch)."""
    router = AlignmentRouter(2, engine_opts=dict(CPU, capacity=1),
                             max_wait_ms=50.0, trace_routes=True, seed=3)
    reads, refs = _mixed_pairs(24, lengths=(60,), seed=17)
    oracle = AlignmentEngine(**CPU, capacity=1).align(
        reads, refs)
    try:
        futs = []
        for i in range(len(reads)):
            if i == 8:
                router.drain(0)    # blocks until replica 0 is parked
            futs.append(router.submit(reads[i], refs[i]))
        for i, f in enumerate(futs):
            assert int(f.result(timeout=120)["score"]) == \
                int(oracle["score"][i]), i
        st = router.stats()
        assert st["completed"] == len(reads)
        assert st["fill_ratio"] == 1.0
        assert st["replicas"]["0"]["state"] == "parked"
        assert st["replicas_serving"] == 1
        # Every post-drain routing decision went to the survivor.
        assert all(idx == 1 for _, idx in router.route_trace[8:])
    finally:
        router.close()


def test_drained_then_restarted_replica_reuses_its_engine(monkeypatch):
    """A restarted replica reuses the same engine object and re-runs the
    pool's warmup before accepting traffic: the restart starts no kernel
    build, and its first request stays within the warm-start bound
    against the tier's own steady-state latency."""
    router = AlignmentRouter(2, engine_opts=dict(CPU, capacity=4),
                             min_fill=1, max_wait_ms=1.0,
                             warmup=[(64, 64)])
    reads, refs = _mixed_pairs(12, lengths=(64,), seed=19)
    try:
        for f in [router.submit(q, r) for q, r in zip(reads, refs)]:
            f.result(timeout=120)
        steady_p50 = router.stats()["p50_ms"]

        engine = router.pool.replicas[0].engine

        def no_build(name, extra=()):
            raise AssertionError(f"a restart started an nvcc build of "
                                 f"{name}")
        monkeypatch.setattr(build, "_start", no_build)
        router.drain(0)
        router.restart(0)
        assert router.pool.replicas[0].engine is engine
        router.drain(1)            # force the next request onto 0
        t0 = time.perf_counter()
        router.submit(reads[0], refs[0]).result(timeout=120)
        first_ms = (time.perf_counter() - t0) * 1e3
        assert first_ms <= 2.0 * max(steady_p50, 25.0), \
            (first_ms, steady_p50)
        assert router.pool.replicas[0].restarts == 1
    finally:
        router.close()


def test_restart_requires_drain_and_drain_is_idempotent():
    router = AlignmentRouter(2, engine_opts=dict(CPU, capacity=2),
                             max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="drain it first"):
            router.restart(0)
        router.drain(0)
        router.drain(0)            # parked: a second drain is a no-op
        assert router.pool.replicas[0].state == "parked"
        router.restart(0)
        assert router.pool.replicas[0].serving
    finally:
        router.close()
    with pytest.raises(ValueError):
        AlignmentRouter(0)
    with pytest.raises(RuntimeError, match="closed"):
        router.submit([0, 1], [0, 1])


# ----------------------------------------------------------------------
# Metrics and determinism hooks.
# ----------------------------------------------------------------------
def test_aggregate_metrics_is_exact():
    """Counters sum, fill is recomputed from summed pair counts (not
    averaged ratios), percentiles are over the concatenated samples."""
    a, b = ServiceMetrics(), ServiceMetrics()
    a.record_dispatch(3, 4)
    b.record_dispatch(1, 4)
    a.record_results([0.010, 0.020], 100, priorities=["normal"] * 2)
    b.record_results([0.040], 50, priorities=["interactive"])
    for m in (a, b):
        m.record_submit()
    agg = aggregate_metrics([a, b])
    assert agg["submitted"] == 2 and agg["completed"] == 3
    assert agg["real_pairs"] == 4 and agg["padded_slots"] == 8
    assert agg["fill_ratio"] == 0.5        # 4/8, not mean(3/4, 1/4)
    assert agg["bytes_fetched"] == 150
    assert agg["p50_ms"] == pytest.approx(20.0)   # median of 10/20/40
    assert agg["priority"]["interactive"]["completed"] == 1
    assert agg["priority"]["normal"]["completed"] == 2


def test_router_stats_aggregate_and_survive_restart():
    """Tier stats sum the replicas exactly, expose per-replica gauges,
    and keep retired counters when a replica restarts."""
    router = AlignmentRouter(2, engine_opts=dict(CPU, capacity=4),
                             min_fill=1, max_wait_ms=1.0, seed=4)
    reads, refs = _mixed_pairs(12, lengths=(60,), seed=43)
    try:
        for f in [router.submit(q, r) for q, r in zip(reads, refs)]:
            f.result(timeout=120)
        st = router.stats()
        assert st["submitted"] == st["completed"] == 12
        assert st["routed"] == 12 and st["reroutes"] == 0
        assert set(st["replicas"]) == {"0", "1"}
        assert sum(r["completed"] for r in st["replicas"].values()) == 12
        assert st["dispatches"] == sum(
            r["dispatches"] for r in st["replicas"].values())
        assert st["p99_ms"] >= st["p50_ms"] > 0.0
        assert st["bytes_fetched"] > 0 and st["fill_ratio"] > 0.0

        router.drain(0)
        router.restart(0)
        st2 = router.stats()
        assert st2["completed"] == 12      # retired metrics retained
        assert st2["replicas"]["0"]["restarts"] == 1
    finally:
        router.close()


def test_injected_clock_reaches_every_replica():
    """`time_fn` plumbs through the router to each replica's flush
    controller: with the fake clock frozen a lone sub-min_fill request
    never times out (however much real time passes); advancing the
    clock past max_wait flushes it."""
    clock = {"t": 0.0}
    router = AlignmentRouter(2, engine_opts=dict(CPU, capacity=4),
                             min_fill=64, max_wait_ms=50.0,
                             time_fn=lambda: clock["t"])
    reads, refs = _mixed_pairs(1, lengths=(60,), seed=23)
    try:
        fut = router.submit(reads[0], refs[0])
        time.sleep(0.3)                    # real time; service clock frozen
        assert not fut.done()
        clock["t"] += 1.0                  # leap past the flush deadline
        res = fut.result(timeout=60)
        assert "score" in res
        assert router.stats()["flush_timeout"] == 1
    finally:
        router.close()


def test_launch_serve_replicas_on_the_cpu(capsys):
    """`launch.serve --replicas 2` streams its requests through an
    AlignmentRouter over two replicas (here on the CPU, asked for)."""
    args = ["--reads", "24", "--no-mesh", "--device", "cpu", "--backend",
            "reference", "--read-len", "60", "--max-wait-ms", "1"]
    scores, _ = serve_launcher.main(args)
    capsys.readouterr()
    routed, stats = serve_launcher.main(args + ["--replicas", "2"])
    out = capsys.readouterr().out
    assert "replicas=2" in out and "replicas_serving=2" in out
    assert "24 reads in" in out
    assert stats["replicas_serving"] == 2 and stats["completed"] == 24
    assert [int(s) for s in routed] == [int(s) for s in scores]


def test_service_and_router_report_their_engines_device():
    """`device` — what `ReadMapper` reads to place its chaining — is the
    engine's on a service and the first replica's on a router."""
    with AlignmentService(AlignmentEngine(**CPU)) as svc:
        assert svc.device == svc.engine.device == torch.device("cpu")
    router = AlignmentRouter(2, engine_opts=CPU)
    try:
        assert router.device == router.pool.replicas[0].engine.device
        assert router.device == torch.device("cpu")
    finally:
        router.close()


def test_launch_counters_are_exact_across_threads():
    """The replicas' dispatcher threads bump the wrappers' launch counters
    at once (`build.count`): every bump lands."""
    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.shapes = collections.Counter()

    def launch_many():
        for _ in range(20_000):
            build.count(wrapper, shapes=(256, 64))
    threads = [threading.Thread(target=launch_many) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 80_000
    assert wrapper.shapes == {(256, 64): 80_000}
