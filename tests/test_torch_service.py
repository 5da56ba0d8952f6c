"""`repro_torch.serve.AlignmentService` over the CPU engine against
one-shot `engine.align` and against the reference service; and the
host-side planning/simulation copies, same seed -> same arrays."""

import numpy as np
import pytest

from repro.configs.rapidx import CONFIG as JAX_CONFIG
from repro.core.batch import length_class as jax_length_class
from repro.core.batch import pad_group as jax_pad_group
from repro.core.batch import plan_buckets as jax_plan_buckets
from repro.core.engine import AlignmentEngine as JaxEngine
from repro.data.genome import ReadSimulator as JaxSimulator
from repro.data.genome import simulate_read_pairs as jax_simulate
from repro.serve import AlignmentService as JaxService
from repro_torch.configs.rapidx import CONFIG
from repro_torch.core.batch import length_class, pad_group, plan_buckets
from repro_torch.core.engine import AlignmentEngine
from repro_torch.data.genome import (ERROR_PROFILES, ReadSimulator,
                                     random_genome, simulate_read_pairs)
from repro_torch.serve import AlignmentService, ServiceMetrics
from torch_parity import JAX_SC, TORCH_SC, make_pairs

LENGTHS = (40, 150, 90, 41, 160, 35, 120, 140, 33, 100, 45, 155)


@pytest.mark.parametrize("policy", ["static", "adaptive"])
def test_service_matches_one_shot_and_reference_service(policy):
    reads, refs = make_pairs(51, LENGTHS)
    te = AlignmentEngine(backend="reference", device="cpu", sc=TORCH_SC,
                         capacity=4)
    je = JaxEngine(backend="reference", sc=JAX_SC, capacity=4)
    one_shot = te.align(reads, refs, collect_tb=True)
    opts = dict(collect_tb=True, max_wait_ms=2.0, policy=policy)
    with AlignmentService(te, **opts) as svc:
        futs = [svc.submit(rd, rf) for rd, rf in zip(reads, refs)]
        res = [f.result(timeout=120) for f in futs]
        stats = svc.stats()
    with JaxService(je, **opts) as jsvc:
        jres = [f.result(timeout=120) for f in
                [jsvc.submit(rd, rf) for rd, rf in zip(reads, refs)]]
    assert stats["completed"] == len(reads) and stats["bytes_fetched"] > 0
    assert stats["rejected"] == 0
    for p, (a, b) in enumerate(zip(res, jres)):
        assert set(a) == set(b)
        for key in a:
            if key == "cigar":
                assert a[key] == b[key] == one_shot["cigars"][p]
            else:
                assert int(a[key]) == int(b[key]) == int(one_shot[key][p])


def test_service_stream_and_engine_opts_default_to_the_card():
    reads, refs = make_pairs(52, LENGTHS[:6])
    te = AlignmentEngine(backend="reference", device="cpu", sc=TORCH_SC,
                         capacity=4)
    one_shot = te.align(reads, refs)
    with AlignmentService(te, max_wait_ms=1.0,
                          warmup=[(40, 40)]) as svc:
        got = list(svc.submit_stream(zip(reads, refs), window=3))
    assert [int(g["score"]) for g in got] == one_shot["score"].tolist()
    assert isinstance(svc.metrics, ServiceMetrics)
    # No engine given and no CPU asked for: the service's engine is built
    # for the card and must raise here, not carry on on the CPU.
    with pytest.raises(RuntimeError, match="cuda"):
        AlignmentService()


def test_planning_copies_match_reference():
    rng = np.random.default_rng(53)
    q_lens = rng.integers(1, 9000, 200)
    r_lens = np.maximum(q_lens + rng.integers(-40, 40, 200), 1)
    for kw in (dict(), dict(capacity=16, band_cap=400),
               dict(base_bandwidth=30)):
        ours = plan_buckets(q_lens, r_lens, **kw)
        theirs = jax_plan_buckets(q_lens, r_lens, **kw)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert vars(a.spec) == vars(b.spec)
            np.testing.assert_array_equal(a.indices, b.indices)
    for q, r in zip(q_lens[:50], r_lens[:50]):
        assert length_class(q, r) == jax_length_class(q, r)
    reads, refs = make_pairs(54, (30, 60, 47))
    spec = plan_buckets([60], [64], capacity=4)[0].spec
    jspec = jax_plan_buckets([60], [64], capacity=4)[0].spec
    for a, b in zip(pad_group(reads, refs, spec),
                    jax_pad_group(reads, refs, jspec)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert CONFIG.scoring == TORCH_SC
    assert [CONFIG.band_for(L) for L in (150, 2048, 8192)] == \
        [JAX_CONFIG.band_for(L) for L in (150, 2048, 8192)]


@pytest.mark.parametrize("profile", sorted(ERROR_PROFILES))
def test_read_simulator_same_seed_same_arrays(profile):
    genome = random_genome(5000, seed=3)
    ours = ReadSimulator(genome, profile, seed=4, rc_prob=0.3)
    theirs = JaxSimulator(genome, profile, seed=4, rc_prob=0.3)
    for L in (30, 120, 75):
        a, b = ours.sample(L), theirs.sample(L)
        np.testing.assert_array_equal(a.ref, b.ref)
        np.testing.assert_array_equal(a.read, b.read)
        assert (a.locus, a.strand) == (b.locus, b.strand)
    for a, b in zip(simulate_read_pairs(5, 40, profile, seed=6),
                    jax_simulate(5, 40, profile, seed=6)):
        np.testing.assert_array_equal(a, b)
