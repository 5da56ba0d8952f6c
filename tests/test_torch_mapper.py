"""The read-mapping path of `repro_torch` on the CPU against the JAX
package: the minimizer index (a numpy copy), `ReadMapper.map_batch`
through pipelined and persistent engines, and the `launch.map` entry
point. Tolerance 0: every `MapResult` field equal."""

import dataclasses

import numpy as np
import pytest

from repro.core.engine import AlignmentEngine as JaxEngine
from repro.data.genome import ReadSimulator, random_genome
from repro.map import MinimizerIndex as JaxIndex
from repro.map import ReadMapper as JaxMapper
from repro.map.index import minimizers as jax_minimizers
from repro.serve import AlignmentService as JaxService
from repro_torch.core.engine import AlignmentEngine
from repro_torch.launch import map as map_launcher
from repro_torch.map import (STATUS_MAPPED, STATUS_SEED_CAPPED,
                             MinimizerIndex, ReadMapper, minimizers)
from repro_torch.serve import AlignmentService


def test_minimizer_index_arrays_equal_jax():
    genome = random_genome(30_000, seed=12)
    for k, w, max_occ in ((13, 8, 64), (9, 5, 2)):
        ji = JaxIndex(genome, k=k, w=w, max_occ=max_occ)
        ti = MinimizerIndex(genome, k=k, w=w, max_occ=max_occ)
        for name in ("_keys", "_starts", "_ends", "_pos"):
            a, b = getattr(ji, name), getattr(ti, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (ji.num_minimizers, ji.num_hot) == \
            (ti.num_minimizers, ti.num_hot)
        sim = ReadSimulator(genome, "illumina", seed=13, rc_prob=0.5)
        for _ in range(5):
            read = sim.sample(200).read
            for x, y in zip(jax_minimizers(read, k, w),
                            minimizers(read, k, w)):
                np.testing.assert_array_equal(x, y)
            a, b = ji.lookup(read), ti.lookup(read)
            np.testing.assert_array_equal(a.q_pos, b.q_pos)
            np.testing.assert_array_equal(a.r_pos, b.r_pos)
            assert (a.capped, a.total) == (b.capped, b.total)
    # Hot-only seeds are flagged the same way.
    motif = np.asarray([0, 1, 2, 3, 1, 0, 3, 2], np.int8)
    hot = np.tile(motif, 400)
    a = JaxIndex(hot, k=8, w=4, max_occ=4).lookup(hot[100:200])
    b = MinimizerIndex(hot, k=8, w=4, max_occ=4).lookup(hot[100:200])
    assert (a.capped, a.total, a.q_pos.size) == \
        (b.capped, b.total, b.q_pos.size)


def _map_jax(genome, reads, **engine_kw):
    engine = JaxEngine(backend="reference", capacity=8, **engine_kw)
    with JaxService(engine, mode="semiglobal", collect_tb=True,
                    max_wait_ms=2.0) as svc:
        return JaxMapper(JaxIndex(genome, k=13, w=8), svc).map_batch(reads)


def _map_port(genome, reads, **engine_kw):
    engine = AlignmentEngine(backend="reference", device="cpu", capacity=8,
                             **engine_kw)
    with AlignmentService(engine, mode="semiglobal", collect_tb=True,
                          max_wait_ms=2.0) as svc:
        st = {}
        out = ReadMapper(MinimizerIndex(genome, k=13, w=8),
                         svc).map_batch(reads, stats=st)
    assert set(st) == {"seed_s", "chain_s", "align_s"}
    return out


def _assert_same_results(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_map_batch_matches_jax_pipelined_and_persistent():
    genome = random_genome(60_000, seed=11)
    sim = ReadSimulator(genome, "illumina", seed=5, rc_prob=0.5)
    reads = [sim.sample(150).read for _ in range(10)]
    # A read from another genome (no seeds) rides along.
    reads.append(random_genome(150, seed=99))
    want = _map_jax(genome, reads, xdrop=400)
    for dispatch in ("pipelined", "persistent"):
        got = _map_port(genome, reads, xdrop=400, dispatch=dispatch)
        _assert_same_results(want, got)
    assert sum(r.status == STATUS_MAPPED for r in got) == 10
    assert all(r.cigar for r in got[:10])


def test_map_batch_flags_hot_seeds_like_jax():
    motif = np.asarray([0, 1, 2, 3, 1, 0, 3, 2], np.int8)
    genome = np.tile(motif, 2_000)
    reads = [genome[64:200].copy()]
    engine = AlignmentEngine(backend="reference", device="cpu")
    with AlignmentService(engine, mode="semiglobal") as svc:
        [r] = ReadMapper(MinimizerIndex(genome, k=8, w=4, max_occ=4),
                         svc).map_batch(reads)
    assert r.status == STATUS_SEED_CAPPED
    with AlignmentService(engine, mode="global") as svc:
        with pytest.raises(ValueError, match="semiglobal"):
            ReadMapper(MinimizerIndex(genome, k=8, w=4), svc)


def test_launch_map_runs_on_the_cpu(capsys):
    args = ["--reads", "6", "--genome", "30000", "--device", "cpu",
            "--backend", "reference", "--dispatch", "persistent",
            "--capacity", "8"]
    results = map_launcher.main(args)
    out = capsys.readouterr().out
    assert len(results) == 6 and "recall=" in out and "[map] index" in out
    # Through the replicated tier: an AlignmentRouter over two replicas
    # maps every read as the single service does.
    routed = map_launcher.main(args + ["--replicas", "2"])
    out = capsys.readouterr().out
    assert "replicas=2" in out and "recall=" in out
    assert routed == results
