"""Read-mapping launcher — the full seed -> chain -> align pipeline.

Builds a minimizer index over a simulated reference, draws reads with
ground-truth loci from `ReadSimulator`, and maps them through a
`ReadMapper` backed by an `AlignmentService` (or, with `--replicas N`,
an `AlignmentRouter` over N replicas): seeding on the host, one
launch of the chaining kernel, and the candidate windows through the
engine's kernels. Because the simulator labels every read with its true
locus and strand, the run reports *accuracy* (recall to within the
alignment band) alongside throughput and the serving metrics.

    PYTHONPATH=src python -m repro_torch.launch.map --reads 200 \\
        --profile illumina --rc-prob 0.5

    PYTHONPATH=src python -m repro_torch.launch.map --reads 60 \\
        --profile pacbio --read-len 1000 --base-bandwidth 64 \\
        --dispatch persistent

    PYTHONPATH=src python -m repro_torch.launch.map --reads 200 \\
        --replicas 2

Runs on the card and exits with an error without one (`--device cpu
--backend reference` asks for the CPU explicitly).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs.rapidx import CONFIG as RAPIDX
from repro_torch.core.engine import AlignmentEngine
from repro_torch.data.genome import ReadSimulator, random_genome
from repro_torch.map import (MinimizerIndex, ReadMapper, STATUS_MAPPED,
                             STATUS_SEED_CAPPED)
from repro_torch.serve import AlignmentRouter, AlignmentService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=200,
                    help="number of simulated reads to map")
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--profile", default="illumina",
                    help="ReadSimulator error profile "
                         "(illumina/pacbio/ont_2d/...)")
    ap.add_argument("--rc-prob", type=float, default=0.5,
                    help="probability a simulated read is "
                         "reverse-complemented (strand truth labels)")
    ap.add_argument("--genome", type=int, default=500_000,
                    help="simulated reference length in bases")
    ap.add_argument("--seed", type=int, default=11,
                    help="genome seed; reads use seed+1")
    ap.add_argument("--k", type=int, default=13, help="minimizer k")
    ap.add_argument("--w", type=int, default=8,
                    help="minimizer window size")
    ap.add_argument("--max-occ", type=int, default=64,
                    help="occurrence cap: hot k-mers past this count "
                         "are withheld from seeding (flagged)")
    ap.add_argument("--window-pad", type=int, default=24,
                    help="reference padding around each chain-projected "
                         "candidate window")
    ap.add_argument("--capacity", type=int, default=32)
    ap.add_argument("--base-bandwidth", type=int, default=None,
                    help="engine band floor (long noisy reads want "
                         "a wider band, e.g. 64 for pacbio)")
    ap.add_argument("--xdrop", type=int, default=None,
                    help="X-drop threshold for retiring junk candidate "
                         "windows on-device")
    ap.add_argument("--dispatch", choices=("pipelined", "persistent"),
                    default="pipelined")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1 maps through an AlignmentRouter over N "
                         "single-engine replicas")
    ap.add_argument("--device", default="cuda",
                    help="where the engine and the chaining run "
                         "(default: the card)")
    ap.add_argument("--backend", default="auto",
                    help="'auto' (the CUDA kernels), 'cuda' or 'reference'")
    args = ap.parse_args(argv)
    if args.reads <= 0:
        ap.error("--reads must be positive")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")

    def make_engine(_i=0):
        return AlignmentEngine(
            backend=args.backend, device=args.device, sc=RAPIDX.scoring,
            capacity=args.capacity, dispatch=args.dispatch,
            xdrop=args.xdrop, base_bandwidth=args.base_bandwidth)

    engine = make_engine()

    genome = random_genome(args.genome, seed=args.seed)
    t0 = time.perf_counter()
    index = MinimizerIndex(genome, k=args.k, w=args.w,
                           max_occ=args.max_occ)
    t_index = time.perf_counter() - t0
    print(f"[map] index: genome={args.genome} k={args.k} w={args.w} "
          f"minimizers={index.num_minimizers} hot={index.num_hot} "
          f"({t_index:.2f}s)")
    print(f"[map] device={engine.device} backend={engine.backend_name} "
          f"dispatch={engine.dispatch} replicas={args.replicas}")

    sim = ReadSimulator(genome, args.profile, seed=args.seed + 1,
                        rc_prob=args.rc_prob)
    sim_reads = [sim.sample(args.read_len) for _ in range(args.reads)]

    service_opts = dict(mode="semiglobal", max_wait_ms=args.max_wait_ms)
    if args.replicas > 1:
        front = AlignmentRouter(
            args.replicas,
            engine_factory=lambda i: engine if i == 0 else make_engine(),
            **service_opts)
    else:
        front = AlignmentService(engine, **service_opts)

    t0 = time.perf_counter()
    with front:
        mapper = ReadMapper(index, front, window_pad=args.window_pad)
        results = mapper.map_batch([sr.read for sr in sim_reads])
        stats = front.stats()
    wall = time.perf_counter() - t0

    mapped = sum(1 for r in results if r.status == STATUS_MAPPED)
    capped = sum(1 for r in results if r.status == STATUS_SEED_CAPPED)
    correct = sum(1 for sr, r in zip(sim_reads, results)
                  if r.status == STATUS_MAPPED and r.strand == sr.strand
                  and abs(r.ref_start - sr.locus) <= max(r.band, 1))
    mapq_hi = sum(1 for r in results
                  if r.status == STATUS_MAPPED and r.mapq >= 30)
    print(f"[map] {args.reads} {args.profile} reads in {wall:.2f}s "
          f"({args.reads / wall:.0f} reads/s)")
    print(f"[map] recall={correct / args.reads:.4f} "
          f"mapped={mapped} seed_capped={capped} "
          f"unmapped={args.reads - mapped - capped} "
          f"mapq>=30: {mapq_hi}")
    print(f"[map] service: aligned={stats['completed']} "
          f"p50={stats['p50_ms']:.1f}ms p99={stats['p99_ms']:.1f}ms "
          f"fill_ratio={stats['fill_ratio']:.2f} "
          f"dispatches={stats['dispatches']}")
    return results


if __name__ == "__main__":
    main()
