"""Alignment serving launcher — the paper's co-processor role.

A thin client of the streaming `repro_torch.serve.AlignmentService`: a
simulated sequencer emits read/window pairs at an open-loop arrival
rate, the service's background dispatcher micro-batches them by length
class and drives the mesh-sharded AlignmentEngine's dispatch pipeline on
the GPUs (CUDA kernels, device decode, depth-k lookahead), and the run
reports the service metrics dict — requests/s, p50/p99 latency, batch
fill ratio, bytes fetched, flush causes.

By default the engine shards every dispatch slice over a mesh of all
visible cards (`launch.mesh.make_debug_mesh(data=torch.cuda.
device_count())`; one card: one shard). `--no-mesh` runs one device.
`--replicas N` (N > 1) serves the stream through the replicated tier
instead: a `repro_torch.serve.AlignmentRouter` over N single-engine
replicas, each dispatcher thread queuing its engine's work on a CUDA
stream of its own — scale-out by dispatcher count, where the mesh is
scale-up by device count, so the replicated path runs each replica
mesh-free.

    PYTHONPATH=src python -m repro_torch.launch.serve --reads 512

    PYTHONPATH=src python -m repro_torch.launch.serve --reads 512 \
        --rate 2000 --policy adaptive --warmup --no-mesh

    PYTHONPATH=src python -m repro_torch.launch.serve --reads 512 \
        --dispatch persistent --no-mesh

    PYTHONPATH=src python -m repro_torch.launch.serve --reads 512 \
        --no-mesh --replicas 2

Runs on the card and exits with an error without one (`--device cpu
--backend reference` asks for the CPU explicitly: a one-shard CPU mesh
unless `--no-mesh`). `--dispatch persistent` runs each flush as one
launch of the persistent wavefront and one of the table walker, on one
device (it implies `--no-mesh`).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.rapidx import CONFIG as RAPIDX
from repro_torch.core.engine import AlignmentEngine
from repro_torch.data.genome import ReadSimulator, random_genome
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.serve import AlignmentRouter, AlignmentService


def main(argv=None):
    """Serve the stream; returns (each request's score, the service's or
    router's stats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=512,
                    help="total requests to stream through the service")
    ap.add_argument("--read-len", type=int, default=150,
                    help="base read length; the stream mixes 1x/2x")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate in reads/s "
                         "(0 = closed loop, submit as fast as accepted)")
    ap.add_argument("--profile", default="illumina")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--policy", choices=("static", "adaptive"),
                    default="adaptive",
                    help="flush policy: 'adaptive' holds bursty "
                         "sub-saturation traffic for fill inside a latency "
                         "budget; 'static' is the fixed min_fill/max_wait "
                         "rule")
    ap.add_argument("--depth", default="auto",
                    help="pipeline depth (max in-flight groups): an "
                         "integer, or 'auto' to autotune against measured "
                         "enqueue/finalize latency")
    ap.add_argument("--dispatch", choices=("pipelined", "persistent"),
                    default="pipelined",
                    help="engine dispatch mode: 'pipelined' launches "
                         "per dispatch group slice, 'persistent' runs each "
                         "flush as one launch of each kernel (one "
                         "device, implies --no-mesh)")
    ap.add_argument("--warmup", action="store_true",
                    help="build/load the kernels and run one dummy "
                         "alignment before accepting traffic")
    ap.add_argument("--compilation-cache-dir", default=None,
                    help="accepted and unused: the kernels take every "
                         "dispatch signature as run-time arguments")
    ap.add_argument("--xdrop", type=int, default=None,
                    help="X-drop early-termination threshold: retire a "
                         "pair once its band max falls this far below "
                         "its running best (status != 0 in results; the "
                         "rejected counter / rejected_fraction gauge in "
                         "the metrics). Default: off")
    ap.add_argument("--no-mesh", action="store_true",
                    help="single-device engine (default: shard every "
                         "dispatch slice over all visible cards)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving-tier replica count: >1 routes the "
                         "stream through an AlignmentRouter over N "
                         "single-engine replicas with drain/failover, "
                         "each on a CUDA stream of its own (each replica "
                         "runs mesh-free)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default: the card)")
    ap.add_argument("--backend", default="auto",
                    help="'auto' (the CUDA kernels), 'cuda' or 'reference'")
    args = ap.parse_args(argv)
    if args.reads <= 0:
        ap.error("--reads must be positive")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")

    use_mesh = (not args.no_mesh and args.dispatch != "persistent"
                and args.replicas == 1)
    mesh = None
    if use_mesh:
        on_card = torch.device(args.device).type == "cuda"
        # At least one: with no card the mesh raises, naming why.
        n_dev = max(torch.cuda.device_count(), 1) if on_card else 1
        mesh = make_debug_mesh(data=n_dev, model=1, device=args.device)

    def make_engine(_i=0):
        return AlignmentEngine(
            backend=args.backend, device=args.device, sc=RAPIDX.scoring,
            capacity=args.capacity, mesh=mesh, dispatch=args.dispatch,
            xdrop=args.xdrop,
            compilation_cache_dir=args.compilation_cache_dir)

    engine = make_engine()
    kind = (torch.cuda.get_device_name(engine.device)
            if engine.device.type == "cuda" else "cpu")
    print(f"[serve] device={engine.device} ({kind}) "
          f"backend={engine.backend_name} shards={engine.num_shards} "
          f"mesh={'off' if mesh is None else mesh.shape} "
          f"dispatch={engine.dispatch} replicas={args.replicas} "
          f"policy={args.policy} scoring={RAPIDX.scoring.name}")

    genome = random_genome(1_000_000, seed=7)
    sim = ReadSimulator(genome, args.profile, seed=8)
    lengths = (args.read_len, args.read_len * 2)
    pairs = []
    for k in range(args.reads):
        ref, read = sim.sample(lengths[k % len(lengths)])
        pairs.append((read, ref))

    depth = args.depth if args.depth == "auto" else int(args.depth)
    # Warm up at the stream's maximum true lengths so the first request
    # pays neither the kernels' build nor their load.
    warmup = None
    if args.warmup:
        warmup = [(max(len(rd) for rd, _ in grp),
                   max(len(rf) for _, rf in grp))
                  for grp in (pairs[0::2], pairs[1::2]) if grp]

    service_opts = dict(max_wait_ms=args.max_wait_ms, policy=args.policy,
                        max_inflight_groups=depth, warmup=warmup)
    if args.replicas > 1:
        # Replica 0 reuses the probe engine; the rest get their own (an
        # engine is owned by exactly one dispatcher thread).
        front = AlignmentRouter(
            args.replicas,
            engine_factory=lambda i: engine if i == 0 else make_engine(),
            **service_opts)
    else:
        front = AlignmentService(engine, **service_opts)

    period = 1.0 / args.rate if args.rate > 0 else 0.0
    t0 = time.perf_counter()
    with front:
        futures = []
        for k, (read, ref) in enumerate(pairs):
            if period:  # open-loop: hold the offered arrival schedule
                target = t0 + k * period
                delay = target - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            futures.append(front.submit(read, ref))
        scores = [f.result()["score"] for f in futures]
        stats = front.stats()
    wall = time.perf_counter() - t0

    mean = sum(int(s) for s in scores) / len(scores)
    print(f"[serve] {args.reads} reads in {wall:.2f}s "
          f"({args.reads / wall:.0f} reads/s) mean_score={mean:.1f}")
    tier = (f" replicas_serving={stats['replicas_serving']}"
            if "replicas_serving" in stats else
            f" depth={stats['pipeline_depth']}")
    print(f"[serve] p50={stats['p50_ms']:.1f}ms p99={stats['p99_ms']:.1f}ms "
          f"fill_ratio={stats['fill_ratio']:.2f} "
          f"dispatches={stats['dispatches']} "
          f"bytes_fetched={stats['bytes_fetched']} "
          f"rejected={stats['rejected']}{tier} "
          f"flushes=fill:{stats['flush_fill']}/timeout:"
          f"{stats['flush_timeout']}/stall:{stats['flush_stall']}")
    return scores, stats


if __name__ == "__main__":
    main()
