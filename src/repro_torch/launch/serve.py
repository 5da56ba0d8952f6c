"""Alignment serving launcher — the paper's co-processor role.

A thin client of the streaming `repro_torch.serve.AlignmentService`: a
simulated sequencer emits read/window pairs at an open-loop arrival
rate, the service's background dispatcher micro-batches them by length
class and drives the AlignmentEngine's dispatch pipeline on the GPU
(CUDA kernels, device decode, depth-k lookahead), and the run reports the
service metrics dict — requests/s, p50/p99 latency, batch fill ratio,
bytes fetched, flush causes.

    PYTHONPATH=src python -m repro_torch.launch.serve --reads 512 \
        --rate 2000 --policy adaptive --warmup --no-mesh

Runs on the card and exits with an error without one (`--device cpu
--backend reference` asks for the CPU explicitly). Single device only:
without `--no-mesh`, with `--replicas N` (N > 1) or with `--dispatch
persistent` it exits with an error naming the ROADMAP item that ports
that mode (A9, A6, A5).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.rapidx import CONFIG as RAPIDX
from repro_torch.core.engine import AlignmentEngine
from repro_torch.data.genome import ReadSimulator, random_genome
from repro_torch.serve import AlignmentService


def main():
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
                    help="engine dispatch mode; 'persistent' is not "
                         "ported yet (ROADMAP A5)")
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
                    help="single-device engine; the only mode so far "
                         "(the mesh path is ROADMAP A9)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving-tier replica count; >1 is not ported "
                         "yet (ROADMAP A6)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default: the card)")
    ap.add_argument("--backend", default="auto",
                    help="'auto' (the CUDA kernels), 'cuda' or 'reference'")
    args = ap.parse_args()
    if args.reads <= 0:
        ap.error("--reads must be positive")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")

    if args.replicas > 1:
        ap.error("--replicas > 1 needs the replicated tier "
                 "(serve/router.py), not ported yet: ROADMAP A6")
    if args.dispatch == "persistent":
        ap.error("--dispatch persistent is not ported yet: ROADMAP A5")
    if not args.no_mesh:
        ap.error("the mesh path is not ported yet (ROADMAP A9): pass "
                 "--no-mesh")

    engine = AlignmentEngine(
        backend=args.backend, device=args.device, sc=RAPIDX.scoring,
        capacity=args.capacity, dispatch=args.dispatch, xdrop=args.xdrop,
        compilation_cache_dir=args.compilation_cache_dir)
    kind = (torch.cuda.get_device_name(engine.device)
            if engine.device.type == "cuda" else "cpu")
    print(f"[serve] device={engine.device} ({kind}) "
          f"backend={engine.backend_name} dispatch={engine.dispatch} "
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
    tier = f" depth={stats['pipeline_depth']}"
    print(f"[serve] p50={stats['p50_ms']:.1f}ms p99={stats['p99_ms']:.1f}ms "
          f"fill_ratio={stats['fill_ratio']:.2f} "
          f"dispatches={stats['dispatches']} "
          f"bytes_fetched={stats['bytes_fetched']} "
          f"rejected={stats['rejected']}{tier} "
          f"flushes=fill:{stats['flush_fill']}/timeout:"
          f"{stats['flush_timeout']}/stall:{stats['flush_stall']}")


if __name__ == "__main__":
    main()
