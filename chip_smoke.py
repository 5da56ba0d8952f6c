#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--quick]

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card (`torch.equal`,
tolerance 0 — integer DP), then drives the port's main path through its
entry points at a real stream size: one ragged `AlignmentEngine.align`
request (65,536 short pairs, 2,048 at 2 kbp, 256 in the 8192 bucket) and
an `AlignmentService` that answers 33,280 requests. Every phase prints one
JSON line; any failed check raises, so the exit code is non-zero. Without
a CUDA device the script exits 1 and prints no result. The last line of
standard output is the device record.

`--quick` builds the kernels (printing registers and shared memory per
kernel), runs a reduced kernel matrix and stops: a first check of a
changed kernel.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False — "
                     "this script needs one CUDA device\n")
    sys.exit(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import banded  # noqa: E402
from repro_torch.core import traceback_device as tbd  # noqa: E402
from repro_torch.core.batch import pad_group, plan_buckets  # noqa: E402
from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.core.full_dp import cigar_score, full_dp_score  # noqa: E402
from repro_torch.core.scoring import MINIMAP2  # noqa: E402
from repro_torch.data.genome import ERROR_PROFILES, random_genome  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.banded_dp.banded_dp import banded_align_cuda  # noqa: E402
from repro_torch.serve import AlignmentService  # noqa: E402

DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM and
# 67 TFLOP/s float32 outside the tensor cores. That float32 figure counts
# 128 lanes per SM and two operations per fused multiply-add; int32 has 64
# lanes per SM and one operation per instruction, a quarter of it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# int32 operations per band cell and wavefront step, counted from the plain
# version's step (selects, compares, adds, maxima, index clamps, flag
# packing, reductions), and per traceback step of the walker.
WAVEFRONT_OPS_PER_CELL = 80
WALKER_OPS_PER_STEP = 60


def emit(tag: str, obj: dict) -> None:
    print(json.dumps({tag: obj}, default=float), flush=True)


# ---------------------------------------------------------------------------
# Bulk read streams: the error model of `repro_torch.data.genome` (i.i.d.
# per-base deletion / insertion / substitution at the profile's rates),
# vectorised over the whole stream.
# ---------------------------------------------------------------------------

def bulk_pairs(genome, num, ref_len, profile, rng):
    rates = ERROR_PROFILES[profile]
    starts = rng.integers(0, len(genome) - ref_len, size=num)
    refs = genome[starts[:, None] + np.arange(ref_len)[None, :]]
    roll = rng.random((num, ref_len))
    dele = roll < rates["del"]
    ins = ~dele & (roll < rates["del"] + rates["ins"])
    sub = ~dele & ~ins & (roll < rates["del"] + rates["ins"] + rates["sub"])
    base = np.where(sub, (refs + 1 + rng.integers(0, 3, refs.shape)) % 4,
                    refs).astype(np.int8)
    counts = np.where(dele, 0, np.where(ins, 2, 1))
    ends = np.cumsum(counts, axis=1)
    lens = ends[:, -1]
    out = np.full((num, int(lens.max()) + 1), 4, np.int8)
    rows = np.broadcast_to(np.arange(num)[:, None], refs.shape)
    keep = ~dele
    out[rows[keep], (ends - 1)[keep]] = base[keep]
    out[rows[ins], (ends - 2)[ins]] = rng.integers(
        0, 4, int(ins.sum())).astype(np.int8)
    reads = [out[p, :max(int(lens[p]), 1)] for p in range(num)]
    return reads, [refs[p] for p in range(num)]


def padded_group(reads, refs, capacity):
    """One planned length class of (reads, refs) as padded arrays."""
    groups = plan_buckets([len(x) for x in reads], [len(x) for x in refs],
                          capacity=capacity)
    assert len(groups) == 1, [g.spec for g in groups]
    spec = groups[0].spec
    q, r, n, m = pad_group(reads, refs, spec, pad_multiple=1)
    return spec, q, r, n, m


# ---------------------------------------------------------------------------
# Kernel vs plain version.
# ---------------------------------------------------------------------------

def time_cuda(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_host(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def max_abs_diff(a: dict, b: dict) -> int:
    worst = 0
    for key in a:
        assert a[key].shape == b[key].shape, (key, a[key].shape, b[key].shape)
        assert a[key].dtype == b[key].dtype, (key, a[key].dtype, b[key].dtype)
        if a[key].numel():
            d = (a[key].to(torch.int64) - b[key].to(torch.int64)).abs().max()
            worst = max(worst, int(d))
    return worst


def check_case(q, r, n, m, **kw):
    """Wavefront kernel vs plain on one case; with traceback also the
    walker kernel vs its plain version on the kernel's planes. Returns
    (max_abs_err wavefront, max_abs_err walker or None)."""
    ker = banded_align_cuda(q, r, n, m, sc=MINIMAP2, **kw)
    torch.cuda.synchronize()
    ref = banded.banded_align_batch(q, r, n, m, sc=MINIMAP2, **kw)
    torch.cuda.synchronize()
    err = assert_equal(ref, ker, f"wavefront {kw}")
    if not kw["collect_tb"]:
        return err, None
    band, mode = kw["band"], kw["mode"]
    dk = tbd.device_decode_result(ker, n, m, band=band, mode=mode)
    torch.cuda.synchronize()
    dp = tbd.device_decode_result(ker, n, m, band=band, mode=mode,
                                  walker=tbd.decode_packed_tb_plain)
    torch.cuda.synchronize()
    keys = ("cig_ops", "cig_runs", "cig_len")
    werr = assert_equal({k: dp[k] for k in keys}, {k: dk[k] for k in keys},
                        f"walker {kw}")
    return err, werr


def wavefront_bound(n, m, N, Lq, Lr, T, band, collect_tb):
    """Least time for the wavefront on these inputs: every pair's true
    n + m steps of `band` cells; q, r, n, m read once, outputs written
    once."""
    steps = int((n.astype(np.int64) + m).sum())
    ops = steps * band * WAVEFRONT_OPS_PER_CELL
    nbytes = N * (Lq + Lr) + 8 * N + 6 * 4 * N
    if collect_tb:
        nbytes += N * T * ((band + 1) // 2) + 4 * N * (T + 1)
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def walker_bound(path_steps, N, T):
    """Least time for the walker: per traceback step three flag bytes and
    three band offsets read; the RLE planes and lengths written once."""
    ops = path_steps * WALKER_OPS_PER_STEP
    nbytes = path_steps * (3 + 3 * 4) + 8 * N + N * T * 5 + 4 * N
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def assert_equal(ref: dict, ker: dict, what: str) -> int:
    err = max_abs_diff(ref, ker)
    for key in ref:
        if not torch.equal(ref[key], ker[key]):
            raise AssertionError(f"{what}: kernel != plain on {key!r}")
    return err


def shape_timing(name, spec, q, r, n, m, reps):
    """Both kernels at one main-path slice: held against their plain
    versions, and timed (kernel: CUDA events over `reps` launches; plain:
    host clock around one synchronised call)."""
    qd, rd, nd, md = (torch.from_numpy(a).to(DEV) for a in (q, r, n, m))
    N = q.shape[0]
    kw = dict(sc=MINIMAP2, band=spec.band, adaptive=True, collect_tb=True,
              mode="global", t_max=spec.t_max)
    out = banded_align_cuda(qd, rd, nd, md, **kw)
    torch.cuda.synchronize()
    wf_plain_ms, ref = time_host(
        lambda: banded.banded_align_batch(qd, rd, nd, md, **kw))
    wf_err = assert_equal(ref, out, f"wavefront at {name}")
    wf_ms = time_cuda(lambda: banded_align_cuda(qd, rd, nd, md, **kw), reps)

    tb, los = out["tb"], out["los"]
    keys = ("cig_ops", "cig_runs", "cig_len")
    rle = tbd.decode_packed_tb_cuda(tb, los, nd, md, band=spec.band)
    torch.cuda.synchronize()
    wk_plain_ms, rle_ref = time_host(lambda: tbd.decode_packed_tb_plain(
        tb, los, nd, md, band=spec.band))
    wk_err = assert_equal(dict(zip(keys, rle_ref)), dict(zip(keys, rle)),
                          f"walker at {name}")
    wk_ms = time_cuda(lambda: tbd.decode_packed_tb_cuda(
        tb, los, nd, md, band=spec.band), reps)

    path_steps = int(rle[1].sum())
    wf_bound, wf_by = wavefront_bound(n, m, N, q.shape[1], r.shape[1],
                                      spec.t_max, spec.band, True)
    wk_bound, wk_by = walker_bound(path_steps, N, spec.t_max)
    base = {"shape": name, "pairs": N, "q_len": spec.q_len,
            "r_len": spec.r_len, "band": spec.band, "t_max": spec.t_max}
    return (
        dict(base, ms=wf_ms, plain_ms=wf_plain_ms, bound_ms=wf_bound,
             bound_by=wf_by, max_abs_err=wf_err),
        dict(base, ms=wk_ms, plain_ms=wk_plain_ms, bound_ms=wk_bound,
             bound_by=wk_by, max_abs_err=wk_err, path_steps=path_steps))


def kernel_matrix(reads, refs, quick):
    """modes x adaptive x cell_dtype x xdrop x odd/even band x collect_tb
    at read length ~150 (64 pairs, a few of them unrelated sequences so
    that the xdrop rule retires some)."""
    spec, q, r, n, m = padded_group(reads[:64], refs[:64], 64)
    rng = np.random.default_rng(5)
    q = q.copy()
    for p in (3, 17, 40):
        q[p, :n[p]] = rng.integers(0, 4, n[p])
    n = n.copy()
    m = m.copy()
    n[5], m[5] = 37, 52          # ragged: a short pair and a dummy pair
    n[6], m[6] = 1, 1
    qd, rd, nd, md = (torch.from_numpy(a).to(DEV) for a in (q, r, n, m))
    grid = list(itertools.product(
        ("global", "semiglobal"), (True, False), ("int32", "narrow"),
        (None, 25), (spec.band, spec.band + 1), (True, False)))
    if quick:
        grid = grid[::5]
    cases = retired = 0
    worst_wf = worst_wk = 0
    for mode, adaptive, cell_dtype, xdrop, band, collect_tb in grid:
        kw = dict(band=band, adaptive=adaptive, collect_tb=collect_tb,
                  mode=mode, t_max=spec.t_max, cell_dtype=cell_dtype,
                  xdrop=xdrop)
        err, werr = check_case(qd, rd, nd, md, **kw)
        worst_wf = max(worst_wf, err)
        if werr is not None:
            worst_wk = max(worst_wk, werr)
        if xdrop is not None:
            out = banded_align_cuda(qd, rd, nd, md, sc=MINIMAP2, **kw)
            retired += int((out["status"] != 0).sum())
        cases += 1
    assert retired > 0, "the xdrop cases retired no pair"
    # Wide bands (several warps per block, the widest the tests use).
    for band in (257, 400):
        err, werr = check_case(qd, rd, nd, md, band=band, adaptive=True,
                               collect_tb=True, mode="global",
                               t_max=spec.t_max, cell_dtype="int32",
                               xdrop=None)
        worst_wf, worst_wk = max(worst_wf, err), max(worst_wk, werr)
        cases += 1
    return cases, retired, worst_wf, worst_wk


# ---------------------------------------------------------------------------
# Main-path checks.
# ---------------------------------------------------------------------------

def consumed(cigar):
    q = sum(run for op, run in cigar if op in "MI")
    r = sum(run for op, run in cigar if op in "MD")
    return q, r


def check_consumed(out, reads, refs, mode, label):
    for p, cig in enumerate(out["cigars"]):
        assert cig is not None, (label, p)
        qn, rn = consumed(cig)
        assert qn == len(reads[p]), (label, p, qn, len(reads[p]))
        if mode == "global":
            assert rn == len(refs[p]), (label, p, rn, len(refs[p]))


def counts():
    return {"banded_dp": banded_align_cuda.launches,
            "traceback": tbd.decode_packed_tb_cuda.launches,
            "plain_banded": banded.banded_align_batch.calls,
            "plain_traceback": tbd.decode_packed_tb_plain.calls}


def zero_counts():
    banded_align_cuda.launches = 0
    tbd.decode_packed_tb_cuda.launches = 0
    banded.banded_align_batch.calls = 0
    tbd.decode_packed_tb_plain.calls = 0


def timed_align(engine, reads, refs, mode, label):
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.align(reads, refs, mode=mode, collect_tb=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = counts()
    rec = {"label": label, "mode": mode, "capacity": engine.capacity,
           "pairs": len(reads), "seconds": wall,
           "pairs_per_s": len(reads) / wall,
           "launches": {k: after[k] - before[k] for k in after}}
    return out, rec


def device_trace(fn):
    """Time `fn` on the host clock (second call), then run it again under
    torch.profiler and sum the device time of every kernel and copy by
    name: the device's busy share of the untraced wall time, and where
    it went (tracing slows the host, so the traced wall time is given
    apart). Returns "not measured" in place of the numbers when the
    trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                            # warm: pinned buffers, allocator
    wall_ms, _ = time_host(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms, _ = time_host(fn)
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        rec = by_name.setdefault(evt.name[:60], [0, 0.0])
        rec[0] += 1
        rec[1] += evt.time_range.elapsed_us()
    if not by_name:
        return {"device_busy_share": "not measured"}
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            "top": [{"name": k, "count": c, "ms": us / 1e3}
                    for k, (c, us) in top]}


def fetched_bytes_per_pair(engine, reads, refs):
    """One group through enqueue/finalize with the fetch counted."""
    groups = engine.plan([len(x) for x in reads], [len(x) for x in refs])
    total = 0
    for g in groups:
        pd = engine.enqueue_group([reads[i] for i in g.indices],
                                  [refs[i] for i in g.indices], g.spec,
                                  collect_tb=True)
        st: dict = {}
        engine.finalize_group(pd, stats=st)
        total += st["fetched_bytes"]
    return total / len(reads)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    t_start = time.perf_counter()
    torch.cuda.set_device(DEV)

    # ---- 1. device + build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    built = build.build_all(verbose=args.quick)
    if args.quick:
        print(built["log"], flush=True)
    emit("device", {"nvidia_smi": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "python": sys.version.split()[0],
                    "build_seconds": built["seconds"],
                    "built": built["built"]})

    rng = np.random.default_rng(args.seed)
    genome = random_genome(4_000_000, seed=args.seed + 1)
    n_short, n_mid, n_long = (4096, 64, 64) if args.quick \
        else (65536, 2048, 256)
    short = bulk_pairs(genome, n_short, 150, "illumina", rng)
    # Reference windows sized so that every PacBio-profile read (about
    # 4.5 % longer than its window) stays inside the 2048 / 8192 bucket.
    mid = bulk_pairs(genome, n_mid, 1900, "pacbio", rng)
    long_ = bulk_pairs(genome, n_long, 7680, "pacbio", rng)

    # ---- 2. kernels vs plain versions ----
    t0 = time.perf_counter()
    cases, retired, worst_wf, worst_wk = kernel_matrix(*short, args.quick)
    shapes = [("short_4096", short, 4096, 20), ("mid_64", mid, 64, 5),
              ("long_64", long_, 64, 3)]
    wf_shapes, wk_shapes = [], []
    for name, (reads, refs), cap, reps in shapes:
        spec, q, r, n, m = padded_group(reads[:cap], refs[:cap], cap)
        wf, wk = shape_timing(name, spec, q, r, n, m, reps)
        wf_shapes.append(wf)
        wk_shapes.append(wk)
        worst_wf = max(worst_wf, wf["max_abs_err"])
        worst_wk = max(worst_wk, wk["max_abs_err"])
    cases += len(shapes)
    check_counts = counts()
    emit("kernel_checks", {
        "seconds": time.perf_counter() - t0,
        "xdrop_retired_pairs": retired,
        "kernels": [
            {"name": "banded_dp", "cases": cases, "equal": True,
             "kernel_ms": wf_shapes[-1]["ms"],
             "plain_ms": wf_shapes[-1]["plain_ms"],
             "launches": check_counts["banded_dp"], "shapes": wf_shapes},
            {"name": "traceback", "cases": cases, "equal": True,
             "kernel_ms": wk_shapes[-1]["ms"],
             "plain_ms": wk_shapes[-1]["plain_ms"],
             "launches": check_counts["traceback"], "shapes": wk_shapes},
        ]})
    if args.quick:
        print(json.dumps({"ok": True, "quick": True}))
        return

    # ---- 3. engine: one ragged request, then the short class again ----
    zero_counts()
    eng64 = AlignmentEngine(backend="auto")           # capacity 64
    eng4k = AlignmentEngine(backend="auto", capacity=4096)
    assert eng64.backend_name == "cuda" and eng64.device.type == "cuda"
    eng64.warmup([(150, 150)], collect_tb=True)
    reads = short[0] + mid[0] + long_[0]
    refs = short[1] + mid[1] + long_[1]
    runs = []
    out_all, rec = timed_align(eng64, reads, refs, "global",
                                  "ragged request, all three classes")
    runs.append(rec)
    check_consumed(out_all, reads, refs, "global", "ragged")
    assert np.isfinite(out_all["score"]).all()
    assert (out_all["status"] == 0).all()
    bands = sorted(set(out_all["band"].tolist()))

    out_s, rec = timed_align(eng4k, *short, "global",
                                "short class, card-sized capacity")
    runs.append(rec)
    assert np.array_equal(out_s["score"], out_all["score"][:n_short])
    assert out_s["cigars"] == out_all["cigars"][:n_short]

    out_sg, rec = timed_align(eng4k, *short, "semiglobal",
                                 "short class, semiglobal")
    runs.append(rec)
    check_consumed(out_sg, *short, "semiglobal", "semiglobal")

    # CIGARs re-score to the reported score (512 short pairs) ...
    for p in range(0, n_short, n_short // 512):
        s = cigar_score(out_s["cigars"][p], short[0][p], short[1][p],
                        MINIMAP2)
        assert s == int(out_s["score"][p]), (p, s, int(out_s["score"][p]))
    # ... and the banded score equals the full DP's on >= 95 % of 64.
    hits = sum(int(out_s["score"][p]) == full_dp_score(
        short[0][p], short[1][p], MINIMAP2)
        for p in range(0, n_short, n_short // 64))
    assert hits >= 0.95 * 64, hits
    fetched = {
        "short_cap4096": fetched_bytes_per_pair(eng4k, short[0][:4096],
                                                short[1][:4096]),
        "long_cap64": fetched_bytes_per_pair(eng64, *long_)}
    traces = {
        "short_cap4096": device_trace(lambda: eng4k.align(
            short[0][:16384], short[1][:16384], collect_tb=True)),
        "long_cap64": device_trace(lambda: eng64.align(
            *long_, collect_tb=True))}
    emit("engine", {"runs": runs, "bands": bands, "traces": traces,
                    "rescored_pairs": 512, "full_dp_agree": hits / 64,
                    "fetched_bytes_per_pair": fetched,
                    "counts": counts()})

    # ---- 4. serve: closed loop over the same engine ----
    n_req, n_req_mid = 32768, 512
    mix150 = bulk_pairs(genome, n_req // 2, 150, "illumina", rng)
    mix300 = bulk_pairs(genome, n_req // 2, 300, "illumina", rng)
    s_reads = [x for pair in zip(mix150[0], mix300[0]) for x in pair] \
        + mid[0][:n_req_mid]
    s_refs = [x for pair in zip(mix150[1], mix300[1]) for x in pair] \
        + mid[1][:n_req_mid]
    before = counts()
    t0 = time.perf_counter()
    with AlignmentService(eng64, collect_tb=True,
                          max_inflight_groups="auto") as svc:
        futures = [svc.submit(rd, rf) for rd, rf in zip(s_reads, s_refs)]
        results = [f.result(timeout=600) for f in futures]
        svc_stats = svc.stats()
    serve_s = time.perf_counter() - t0
    after = counts()
    one_shot = eng4k.align(s_reads, s_refs, collect_tb=True)
    for p, res in enumerate(results):
        assert int(res["score"]) == int(one_shot["score"][p]), p
        assert res["cigar"] == one_shot["cigars"][p], p
    svc_stats.pop("priority", None)
    svc_stats.pop("depth_signatures", None)
    emit("serve", {"requests": len(results), "seconds": serve_s,
                   "requests_per_s": len(results) / serve_s,
                   "launches": {k: after[k] - before[k] for k in after},
                   "stats": svc_stats})

    # ---- 5. the main path went through the kernels ----
    final = counts()
    assert final["banded_dp"] > 0 and final["traceback"] > 0, final
    assert final["plain_banded"] == 0 and final["plain_traceback"] == 0, \
        final
    common = {"route": "cuda", "library_ms": None}
    wf, wk = wf_shapes[-1], wk_shapes[-1]
    print(json.dumps({"kernels": [
        dict(common, name="banded_dp",
             source="src/repro_torch/kernels/banded_dp/csrc/banded_dp.cu",
             replaces="src/repro/kernels/banded_dp/banded_dp.py:432",
             launches=final["banded_dp"], max_abs_err=worst_wf,
             ms=wf["ms"], plain_ms=wf["plain_ms"], bound_ms=wf["bound_ms"],
             bound_by=wf["bound_by"], shape=wf["shape"]),
        dict(common, name="traceback",
             source="src/repro_torch/core/csrc/traceback.cu",
             replaces="src/repro/core/traceback_device.py:43",
             launches=final["traceback"], max_abs_err=worst_wk,
             ms=wk["ms"], plain_ms=wk["plain_ms"], bound_ms=wk["bound_ms"],
             bound_by=wk["bound_by"], shape=wk["shape"]),
    ]}), flush=True)
    emit("total", {"seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
