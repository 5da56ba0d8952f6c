#!/usr/bin/env python
"""Time the banded flash attention's backward (B5-bwd) of a checkout of this
repository, and split its device time by kernel.

Usage: python tools/flash_bwd_times.py [--checkout DIR] [--reps N]

Imports ``repro_torch`` from ``DIR/src`` (this repository by default), so
that two designs can be timed on one card in one run: unpack an older
commit with ``git archive <commit> | tar -x -C _parent`` and pass
``--checkout _parent``. The kernels are built from that checkout's sources
into its own ``build/``. At the two shapes chip_smoke.py's
`flash_bwd_shapes` times (qwen3-0.6b's training shape, 4 x 16 q / 8 kv
heads x 4,096, causal; gemma3-27b's local layer, 1 x 32 / 16 x 32,768,
W 1,024; D 128, bf16, inputs from a generator seeded 23 in that order) it
prints one JSON line with, per shape:

- ``ms``: the mean time of one `flash_attention_bwd_tc_cuda` call over
  ``--reps`` calls back to back (CUDA events, behind a sleep kernel so that
  the host runs ahead);
- ``by_kernel``: for each kernel and memset of the call, its device ms per
  call, summed over the ``--reps`` calls of one torch.profiler window;
- ``fwd_with_lse_ms``: the forward kernel with its log-sum-exp, as the
  train step launches it, timed the same way;
- ``bound_ms``: 10*D FLOP per live pair at 989 TFLOP/s, or q, k, v, o, dO,
  lse read once and dq, dk, dv written once at 3.35 TB/s if longer;

and the prefill's forward (no log-sum-exp) at 1 x 32 / 16 x 32,768, causal
and W 1,024 (``prefill_ms``), the shapes of chip_smoke.py's `flash_checks`,
so that a change of the forward's source shows beside its parent.

Exits 1 when the profiler saw no device event, and with no CUDA device.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
SHAPES = (("qwen3_train_causal", (4, 16, 8, 4096, None)),
          ("gemma3_local_w1024", (1, 32, 16, 32768, 1024)))
D = 128


def live_pairs(B, Hq, T, W):
    W = T if W is None else min(W, T)
    return B * Hq * (W * (W + 1) // 2 + (T - W) * W)


def time_cuda(fn, reps):
    """Mean device ms of `fn` over `reps` calls behind a sleep kernel that
    covers twice the host's enqueue time."""
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * host_ms * reps, 2000) * 2e6))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def by_kernel(fn, reps):
    """Device ms per call of each kernel `fn` launches, from one profiler
    window of `reps` calls; None when the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            out[evt.name[:60]] = out.get(evt.name[:60], 0.0) \
                + evt.time_range.elapsed_us() / 1e3 / reps
    return out or None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=str(Path(__file__).parents[1]))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.environ.pop("REPRO_TORCH_BUILD_DIR", None)
    sys.path.insert(0, str(Path(args.checkout).resolve() / "src"))
    from repro_torch.kernels.local_attention import local_attention as la

    dev = torch.device("cuda", 0)
    rec: dict = {"checkout": args.checkout, "reps": args.reps, "shapes": []}
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(23)
        for name, (B, Hq, Hkv, T, W) in SHAPES:
            q, k, v, dout = (torch.randn(B, h, T, D, device=dev,
                                         generator=gen).bfloat16()
                             for h in (Hq, Hkv, Hkv, Hq))
            out, lse = la._tc_forward(q, k, v, W, True)

            def bwd():
                return la.flash_attention_bwd_tc_cuda(q, k, v, out, lse, dout,
                                                      window=W)
            ms = time_cuda(bwd, args.reps)
            kernels = by_kernel(bwd, args.reps)
            if kernels is None:
                print("the profiler saw no device event", file=sys.stderr)
                return 1
            fwd_ms = time_cuda(lambda: la._tc_forward(q, k, v, W, True),
                               args.reps)
            pairs = live_pairs(B, Hq, T, W)
            ops = 10 * D * pairs
            nbytes = 2 * (2 * q.numel() + 2 * k.numel()) * 2 \
                + q.numel() * 2 + 4 * B * Hq * T
            bound = max(ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            rec["shapes"].append({
                "shape": name, "q": list(q.shape), "kv": list(k.shape),
                "window": W, "ms": ms, "by_kernel": kernels,
                "fwd_with_lse_ms": fwd_ms, "bound_ms": bound,
                "tflop_per_s": ops / ms / 1e9})
            del q, k, v, dout, out, lse
            torch.cuda.empty_cache()

        gen = torch.Generator(device=dev).manual_seed(11)
        q = torch.randn(1, 32, 32768, D, device=dev, generator=gen).bfloat16()
        k, v = (torch.randn(1, 16, 32768, D, device=dev,
                            generator=gen).bfloat16() for _ in range(2))
        rec["prefill_ms"] = {
            str(W): time_cuda(lambda: la.flash_attention_tc_cuda(
                q, k, v, window=W), args.reps)
            for W in (None, 1024)}
    rec["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
