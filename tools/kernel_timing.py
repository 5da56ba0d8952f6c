"""What the kernel-timing tools share: the ``--checkout`` import, CUDA-event
timing behind a sleep kernel, device time by kernel from one profiler
window, and the card's name and power limit.

A tool calls ``args = checkout_args(__doc__, reps)`` first; after it,
``repro_torch`` imports from ``args.checkout``'s ``src`` (this repository
by default) and builds its kernels into that checkout's own ``build/``.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import torch


def checkout_args(doc: str, reps: int) -> argparse.Namespace:
    """Parses ``--checkout DIR`` and ``--reps N``; exits 1 with no CUDA
    device; puts ``DIR/src`` first on the import path."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--checkout", default=str(Path(__file__).parents[1]))
    ap.add_argument("--reps", type=int, default=reps)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    os.environ.pop("REPRO_TORCH_BUILD_DIR", None)
    sys.path.insert(0, str(Path(args.checkout).resolve() / "src"))
    return args


def time_cuda(fn, reps: int) -> float:
    """Mean device ms of `fn` over `reps` calls back to back, behind a
    sleep kernel that covers twice the host's enqueue time, so that the
    host runs ahead. The first call builds and warms."""
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


def by_kernel(fn, reps: int):
    """Device ms per call of each kernel and memset `fn` launches, summed
    over one profiler window of `reps` calls; None when the profiler saw
    no device event."""
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


def card() -> dict:
    """The card's name as torch gives it, and name and power limit as
    nvidia-smi gives them."""
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]}
