#!/usr/bin/env python
"""Time the RG-LRU scan kernel (B6) and its backward (B6-bwd) of a checkout
of this repository, and split their device time by kernel.

Usage: python tools/rglru_kernel_times.py [--checkout DIR] [--reps N]

Imports ``repro_torch.models.rglru`` from ``DIR/src`` (this repository by
default), so that two designs can be timed on one card in one run: unpack
an older commit with ``git archive <commit> | tar -x -C _parent`` and pass
``--checkout _parent``. The kernel is built from that checkout's sources
into its own ``build/``. At recurrentgemma-9b's prefill shape (1 x 32,768
x 4,096, bf16; inputs as chip_smoke.py's `rglru_inputs` makes them, seed
21) it prints one JSON line:

- ``ms``: the mean time of one `rglru_scan_cuda` call over ``--reps``
  calls back to back (`kernel_timing.time_cuda`: CUDA events, behind a
  sleep kernel so that the host runs ahead);
- ``by_kernel``: for each kernel and memset of the call, its device ms per
  call, summed over the ``--reps`` calls of one torch.profiler window;
- ``bound_ms``: each input read once and y written once at 3.35 TB/s;
- ``sfu_floor_ms``: six special-function operations per element at 16 an
  SM a clock, at the SM count torch reports and the highest SM clock
  nvidia-smi gives.

Where the checkout has B6-bwd (`rglru_scan_bwd_cuda`), also at
recurrentgemma-9b's training microbatch (2 x 4,096 x 4,096 bf16, random dy
and dh_last; seed 51), ``bwd``: the backward's ``ms`` and ``by_kernel``,
the forward's ``ms`` at that shape, and ``bound_ms`` (dy, wa, wx, x read
once, dwa, dwx, dx written once, and the forward's inclusive h per tile
and channel, at 3.35 TB/s).

Exits 1 when the profiler saw no device event, and with no CUDA device.
Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from kernel_timing import by_kernel, card, checkout_args, time_cuda

HBM_BYTES_PER_S = 3.35e12
SFU_PER_SM_CLOCK = 16
SFU_PER_ELEM = 6


def main() -> int:
    args = checkout_args(__doc__, 20)
    from repro_torch.models import rglru

    B, T, D, dev = 1, 32768, 4096, torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(21)
    wa, wx, x = (torch.randn(B, T, D, device=dev, generator=g)
                 .to(torch.bfloat16) for _ in range(3))
    lam = (0.01 + 0.49 * torch.rand(D, device=dev, generator=g)).to(
        torch.bfloat16)

    def call():
        return rglru.rglru_scan_cuda(wa, wx, x, lam)

    with torch.no_grad():
        ms = time_cuda(call, args.reps)
        kernels = by_kernel(call, args.reps)
    if kernels is None:
        print("the profiler saw no device event", file=sys.stderr)
        return 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    n = B * T * D
    nbytes = 4 * n * x.element_size() + D * lam.element_size() + B * D * 4
    rec = {
        "checkout": args.checkout, "shape": [B, T, D], "dtype": "bfloat16",
        "reps": args.reps, "ms": ms, "by_kernel": kernels,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "sfu_floor_ms": n * SFU_PER_ELEM / (sms * SFU_PER_SM_CLOCK * mhz
                                            * 1e6) * 1e3,
        "sms": sms, "max_sm_mhz": mhz}
    del wa, wx, x
    if hasattr(rglru, "rglru_scan_bwd_cuda"):
        rec["bwd"] = bwd_times(rglru, dev, args.reps)
        if rec["bwd"] is None:
            print("the profiler saw no device event", file=sys.stderr)
            return 1
    print(json.dumps({**rec, **card()}))
    return 0


def bwd_times(rglru, dev, reps):
    """B6-bwd at recurrentgemma-9b's training microbatch (module note);
    None when the profiler saw no device event."""
    B, T, D = 2, 4096, 4096
    g = torch.Generator(device=dev).manual_seed(51)
    wa, wx, x, dy = (torch.randn(B, T, D, device=dev, generator=g)
                     .to(torch.bfloat16) for _ in range(4))
    lam = (0.01 + 0.49 * torch.rand(D, device=dev, generator=g)).to(
        torch.bfloat16)
    dhl = torch.randn(B, D, device=dev, generator=g)
    with torch.no_grad():
        _, _, saved = rglru._forward_cuda(wa, wx, x, lam, None)

        def call():
            return rglru.rglru_scan_bwd_cuda(wa, wx, x, lam, None, saved, dy,
                                             dhl)
        ms = time_cuda(call, reps)
        kernels = by_kernel(call, reps)
        fwd_ms = time_cuda(lambda: rglru.rglru_scan_cuda(wa, wx, x, lam),
                           reps)
    if kernels is None:
        return None
    n = B * T * D
    ntiles = B * -(-T // rglru.KERNEL_CHUNK) * -(-D // rglru.KERNEL_CHANNELS)
    nbytes = 7 * n * 2 + 4 * ntiles * rglru.KERNEL_CHANNELS + 2 * D * 2 \
        + B * D * 4
    return {"shape": [B, T, D], "ms": ms, "by_kernel": kernels,
            "forward_ms": fwd_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


if __name__ == "__main__":
    sys.exit(main())
