#!/usr/bin/env python
"""Time the xLSTM kernels (B7, B8 and, where the checkout has them,
B7-bwd and B8-bwd) of a checkout of this repository.

Usage: python tools/xlstm_kernel_times.py [--checkout DIR] [--reps N]

Imports ``repro_torch.models.xlstm`` from ``DIR/src`` (this repository by
default), so that two trees can be timed on one card in one run: unpack an
older commit with ``git archive <commit> | tar -x -C _parent`` and pass
``--checkout _parent``. The kernels are built from that checkout's sources
into its own ``build/``. Prints one JSON line of mean ms per call over
``--reps`` calls back to back (`kernel_timing.time_cuda`: CUDA events,
behind a sleep kernel so that the host runs ahead), with random inputs
from fixed seeds:

- at xlstm-125m's prefill shape (1 x 4 heads x 32,768, head size 192;
  the launches a prefill makes): ``b7`` (the three passes as
  `mlstm_chunk_scan_cuda` runs them, chunk 64, f32) and ``b7_outputs``
  (its third pass alone), ``b8`` (`slstm_scan_cuda`, bf16 wx and R);
- at its training shape (4 x 4 x 4,096), where the checkout trains:
  ``b7_outputs_dot`` and ``b8_saved`` (the forwards keeping what their
  backwards read), ``b7_bwd`` and ``b8_bwd`` (`mlstm_chunk_scan_bwd_cuda`,
  `slstm_scan_bwd_cuda`), ``b7_bwd_by_kernel``, B7-bwd's device ms
  per call by pass kernel from one profiler window, and
  ``b8_bwd_by_kernel``, B8-bwd's device ms per call of its kernel and of
  dR's product (its GEMM and the copies around it) from one profiler
  window.

Exits 1 with no CUDA device. Imports no JAX.
"""

from __future__ import annotations

import json
import sys

import torch

from kernel_timing import by_kernel, card, checkout_args, time_cuda


def main() -> int:
    args = checkout_args(__doc__, 10)
    from repro_torch.models import xlstm

    dev = torch.device("cuda", 0)
    H, D, L = 4, 192, 64

    def mlstm_inputs(B, T, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(B, T, H, D, device=dev, generator=g)
                   .transpose(1, 2) for _ in range(3))
        it = torch.randn(B, T, H, device=dev, generator=g).transpose(1, 2)
        ft = torch.nn.functional.logsigmoid(
            torch.randn(B, T, H, device=dev, generator=g) + 1.0) \
            .transpose(1, 2)
        return q, k / D ** 0.5, v, it, ft, \
            xlstm.mlstm_state_init(B, H, D, device=dev)

    def slstm_inputs(B, T, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        wx = {gn: torch.randn(B, T, H * D, device=dev, generator=g)
              .to(torch.bfloat16) for gn in "zifo"}
        r = {gn: (torch.randn(H, D, D, device=dev, generator=g)
                  * D ** -0.5).to(torch.bfloat16) for gn in "zifo"}
        return wx, r, xlstm.slstm_state_init(B, H, D, device=dev)

    out = {"checkout": args.checkout, "reps": args.reps, **card()}
    with torch.no_grad():
        q, k, v, it, ft, st = mlstm_inputs(1, 32768, 24)
        work, scal = xlstm.mlstm_chunk_states_cuda(k, v, it, ft, L)
        xlstm.mlstm_state_scan_cuda(work, scal, st)
        out["b7"] = time_cuda(lambda: xlstm.mlstm_chunk_scan_cuda(
            q, k, v, it, ft, st, L), args.reps)
        out["b7_outputs"] = time_cuda(lambda: xlstm.mlstm_chunk_outputs_cuda(
            q, k, v, it, ft, work, scal, L), args.reps)
        del q, k, v, it, ft, work, scal
        wx, r, st8 = slstm_inputs(1, 32768, 27)
        out["b8"] = time_cuda(lambda: xlstm.slstm_scan_cuda(wx, r, st8),
                          args.reps)
        if hasattr(xlstm, "MLSTMChunkScan"):
            q, k, v, it, ft, st = mlstm_inputs(4, 4096, 41)
            work, scal = xlstm.mlstm_chunk_states_cuda(k, v, it, ft, L)
            s1 = xlstm.mlstm_state_scan_cuda(work, scal, st)
            h, dot = xlstm.mlstm_chunk_outputs_cuda(
                q, k, v, it, ft, work, scal, L, with_dot=True)
            out["b7_outputs_dot"] = time_cuda(
                lambda: xlstm.mlstm_chunk_outputs_cuda(
                    q, k, v, it, ft, work, scal, L, with_dot=True),
                args.reps)
            dh = torch.randn_like(h)

            def b7_bwd():
                return xlstm.mlstm_chunk_scan_bwd_cuda(
                    q, k, v, it, ft, h, dot, work, scal, s1["C"], s1["n"],
                    dh, None, None, None, L)
            out["b7_bwd"] = time_cuda(b7_bwd, args.reps)
            out["b7_bwd_by_kernel"] = by_kernel(b7_bwd, args.reps)
            del q, k, v, it, ft, work, scal, h, dot, dh
            wx, r, st8 = slstm_inputs(4, 4096, 45)
            h, _, saved = xlstm.slstm_scan_cuda(wx, r, st8, with_saved=True)
            out["b8_saved"] = time_cuda(lambda: xlstm.slstm_scan_cuda(
                wx, r, st8, with_saved=True), args.reps)
            dh = torch.randn_like(h)
            rs = [r[gn] for gn in "zifo"]

            def b8_bwd():
                return xlstm.slstm_scan_bwd_cuda(
                    rs, st8["h"], st8["c"], st8["n"], st8["m"], h, saved,
                    dh, None, None, None, None)
            out["b8_bwd"] = time_cuda(b8_bwd, args.reps)
            out["b8_bwd_by_kernel"] = by_kernel(b8_bwd, args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
