#!/usr/bin/env python
"""Time the banded flash attention's backwards (B5-bwd; the split-TF32
backward) and forwards of a checkout of this repository, and split the
backwards' device time by kernel.

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
  ``--reps`` calls back to back (`kernel_timing.time_cuda`: CUDA events,
  behind a sleep kernel so that the host runs ahead);
- ``by_kernel``: for each kernel and memset of the call, its device ms per
  call, summed over the ``--reps`` calls of one torch.profiler window;
- ``fwd_with_lse_ms``: the forward kernel with its log-sum-exp, as the
  train step launches it, timed the same way;
- ``bound_ms``: 10*D FLOP per live pair at 989 TFLOP/s, or q, k, v, o, dO,
  lse read once and dq, dk, dv written once at 3.35 TB/s if longer;

and the prefill's forward (no log-sum-exp) at 1 x 32 / 16 x 32,768, causal
and W 1,024 (``prefill_ms``), the shapes of chip_smoke.py's `flash_checks`,
so that a change of the forward's source shows beside its parent.

The split-TF32 route and bf16 at D 80 (``tf32x3``): the serving forward
at the shapes chip_smoke.py timed the split-TF32 kernel at (f32 2 x 32 /
16 x 2,048, D 128, W 1,024 and causal; bf16 1 x 32 x 4,096, D 80, causal;
inputs from a generator seeded 13), ``serving_ms``; and, where the
checkout has the split-TF32 backward (`flash_attention_bwd_tf32x3_cuda`),
at stablelm-3b's training microbatch (bf16 2 x 32 x 2,048, D 80) and an
f32 shape (2 x 16 / 8 x 2,048, D 128; causal; seed 31), whichever
backward that checkout routes the shape to (``backward``: B5-bwd,
`flash_attention_bwd_tc_cuda`, where its `bwd_route` says "tc"; else the
split-TF32 backward), its ``ms`` and ``by_kernel``, the forward with its
log-sum-exp, and the bound (10*D FLOP a live pair at the bf16 or TF32
peak). Each forward is the one that checkout routes its (dtype, D) to
(``forward``: `_tc_forward` where `kernel_route` says "tc", else
`_tf32x3_forward`), so ``--checkout`` of a tree that routes bf16 D 80 to
the split-TF32 kernel times that kernel, and this tree's run times
`flash_tc.cu` there.

Exits 1 when the profiler saw no device event, and with no CUDA device.
Imports no JAX.
"""

from __future__ import annotations

import json
import sys

import torch

from kernel_timing import by_kernel, card, checkout_args, time_cuda

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 494.7e12
SHAPES = (("qwen3_train_causal", (4, 16, 8, 4096, None)),
          ("gemma3_local_w1024", (1, 32, 16, 32768, 1024)))
D = 128


def live_pairs(B, Hq, T, W):
    W = T if W is None else min(W, T)
    return B * Hq * (W * (W + 1) // 2 + (T - W) * W)


def main() -> int:
    args = checkout_args(__doc__, 10)
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
        rec["tf32x3"] = tf32x3_times(la, dev, args.reps)
        if rec["tf32x3"] is None:
            print("the profiler saw no device event", file=sys.stderr)
            return 1
    rec.update(card())
    print(json.dumps(rec))
    return 0


def route_forward(la, q):
    """The forward (`_tc_forward` or `_tf32x3_forward`) that the checkout's
    `kernel_route` picks for q's (dtype, D)."""
    return la._tc_forward if la.kernel_route(q.dtype, q.shape[-1]) == "tc" \
        else la._tf32x3_forward


def tf32x3_times(la, dev, reps):
    """The split-TF32 route's serving forward, bf16 D 80's on its route,
    and, where the checkout has it, the backward (module note); None when
    the profiler saw no device event."""
    gen = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn(2, 32, 2048, 128, device=dev, generator=gen)
    k, v = (torch.randn(2, 16, 2048, 128, device=dev, generator=gen)
            for _ in range(2))
    out = {"serving_ms": {f"f32_w{W}": time_cuda(
        lambda: la.flash_attention_tf32x3_cuda(q, k, v, window=W), reps)
        for W in (1024, None)}}
    q, k, v = (torch.randn(1, 32, 4096, 80, device=dev, generator=gen)
               .bfloat16() for _ in range(3))
    forward = route_forward(la, q)
    out["serving_ms"]["bf16_d80"] = time_cuda(
        lambda: forward(q, k, v, None, False), reps)
    out["bf16_d80_forward"] = forward.__name__
    del q, k, v
    if not hasattr(la, "flash_attention_bwd_tf32x3_cuda"):
        return out
    gen = torch.Generator(device=dev).manual_seed(31)
    out["bwd"] = []
    for name, (B, Hq, Hkv, T, D, dtype) in (
            ("stablelm_train_d80", (2, 32, 32, 2048, 80, torch.bfloat16)),
            ("qwen3_f32_d128", (2, 16, 8, 2048, 128, torch.float32))):
        q, k, v, dout = (torch.randn(B, h, T, D, device=dev,
                                     generator=gen).to(dtype)
                         for h in (Hq, Hkv, Hkv, Hq))
        forward = route_forward(la, q)
        o, lse = forward(q, k, v, None, True)
        route = la.bwd_route(dtype, D) if hasattr(la, "bwd_route") \
            else la.kernel_route(dtype, D)
        backward = la.flash_attention_bwd_tc_cuda if route == "tc" \
            else la.flash_attention_bwd_tf32x3_cuda

        def bwd():
            return backward(q, k, v, o, lse, dout)
        ms = time_cuda(bwd, reps)
        kernels = by_kernel(bwd, reps)
        if kernels is None:
            return None
        ops = 10 * D * live_pairs(B, Hq, T, None)
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 \
            else TF32_FLOP_PER_S
        out["bwd"].append({
            "shape": name, "q": list(q.shape), "kv": list(k.shape),
            "backward": backward.__name__, "ms": ms, "by_kernel": kernels,
            "forward": forward.__name__, "fwd_with_lse_ms": time_cuda(
                lambda: forward(q, k, v, None, True), reps),
            "bound_ms": ops / peak * 1e3, "tflop_per_s": ops / ms / 1e9})
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
