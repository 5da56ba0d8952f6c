#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--quick]

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the same inputs (`torch.equal`,
tolerance 0, for the integer DP kernels, whose plain versions run on the
CPU for the case matrices and the largest slices — B1 over bands across
the edges
of its warp body (B <= 128) and block body; the banded flash attention B5
— a wgmma kernel for bf16 at every head size, a split-TF32 tensor-core
kernel for f32, and the FMA kernel that no route takes any more — within
f32 / one-bf16-ulp tolerances over a matrix and at the main path's
shapes, timed beside SDPA and the bounds, with each new kernel's
registers and spills), B5-bwd (`csrc/flash_tc_bwd.cu`, the backward of
every bf16 head size: its forward's log-sum-exp, `flash_tc.cu`'s, and
the dq, dk, dv of one wgmma kernel per (batch, kv head, key tile) fed by
TMA, which sums dK and dV over the GQA group in registers and reduces
each tile's dQ into f32 scratch, between a pre-pass and a cast) against
`flash_attention_bwd_plain` over D x window x GQA group x ragged T and
at three shapes (stablelm-3b's training microbatch at D 80 among them),
timed beside plain, SDPA's backward and the bound, with the largest |dq|
difference of two calls on the same inputs, and the f32 route's
backward (`csrc/flash_tf32x3_bwd.cu`: B5-bwd's wgmma/TMA pipeline on bf16
tensor cores with every f32 operand split into three bf16 pieces, six
piece products a product, dQ reduced by TMA, at D 16-128; the mma.sync
kernel on split tf32 operands at D 256) likewise over f32 x D {16, 64,
80, 128, 256}, timed at an f32 shape with its registers and spills by
head size (`flash_bwd_checks`), then drives the
language-model serving path — gemma3-27b at
full width, 14 of its 62 layers, random bf16 weights from `--seed`: one
32,768-token prefill, 4 x 1,152 tokens decoded through the KV caches and
held against prefill logits, and an f32 check of the kernel path against
naive attention and of decode against prefill — then trains
qwen3-0.6b whole (28 layers, full width, random f32 weights from
`--seed`, AdamW, bf16 compute): three `make_train_step` steps on one
batch of 8 x 4,096 tokens in two microbatches, B5 and B5-bwd launches as
the remat scheme implies, ms a step, tokens/s, device busy share and ms
by kernel, peak memory, model-FLOP share; the loss and every gradient of
a 4-layer cut on the B5 route against naive attention, in bf16 and in
f32 (the split-TF32 route and its backward, driven as the main path
`lm_train_f32_grads`); one compressed (int8
error-feedback) step at a one-pod mesh (`lm_train`) — then drives the
training launcher (`launch.train.main`) on qwen3-0.6b whole through a
fresh run, a round trip of its last checkpoint through disk, a resume, a
NaN rolled back by `run_resilient_loop` and `plan_mesh` + `reshard`
(`lm_train_resilient`: seconds of each save and restore, ms a step) —
then trains
xlstm-125m whole the same way (12 layers: 6 mLSTM on B7 and B7-bwd, 6
sLSTM on B8 and B8-bwd; launches as the remat scheme implies, no plain
version), with a 4-layer cut's loss and gradients in f32 on the card
against the CPU's plain versions and one compressed step
(`lm_train_xlstm`), recurrentgemma-9b at full width cut to 6 layers (B6
and B6-bwd, B5 and B5-bwd at D 256; one period's loss and gradients in
f32 on the card against the CPU: `lm_train_recurrentgemma`) and
stablelm-3b whole (attention on the wgmma forward and B5-bwd at D 80,
with a 4-layer cut's bf16 loss and gradients against naive
attention: `lm_train_stablelm`) — then B8's per-step
exchange alone (`slstm_exchange`: the probe `models/csrc/slstm_probe.cu`
at B8's grid, cluster barrier against one-way `st.async` at cluster
sizes 2-16; its fastest exchange is B8's latency floor) and B8-bwd's
(its reduce-scatter alone, the backward's floor, and with each dot and
cell on the chain: the split of its step), the recurrent
kernels B6 (RG-LRU scan), B7 (chunkwise mLSTM: three chunk-parallel
passes, each held against its own plain version) and B8 (sLSTM, a
thread-block cluster per head, R in registers, a one-way h exchange)
against their plain versions at the main paths' shapes and at ragged
edges, B6 also at the long-memory recipe (`recurrent_checks`), their
backwards B6-bwd (`models/csrc/rglru_scan_bwd.cu`, at recurrentgemma's
training microbatch, with an h0, ragged T and D, and a = 1), B7-bwd (`models/csrc/mlstm_chunk_bwd.cu`, three passes, each
against its own plain version; the products of passes 1 and 3 on the
tensor cores from three bf16 pieces of each f32 operand, its bound with
them at the TF32 peak beside `fma_bound_ms`) and B8-bwd
(`models/csrc/slstm_bwd.cu`)
against the plain backwards at their training shapes and ragged edges
(B8-bwd also with the step's max flipping between its branches, and its
kernel and dR's product timed apart), with registers and spills, and
the forwards' training launches (B6 with
its scratch's per-tile inclusive h, B7's outputs pass with each row's
dot_r, B8 with its per-step record) against
their plain versions on the same inputs (`recurrent_bwd_checks`), the MoE
family —
qwen2-moe-a2.7b whole: a 32,768-token prefill, 4 x 256 decode steps with
the tokens capacity drops, and one full-width MoE layer each of
qwen2-moe-a2.7b and mixtral-8x22b in f32 against the CPU (`lm_moe`) —
and the recurrent family — recurrentgemma-9b and xlstm-125m whole: a
32,768-token prefill each, decode against prefill in bf16 and f32, and
each recurrent mixer alone in f32 (`lm_recurrent`) — and then the port's
alignment paths through their entry points at a real stream size: one
ragged `AlignmentEngine.align`
request (65,536 short pairs, 2,048 at 2 kbp, 256 in the 8192 bucket) and
an `AlignmentService` that answers 33,280 requests, each once pipelined
and once with `dispatch="persistent"`; 8,192 of those requests through
one service and through an `AlignmentRouter` over two replicas, each
dispatcher on a CUDA stream of its own (results equal; per-replica fill
and flush causes; one traced loop for the streams' busy and overlapping
time); `launch.serve --no-mesh` and `launch.map` at 1 and 2 replicas
(results equal); the ragged request through the engine sharded over a
mesh of the visible cards, equal to unsharded, with a trace holding no
NCCL kernel, no peer copy and no collective (`collective_bytes_by_kind`),
and `launch.serve` on that mesh (`mesh`); the dry run (`dryrun`:
`launch.dryrun` on the meta device for qwen3-0.6b's, xlstm-125m's and the
alignment cells on the single mesh, and one train step of qwen3-0.6b and
of xlstm-125m, in `lm_train` and `lm_train_xlstm`, counted on the card
under its `StepCounter` against the same step traced on meta: FLOPs,
bytes and each kernel's calls and work equal, the predicted peak memory
within 5 %);
`alignment_roofline` on the H100's int32 record per bucket class beside
the measured pairs/s and B1's kernel-table bound (`roofline`); edit distance (paper Fig. 14) on 4,096 Illumina and 256
PacBio pairs, CUDA backend against plain, a full-band sample against
Levenshtein, and the single-pair entry point on the card; then read
mapping on a 4 Mbp genome (`MinimizerIndex` -> chaining kernel ->
`ReadMapper` -> `AlignmentService`) for 16,384 Illumina and 1,024 PacBio
reads, with the chaining kernel held against plain at both reads' set
shapes, at A = 40, 200 and 300 and on masks that are not a prefix. Every
phase prints one JSON line; any failed check raises, so the exit code is
non-zero. Without a CUDA device the script exits 1 and prints no result.
The last line of standard output is the device record.

`--quick` builds the kernels (printing registers and shared memory per
kernel) and runs every phase at a reduced size and kernel matrix: a first
check of a changed kernel or path.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import banded  # noqa: E402
from repro_torch.core import traceback_device as tbd  # noqa: E402
from repro_torch.core.batch import (DEFAULT_BUCKET_EDGES, pad_group,  # noqa: E402
                                    plan_buckets)
from repro_torch.core.distributed import make_aligner  # noqa: E402
from repro_torch.core.engine import (PERSISTENT_PAD, SCALAR_KEYS,  # noqa: E402
                                     AlignmentEngine)
from repro_torch.core.edit_distance import (  # noqa: E402
    edit_distance, edit_distance_batch, levenshtein_reference)
from repro_torch.core.full_dp import cigar_score, full_dp_score  # noqa: E402
from repro_torch.core.scoring import MINIMAP2  # noqa: E402
from repro_torch.data.genome import (ERROR_PROFILES, ReadSimulator,  # noqa: E402
                                     random_genome, reverse_complement)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import work as kernel_work  # noqa: E402
from repro_torch.kernels.work import flash_live_pairs  # noqa: E402
from repro_torch.kernels.banded_dp.banded_dp import (  # noqa: E402
    banded_align_cuda, kernel_body)
from repro_torch.kernels.banded_dp.persistent import (  # noqa: E402
    pack_groups, persistent_align_cuda, persistent_align_plain)
from repro_torch.core.backends import cuda as cuda_backend  # noqa: E402
from repro_torch.kernels.local_attention import local_attention as la_mod  # noqa: E402
from repro_torch.kernels.local_attention.local_attention import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_bwd_tc_cuda,
    flash_attention_cuda, flash_attention_fma_cuda, flash_attention_plain,
    flash_attention_bwd_tf32x3_cuda, flash_attention_tc_cuda,
    flash_attention_tf32x3_cuda, kernel_route)
from repro_torch.launch import map as map_launcher  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.specs import abstract_state  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.map import STATUS_MAPPED, MinimizerIndex, ReadMapper  # noqa: E402
from repro_torch.map import chain as chain_mod  # noqa: E402
from repro_torch.roofline.analysis import H100, H100_INT32  # noqa: E402
from repro_torch.roofline.analytic import (DISPATCH_OVERHEAD_S,  # noqa: E402
                                           alignment_roofline,
                                           analytic_roofline)
from repro_torch.roofline.hlo_collectives import (  # noqa: E402
    KINDS as COLLECTIVE_KINDS, collective_bytes_by_kind)
from repro_torch.serve import AlignmentRouter, AlignmentService  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                   latest_step)
from repro_torch.checkpoint import restore as ckpt_restore  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.runtime import (RecoveryPolicy, StepMonitor,  # noqa: E402
                                plan_mesh, reshard, run_resilient_loop)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import blocks as block_mod  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rglru as rglru_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.model import (tree_leaves_with_path,  # noqa: E402
                                      tree_map)
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.grad_compress import init_error_buffer  # noqa: E402
from repro_torch.train import (init_train_state, make_prefill_step,  # noqa: E402
                               make_serve_step, make_train_step)
from repro_torch.train import train_step as train_mod  # noqa: E402
from repro_torch.train.compressed import make_compressed_train_step  # noqa: E402
from repro_torch.train.train_step import split_microbatches  # noqa: E402

DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA data sheet), from the port's
# roofline records: 3.35 TB/s of HBM and 16.75 TOP/s int32 (a quarter of
# the 67 TFLOP/s float32 figure: half the lanes, one operation per
# instruction instead of two per fused multiply-add).
HBM_BYTES_PER_S = H100_INT32.hbm_bw
INT32_OPS_PER_S = H100_INT32.peak_flops

# int32 operations per traceback step of the walker, counted from the plain
# version's step (B1's per band cell: `kernels.work.WAVEFRONT_OPS_PER_CELL`).
WALKER_OPS_PER_STEP = 60
# int32 operations per (anchor i, earlier anchor j) pair of the chaining
# DP: differences, the six admissibility tests, min, the gap cost
# (multiply, divide, count of leading zeros, shift), add, select, and the
# share of the two warp reductions.
CHAIN_OPS_PER_PAIR = 30
# Most slots per set the chaining kernel keeps in registers
# (`MAX_REG_SLOTS` of map/csrc/chain.cu); above, f and pred in shared memory.
CHAIN_REG_SLOTS = 256


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
    """Mean device time of `fn` over `reps` calls run back to back: CUDA
    events around the calls, behind a sleep kernel that keeps the card
    busy while the host enqueues them, so that a kernel shorter than its
    wrapper's host work is timed, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # Twice the host's enqueue time at 2e6 cycles per ms, at most ~2 s.
    torch.cuda._sleep(int(min(2 * host_ms * reps, 2000) * 2e6))
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


def on_cpu(tensors):
    """CPU copies of a dict or sequence of tensors. The case matrices run
    the plain versions there: they step through the sweep in Python, a
    few dozen small ops a step, which cost less on the CPU than launches
    on the card, and integer DP is bit-exact on either."""
    if isinstance(tensors, dict):
        return {key: val.cpu() for key, val in tensors.items()}
    return [t.cpu() for t in tensors]


def check_case(q, r, n, m, ref=None, **kw):
    """Wavefront kernel vs plain (on the CPU) on one case; with traceback
    also the walker kernel vs its plain version on the kernel's planes.
    `ref`, a plain run with traceback of the same case, serves a case
    without it (the six stats do not depend on collect_tb). Returns
    (max_abs_err wavefront, max_abs_err walker or None)."""
    ker = banded_align_cuda(q, r, n, m, sc=MINIMAP2, **kw)
    torch.cuda.synchronize()
    if ref is None:
        ref = banded.banded_align_batch(*on_cpu((q, r, n, m)), sc=MINIMAP2,
                                        **kw)
    err = assert_equal({k: ref[k] for k in ker}, ker, f"wavefront {kw}")
    if not kw["collect_tb"]:
        return err, None
    band, mode = kw["band"], kw["mode"]
    dp = tbd.device_decode_result(on_cpu(ker), *on_cpu((n, m)), band=band,
                                  mode=mode,
                                  walker=tbd.decode_packed_tb_plain)
    keys = ("cig_ops", "cig_runs", "cig_len")
    dk = tbd.device_decode_result(ker, n, m, band=band, mode=mode,
                                  walker=tbd.decode_packed_tb_cuda)
    torch.cuda.synchronize()
    werr = assert_equal({k: dp[k] for k in keys}, {k: dk[k] for k in keys},
                        f"walker {kw}")
    return err, werr


def wavefront_bound(n, m, N, Lq, Lr, T, band, collect_tb):
    """Least time for the wavefront on these inputs (`kernels.work.
    wavefront`): every pair's true n + m steps of `band` cells."""
    steps = int((n.astype(np.int64) + m).sum())
    return kernel_work.wavefront(steps, band, N, Lq, Lr, T,
                                 collect_tb).bound()


def walker_bound(path_steps, N, T):
    """Least time for the walker: per traceback step three flag bytes and
    three band offsets read; the RLE planes and lengths written once."""
    ops = path_steps * WALKER_OPS_PER_STEP
    nbytes = path_steps * (3 + 3 * 4) + 8 * N + N * T * 5 + 4 * N
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def assert_equal(ref: dict, ker: dict, what: str) -> int:
    """Every tensor of `ref` equal to `ker`'s (brought to ref's device);
    returns the largest absolute difference."""
    ker = {key: ker[key].to(ref[key].device) for key in ref}
    err = max_abs_diff(ref, ker)
    for key in ref:
        if not torch.equal(ref[key], ker[key]):
            raise AssertionError(f"{what}: kernel != plain on {key!r}")
    return err


#: Rows of each group that the plain versions recompute, on the CPU, at
#: the slices where the whole group took them tens of seconds on the card
#: (the plain versions step through the sweep in Python, a few dozen
#: small ops a step whatever the rows, and an op on 8 rows costs less on
#: the CPU than a launch on the card). The DP and the walkers are
#: row-independent integer work: the kernels' rows of the same launch are
#: held against them, bit for bit.
PLAIN_ROWS = 8


def shape_timing(name, spec, q, r, n, m, reps, plain_rows=None):
    """Both kernels at one main-path slice: held against their plain
    versions, and timed (kernel: CUDA events over `reps` launches; plain:
    host clock around one synchronised call; with `plain_rows`, the plain
    versions run on the CPU on the first `plain_rows` rows only and those
    rows of the kernels' launch are held against them). The wavefront's
    block body,
    which the main paths run only above band 128, is held and timed here
    too (`block_body=True`), by the same method, so that the two bodies
    compare like for like."""
    qd, rd, nd, md = (torch.from_numpy(a).to(DEV) for a in (q, r, n, m))
    N = q.shape[0]
    rows = slice(0, plain_rows or N)
    kw = dict(sc=MINIMAP2, band=spec.band, adaptive=True, collect_tb=True,
              mode="global", t_max=spec.t_max)
    out = banded_align_cuda(qd, rd, nd, md, **kw)
    torch.cuda.synchronize()
    pdev = "cpu" if plain_rows else DEV
    wf_plain_ms, ref = time_host(lambda: banded.banded_align_batch(
        *(x[rows].to(pdev) for x in (qd, rd, nd, md)), **kw))
    wf_err = assert_equal(ref, {k: v[rows].to(pdev) for k, v in out.items()},
                          f"wavefront at {name}")
    blk = banded_align_cuda(qd, rd, nd, md, block_body=True, **kw)
    torch.cuda.synchronize()
    wf_err = max(wf_err, assert_equal(out, blk, f"block body at {name}"))
    del blk
    wf_ms = time_cuda(lambda: banded_align_cuda(qd, rd, nd, md, **kw), reps)
    block_ms = time_cuda(lambda: banded_align_cuda(
        qd, rd, nd, md, block_body=True, **kw), reps)

    tb, los = out["tb"], out["los"]
    keys = ("cig_ops", "cig_runs", "cig_len")
    rle = tbd.decode_packed_tb_cuda(tb, los, nd, md, band=spec.band)
    torch.cuda.synchronize()
    wk_plain_ms, rle_ref = time_host(lambda: tbd.decode_packed_tb_plain(
        *(x[rows].to(pdev) for x in (tb, los, nd, md)), band=spec.band))
    wk_err = assert_equal(dict(zip(keys, rle_ref)),
                          dict(zip(keys, (x[rows].to(pdev) for x in rle))),
                          f"walker at {name}")
    wk_ms = time_cuda(lambda: tbd.decode_packed_tb_cuda(
        tb, los, nd, md, band=spec.band), reps)

    path_steps = int(rle[1].sum())
    wf_bound, wf_by = wavefront_bound(n, m, N, q.shape[1], r.shape[1],
                                      spec.t_max, spec.band, True)
    wk_bound, wk_by = walker_bound(path_steps, N, spec.t_max)
    base = {"shape": name, "pairs": N, "q_len": spec.q_len,
            "r_len": spec.r_len, "band": spec.band, "t_max": spec.t_max,
            "plain_rows": plain_rows or N, "plain_device": str(pdev)}
    return (
        dict(base, ms=wf_ms, plain_ms=wf_plain_ms, bound_ms=wf_bound,
             bound_by=wf_by, max_abs_err=wf_err,
             body=kernel_body(spec.band), block_ms=block_ms),
        dict(base, ms=wk_ms, plain_ms=wk_plain_ms,
             bound_ms=wk_bound, bound_by=wk_by, max_abs_err=wk_err,
             path_steps=path_steps, segments=int(rle[2].sum()),
             window_rows=tbd.window_rows(spec.band, spec.t_max)))


def matrix_inputs(reads, refs):
    """64 pairs at read length ~150, a few of them unrelated sequences so
    that the xdrop rule retires some (one in every quarter), one short
    pair and one dummy pair."""
    spec, q, r, n, m = padded_group(reads[:64], refs[:64], 64)
    rng = np.random.default_rng(5)
    q = q.copy()
    for p in (3, 17, 40, 56):
        q[p, :n[p]] = rng.integers(0, 4, n[p])
    n = n.copy()
    m = m.copy()
    n[5], m[5] = 37, 52          # ragged: a short pair and a dummy pair
    n[6], m[6] = 1, 1
    return spec, q, r, n, m


#: Bands across the edges of the warp body's C = 1 / 2 / 4 lanes per
#: thread (B <= 32 / 64 / 128) and of the two bodies (warp <= 128 <
#: block), beside the short class's own 20 and 21 of the full grid.
EDGE_BANDS = (31, 32, 33, 60, 63, 64, 65, 100, 127, 128, 129)


def kernel_matrix(reads, refs, quick):
    """modes x adaptive x cell_dtype x xdrop x odd/even band x collect_tb
    on `matrix_inputs`; then `EDGE_BANDS` x modes x adaptive x xdrop x
    collect_tb, the wavefront alone (every output, `tb` and `los` whole).
    The plain versions run on the CPU (`on_cpu`). In both, one plain run
    with traceback serves the two kernel runs,
    since the six stats do not depend on collect_tb. Each case asserts
    the body its band runs."""
    spec, q, r, n, m = matrix_inputs(reads, refs)
    qd, rd, nd, md = (torch.from_numpy(a).to(DEV) for a in (q, r, n, m))
    host = [torch.from_numpy(a) for a in (q, r, n, m)]
    grid = list(itertools.product(
        ("global", "semiglobal"), (True, False), ("int32", "narrow"),
        (None, 25), (spec.band, spec.band + 1)))
    if quick:
        grid = grid[::5]
    cases = retired = 0
    worst_wf = worst_wk = 0
    bodies = collections.Counter()
    for mode, adaptive, cell_dtype, xdrop, band in grid:
        kw = dict(band=band, adaptive=adaptive, mode=mode, t_max=spec.t_max,
                  cell_dtype=cell_dtype, xdrop=xdrop)
        ref = banded.banded_align_batch(*host, sc=MINIMAP2, collect_tb=True,
                                        **kw)
        for collect_tb in (True, False):
            before = banded_align_cuda.bodies[kernel_body(band)]
            err, werr = check_case(qd, rd, nd, md, ref=ref,
                                   collect_tb=collect_tb, **kw)
            assert banded_align_cuda.bodies[kernel_body(band)] == before + 1
            bodies[kernel_body(band)] += 1
            worst_wf = max(worst_wf, err)
            if werr is not None:
                worst_wk = max(worst_wk, werr)
            cases += 1
        if xdrop is not None:
            retired += int((ref["status"] != 0).sum())
    edge = list(itertools.product(EDGE_BANDS, ("global", "semiglobal"),
                                  (True, False), (None, 25)))
    for band, mode, adaptive, xdrop in edge[::7] if quick else edge:
        kw = dict(band=band, adaptive=adaptive, mode=mode, t_max=spec.t_max,
                  xdrop=xdrop)
        ref = banded.banded_align_batch(*host, sc=MINIMAP2, collect_tb=True,
                                        **kw)
        for collect_tb in (True, False):
            before = banded_align_cuda.bodies[kernel_body(band)]
            ker = banded_align_cuda(qd, rd, nd, md, sc=MINIMAP2,
                                    collect_tb=collect_tb, **kw)
            torch.cuda.synchronize()
            assert banded_align_cuda.bodies[kernel_body(band)] == before + 1
            worst_wf = max(worst_wf, assert_equal(
                {k: ref[k] for k in ker}, ker,
                f"wavefront {kw} collect_tb={collect_tb}"))
            bodies[kernel_body(band)] += 1
            if xdrop is not None:
                retired += int((ker["status"] != 0).sum())
            cases += 1
    assert retired > 0, "the xdrop cases retired no pair"
    # Wide bands (several warps per block, the widest the tests use).
    for band in (257, 400):
        err, werr = check_case(qd, rd, nd, md, band=band, adaptive=True,
                               collect_tb=True, mode="global",
                               t_max=spec.t_max, cell_dtype="int32",
                               xdrop=None)
        worst_wf, worst_wk = max(worst_wf, err), max(worst_wk, werr)
        bodies[kernel_body(band)] += 1
        cases += 1
    assert bodies["warp"] and bodies["block"], bodies
    return cases, retired, worst_wf, worst_wk, dict(bodies)


# ---------------------------------------------------------------------------
# Persistent kernel and table walker vs their plain versions.
# ---------------------------------------------------------------------------

def on_card(groups):
    """A persistent request's work table and flat (q, r, n, m) on the
    card."""
    table, arrays = pack_groups(groups)
    return table.to(DEV), [torch.from_numpy(a).to(DEV) for a in arrays]


def walk_table(out, table, n, m, mode, walker):
    dec = tbd.device_decode_table(out, table, n, m, mode=mode,
                                  walker=walker)
    torch.cuda.synchronize()
    return {k: dec[k] for k in ("cig_ops", "cig_runs", "cig_len")}


def check_persistent(groups, **kw):
    """The persistent kernel vs plain on one request, through the body its
    widest band picks and through the block body (`block_body=True`),
    each vs plain and so vs the other; with traceback also the table
    walker vs its plain version on the kernel's planes. Returns
    (max_abs_err persistent, max_abs_err walker or None,
    retired, {body: launches})."""
    table, (q, r, n, m) = on_card(groups)
    ref = persistent_align_plain(table, *on_cpu((q, r, n, m)), sc=MINIMAP2,
                                 **kw)
    err, bodies = 0, collections.Counter()
    for block in (False, True):
        body = kernel_body(table.band_max, block)
        before = persistent_align_cuda.bodies[body]
        ker = persistent_align_cuda(table, q, r, n, m, sc=MINIMAP2,
                                    block_body=block, **kw)
        torch.cuda.synchronize()
        assert persistent_align_cuda.bodies[body] == before + 1, body
        bodies[body] += 1
        err = max(err, assert_equal(ref, ker, f"persistent ({body}) {kw}"))
    retired = int((ker["status"] != 0).sum())
    if not kw["collect_tb"]:
        return err, None, retired, bodies
    dp = walk_table(on_cpu(ker), table, *on_cpu((n, m)), kw["mode"],
                    tbd.decode_packed_tb_table_plain)
    dk = walk_table(ker, table, n, m, kw["mode"],
                    tbd.decode_packed_tb_table_cuda)
    werr = assert_equal(dp, dk, f"table walker {kw}")
    return err, werr, retired, bodies


def persistent_matrix(reads, refs, quick):
    """modes x adaptive x xdrop x collect_tb over requests cut from
    `matrix_inputs`: bands 20, 21, 60 and 100 (the warp body at C = 1, 1,
    2 and 4 lanes per thread; odd and even; every band of the main
    paths' tables), and 20, 100 and 129 (bands on both sides of the warp
    body's edge; the block body; adaptive cases only); every group sweeps
    t_max but the last, which sweeps the full padded length; plus one
    narrow case. Every case also through the block body forced. Returns
    (cases, worst persistent, worst walker, launches by body)."""
    spec, q, r, n, m = matrix_inputs(reads, refs)
    requests = []
    for bands in ((20, 21, 60, 100), (20, 100, 129)):
        edges = np.linspace(0, 64, len(bands) + 1).astype(int)
        requests.append([
            (q[a:b], r[a:b], n[a:b], m[a:b], band,
             None if g == len(bands) - 1 else spec.t_max)
            for g, (a, b, band) in enumerate(zip(edges, edges[1:], bands))])
    grid = [dict(mode=mode, adaptive=adaptive, cell_dtype="int32",
                 xdrop=xdrop, collect_tb=collect_tb)
            for mode, adaptive, xdrop, collect_tb in itertools.product(
                ("global", "semiglobal"), (True, False), (None, 25),
                (True, False))]
    grid.append(dict(mode="semiglobal", adaptive=True, cell_dtype="narrow",
                     xdrop=25, collect_tb=True))
    if quick:
        grid = grid[::3]
    worst = worst_wk = retired = cases = 0
    bodies = collections.Counter()
    for groups, cases_of in zip(requests, (grid, [kw for kw in grid
                                                  if kw["adaptive"]])):
        for kw in cases_of:
            err, werr, ret, b = check_persistent(groups, **kw)
            worst = max(worst, err)
            worst_wk = max(worst_wk, werr or 0)
            retired += ret if kw["xdrop"] is not None else 0
            bodies.update(b)
            cases += 1
    assert retired > 0, "the xdrop cases retired no pair"
    assert bodies["warp"] and bodies["block"], bodies
    return cases, worst, worst_wk, dict(bodies)


def persistent_groups(reads, refs):
    """The groups `AlignmentEngine(dispatch="persistent")` builds for one
    request: planned length classes padded to PERSISTENT_PAD rows."""
    groups = []
    for g in plan_buckets([len(x) for x in reads], [len(x) for x in refs]):
        q, r, n, m = pad_group([reads[i] for i in g.indices],
                               [refs[i] for i in g.indices], g.spec,
                               pad_multiple=PERSISTENT_PAD)
        groups.append((q, r, n, m, g.spec.band, g.spec.t_max))
    return groups


def persistent_bound(table, n, m):
    """Least time for the persistent kernel on these inputs: every row's
    live steps over its own band; inputs and the table read once, stats
    and the flat planes written once."""
    band = np.concatenate([np.full(s.rows, s.band) for s in table.spans])
    steps = np.concatenate([np.full(s.rows, s.steps) for s in table.spans])
    live = np.minimum(n.astype(np.int64) + m, steps)
    ops = int((live * band).sum()) * kernel_work.WAVEFRONT_OPS_PER_CELL
    R = table.num_rows
    nbytes = (sum(s.rows * (s.q_len + s.r_len) for s in table.spans)
              + R * (8 + 24 + 8 * table.rows.shape[1])
              + table.tb_bytes + 4 * table.los_words)
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def table_head(table, keep):
    """`table` with each group cut to its first `keep` rows (its spans
    keep their offsets into the flat buffers, which is all the plain
    versions read)."""
    return dataclasses.replace(table, spans=tuple(
        dataclasses.replace(sp, rows=min(keep, sp.rows))
        for sp in table.spans))


def table_head_rows(out, table, keep, keys):
    """A persistent launch's results for the first `keep` rows of each
    group, laid out as the plain versions lay out `table_head(table,
    keep)`'s: per-row keys by merged row, the flat planes ("tb", "los")
    by each group's offsets."""
    res = {}
    for key in keys:
        parts = []
        for sp in table.spans:
            k_ = min(keep, sp.rows)
            if key == "tb":
                w = sp.steps * sp.tb_width
                parts.append(out[key][sp.tb0:sp.tb0 + k_ * w])
            elif key == "los":
                parts.append(out[key][sp.los0:sp.los0 + k_ * (sp.steps + 1)])
            else:
                parts.append(out[key][sp.row0:sp.row0 + k_])
        res[key] = torch.cat(parts)
    return res


def persistent_timing(name, table, q, r, n, m, reps, mode="global",
                      xdrop=None, plain=True, plain_rows=None):
    """The persistent kernel and the table walker on one request on the
    card: held against their plain versions and timed by `time_cuda`, the
    kernel's two bodies in turns (warp, block, block, warp). With `plain`
    False (the whole ragged request, too large for the plain versions'
    time), the kernel is held against its block body, which the other
    cases hold against plain, and the table walker by the main paths'
    gate `TABLE_WALKER_GATE`. With `plain_rows`, the plain versions run on
    the CPU on the first `plain_rows` rows of each group (`table_head`)
    and those rows of the kernels' launch are held against them; the
    block body against the whole warp-body launch."""
    kw = dict(sc=MINIMAP2, adaptive=True, collect_tb=True, mode=mode,
              xdrop=xdrop)
    body = kernel_body(table.band_max)
    out = persistent_align_cuda(table, q, r, n, m, **kw)
    blk = persistent_align_cuda(table, q, r, n, m, block_body=True, **kw)
    torch.cuda.synchronize()
    sub = table_head(table, plain_rows) if plain_rows else table
    pdev = "cpu" if plain_rows else DEV
    if plain:
        plain_ms, ref = time_host(lambda: persistent_align_plain(
            sub, *(x.to(pdev) for x in (q, r, n, m)), **kw))
        got = table_head_rows(out, table, plain_rows, ref) if plain_rows \
            else out
        got = {key: val.to(pdev) for key, val in got.items()}
        err = assert_equal(ref, got, f"persistent ({body}) at {name}")
    else:
        plain_ms = "not measured (held against the block body)"
        err = 0
    err = max(err, assert_equal(out, blk, f"persistent (block) at {name}"))
    del blk

    def align(block):
        return lambda: persistent_align_cuda(table, q, r, n, m,
                                             block_body=block, **kw)
    ms, block_ms = time_cuda(align(False), reps), time_cuda(align(True), reps)
    block_ms2, ms2 = time_cuda(align(True), reps), time_cuda(align(False),
                                                              reps)

    keys = ("cig_ops", "cig_runs", "cig_len")
    tb, los = out["tb"], out["los"]
    si, sj = tbd._start_cells(out, n, m, mode)
    rle = tbd.decode_packed_tb_table_cuda(table, tb, los, si, sj)
    torch.cuda.synchronize()
    if plain:
        wk_plain_ms, rle_ref = time_host(
            lambda: tbd.decode_packed_tb_table_plain(
                sub, *(x.to(pdev) for x in (tb, los, si, sj))))
        got = dict(zip(keys, rle))
        if plain_rows:
            got = table_head_rows(got, table, plain_rows, keys)
        got = {key: val.to(pdev) for key, val in got.items()}
        wk_err = assert_equal(dict(zip(keys, rle_ref)), got,
                              f"table walker at {name}")
    else:
        wk_plain_ms, wk_err = "not measured", 0
    wk_ms = time_cuda(lambda: tbd.decode_packed_tb_table_cuda(
        table, tb, los, si, sj), reps)

    n_h, m_h = n.cpu().numpy(), m.cpu().numpy()
    bound, by = persistent_bound(table, n_h, m_h)
    path_steps = int(rle[1].sum())
    wk_bound, wk_by = walker_bound(path_steps, table.num_rows,
                                   table.steps_max)
    base = {"shape": name, "rows": table.num_rows, "mode": mode,
            "plain_rows_per_group": plain_rows or "all",
            "plain_device": str(pdev),
            "table_shape": [table.steps_max, table.num_rows],
            "groups": [[s.rows, s.band, s.steps] for s in table.spans]}
    return (dict(base, body=body, ms=ms, ms_again=ms2, block_ms=block_ms,
                 block_ms_again=block_ms2, plain_ms=plain_ms,
                 bound_ms=bound, bound_by=by, max_abs_err=err),
            dict(base, ms=wk_ms, plain_ms=wk_plain_ms,
                 held_against="plain" if plain else TABLE_WALKER_GATE,
                 bound_ms=wk_bound, bound_by=wk_by, max_abs_err=wk_err,
                 path_steps=path_steps))


#: What the table walker on the whole ragged request is held against: the
#: main paths' gate, which compares every CIGAR of that request through the
#: table walker with the per-group walker's, itself held against plain.
TABLE_WALKER_GATE = ("persistent == pipelined on the ragged request "
                     "(engine_persistent): every CIGAR through the table "
                     "walker equals the per-group walker's")


class TableSampler:
    """Stands in for `persistent_align_cuda` in the CUDA backend during an
    untimed replay of the main paths, after they ran, and keeps a copy of
    the first request of each wanted table shape (longest sweep, rows), so
    that the shapes the paths launched most can be timed on inputs of
    their own. `sample_tables` installs it."""

    def __init__(self, wanted):
        self.wanted, self.samples = set(wanted), {}

    def __call__(self, table, q, r, n, m, **kw):
        key = (table.steps_max, table.num_rows)
        if key in self.wanted and key not in self.samples:
            self.samples[key] = (table, q.clone(), r.clone(), n.clone(),
                                 m.clone(), kw["mode"], kw.get("xdrop"))
        return persistent_align_cuda(table, q, r, n, m, **kw)


def sample_tables(wanted, replays):
    """Run `replays` (callables that drive persistent paths again) in
    order through a `TableSampler`, until every wanted table shape has a
    sample. Returns (samples by shape, replays run)."""
    sampler = TableSampler(wanted)
    cuda_backend.persistent_align_cuda = sampler
    try:
        run = 0
        for replay in replays:
            if sampler.wanted <= set(sampler.samples):
                break
            replay()
            run += 1
    finally:
        cuda_backend.persistent_align_cuda = persistent_align_cuda
    return sampler.samples, run


# ---------------------------------------------------------------------------
# Chaining kernel vs its plain version.
# ---------------------------------------------------------------------------

def chain_bound(valid):
    """Least time for the chaining kernel on these sets: every (anchor,
    earlier anchor) pair of the valid slots; positions and masks read
    once, f / pred / mask / endpoint written once."""
    a = valid.sum(axis=1).astype(np.int64)
    ops = int((a * (a - 1) // 2).sum()) * CHAIN_OPS_PER_PAIR
    R, A = valid.shape
    nbytes = R * A * (4 + 4 + 1) + R * A * (4 + 4 + 1) + 4 * R
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def live_slots(valid):
    """Valid slots per anchor set: what the chaining kernel steps."""
    a = valid.sum(axis=1)
    return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "max": int(a.max()),
            "empty_sets": int((a == 0).sum())}


def chain_check(name, padded, params, reps=0):
    """The chaining kernel vs its plain version on padded anchor sets
    (`torch.equal` on f, pred, mask and endpoints); timed when `reps` >
    0."""
    qp, rp, valid = (torch.from_numpy(a).to(DEV) for a in padded)
    kw = dict(k=params.k, max_gap=params.max_gap,
              max_dd=params.max_diag_diff)
    keys = ("f", "pred", "mask", "best")
    ker = chain_mod.chain_padded_cuda(qp, rp, valid, **kw)
    torch.cuda.synchronize()
    plain_ms, ref = time_host(
        lambda: chain_mod.chain_padded_plain(qp, rp, valid, **kw))
    err = assert_equal(dict(zip(keys, ref)), dict(zip(keys, ker)),
                       f"chain at {name}")
    A = int(qp.shape[1])
    rec = {"shape": name, "padded_sets": int(qp.shape[0]), "slots": A,
           "route": "registers" if A <= CHAIN_REG_SLOTS else "shared memory",
           "prefix_masks": bool((np.diff(padded[2].astype(np.int8), axis=1)
                                 <= 0).all()),
           "valid_anchors": int(padded[2].sum()),
           "live_slots": live_slots(padded[2]), "max_abs_err": err,
           "chained_sets": int((ker[3] >= 0).sum()), "plain_ms": plain_ms}
    if reps:
        bound, by = chain_bound(padded[2])
        rec.update(ms=time_cuda(
            lambda: chain_mod.chain_padded_cuda(qp, rp, valid, **kw), reps),
            bound_ms=bound, bound_by=by)
    return rec


def chain_checks(ill_sets, pb_sets, params, reps):
    """B4 at the mapping paths' two set shapes (Illumina and PacBio reads'
    two strands at A = 128, both timed), at A = 200 (registers, 7 of 8
    a lane) and A = 300 (f and pred in shared memory) on the PacBio sets,
    on the Illumina sets with a third of the valid slots knocked out
    (masks that are not a prefix), and at A = 40 (the 4-register
    instance, which serves every A <= 128, with slots past A)."""
    cap = params.anchors_cap
    ill = chain_mod._pad_anchors(ill_sets, cap)
    holes = np.random.default_rng(11).random(ill[2].shape) < 0.33
    return [
        chain_check("illumina_sets", ill, params, reps),
        chain_check("pacbio_sets", chain_mod._pad_anchors(pb_sets, cap),
                    params, reps),
        chain_check("pacbio_a200", chain_mod._pad_anchors(pb_sets, 200),
                    params),
        chain_check("pacbio_a300", chain_mod._pad_anchors(pb_sets, 300),
                    params),
        chain_check("illumina_holes", (ill[0], ill[1], ill[2] & ~holes),
                    params),
        chain_check("illumina_a40", chain_mod._pad_anchors(ill_sets, 40),
                    params)]


# ---------------------------------------------------------------------------
# B5 (banded flash attention) vs its plain version, and its yardsticks.
# ---------------------------------------------------------------------------

# The published dense bf16 peak of one H100 SXM (NVIDIA data sheet): the
# MFU's denominator.
BF16_FLOP_PER_S = H100.peak_flops
# Tensor-core passes per product of the split-TF32 kernel, each 4*D FLOP
# per live pair: lo*hi + hi*lo + hi*hi for f32; lo*hi + hi*hi for bf16,
# whose k and v are exact in tf32.
TF32_SPLIT_PASSES = {torch.float32: 3, torch.bfloat16: 2}
# Kernel vs plain: f32 within the reference's own kernel test bound
# (tests/test_kernels.py: atol = rtol = 2e-5), the same f32 function summed
# in another order; bf16 outputs within one bf16 ulp of the value (both
# round an f32 result; values that straddle a rounding boundary land one
# ulp apart), or 2e-5 where that is larger (values near 0 whose ulp is
# below the f32 error of the sum).
FLASH_F32_TOL = 2e-5


def flash_err(out, ref):
    """(max |out - ref|, whether every element is within the tolerance)."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    if ref.dtype == torch.float32:
        tol = FLASH_F32_TOL + FLASH_F32_TOL * r
    else:
        ulp = torch.exp2(torch.floor(torch.log2(r.clamp_min(1e-30))) - 7)
        tol = torch.clamp(ulp, min=FLASH_F32_TOL)
    return float(d.max()), bool((d <= tol).all())


def flash_bound(q, k, W, units=None):
    """Least time for B5 on these inputs (`kernels.work.flash`: 4*D FLOP a
    live pair on the tensor cores, at the dense bf16 peak for bf16 and the
    TF32 peak for f32; q, k, v read once and o written once). Two named
    yardsticks beside it: `units` "split", the split-TF32 kernel's own
    passes (3 x 4*D for f32, 2 x 4*D for bf16) at the TF32 peak; "fma",
    4*D on the FMA units at 67 TFLOP/s."""
    B, Hq, T, D = q.shape
    w = kernel_work.flash(B, Hq, k.shape[1], T, D, W, q.element_size())
    if units == "split":
        w = kernel_work.Work({"tf32": w.total_ops
                              * TF32_SPLIT_PASSES[q.dtype]}, w.nbytes)
    elif units == "fma":
        w = w.at("f32")
    return w.bound()


def flash_matrix(quick):
    """dtypes x window {None, 1024, 17, >= T} x group {1, 2, 8} x D, with T
    from 128 to 2,048: each case through `flash_attention_cuda`, which
    launches the kernel `kernel_route` names (the wgmma kernel for bf16,
    the split-TF32 kernel for f32), vs plain; the FMA kernel, on no route,
    beside it on the f32 cases and on bf16 at D 16 / 80 (the cases the
    split-TF32 kernel took until the wgmma kernel was built for them).
    Returns (cases per kernel, worst error per kernel and dtype)."""
    gen = torch.Generator(device=DEV).manual_seed(7)
    grid = list(itertools.product(
        (torch.float32, torch.bfloat16), (None, 1024, 17, "wide"),
        (1, 2, 8), (16, 64, 80, 128, 256)))
    if quick:
        grid = grid[::4]
    kernels = {"tc": flash_attention_tc_cuda,
               "tf32x3": flash_attention_tf32x3_cuda}
    cases, worst = {"tc": 0, "tf32x3": 0, "fma": 0}, {}
    for i, (dt, W, group, D) in enumerate(grid):
        T = (128, 640, 1152, 2048)[i % 4]
        B, Hkv = (2, 8 // group) if group > 1 else (1, 4)
        Hq = Hkv * group
        W = 2 * T if W == "wide" else W
        q, k, v = (torch.randn(B, h, T, D, device=DEV, generator=gen).to(dt)
                   for h in (Hq, Hkv, Hkv))
        route = kernel_route(dt, D)
        before = kernels[route].launches
        out = flash_attention_cuda(q, k, v, window=W)
        assert kernels[route].launches == before + 1, (route, dt, D)
        outs = {route: out}
        if route == "tf32x3" or D in (16, 80):
            outs["fma"] = flash_attention_fma_cuda(q, k, v, window=W)
        ref = flash_attention_plain(q, k, v, window=W)
        torch.cuda.synchronize()
        for name, o in outs.items():
            err, ok = flash_err(o, ref)
            if not ok:
                raise AssertionError(
                    f"B5 ({name}) != plain beyond tolerance: {dt} W={W} "
                    f"group={group} D={D} T={T} err={err}")
            key = f"{name}/{str(dt).split('.')[-1]}"
            worst[key] = max(worst.get(key, 0.0), err)
            cases[name] += 1
    return cases, worst


def sass_count(lib_name, opcode, by=None):
    """Instructions of `opcode` in the SASS of a built kernel library, by
    `cuobjdump -sass`; with `by` (a regex with one group), a dict of the
    counts in each function whose mangled name it matches, keyed by the
    group (an int where it is one); ("not measured", reason) without
    cuobjdump."""
    exe = shutil.which("cuobjdump")
    if exe is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "cuobjdump")
        exe = cand if os.path.exists(cand) else None
    if exe is None:
        return "not measured", "cuobjdump not found"
    run = subprocess.run([exe, "-sass", str(build.lib_path(lib_name))],
                         capture_output=True, text=True)
    if run.returncode != 0:
        return "not measured", run.stderr.strip()[:200]
    if by is None:
        return sum(opcode in line for line in run.stdout.splitlines()), exe
    counts_by, cur = {}, None
    for line in run.stdout.splitlines():
        if "Function :" in line:
            hit = re.search(by, line)
            cur = None
            if hit:
                cur = int(hit.group(1)) if hit.group(1).isdigit() \
                    else hit.group(1)
                counts_by.setdefault(cur, 0)
        elif cur is not None and opcode in line:
            counts_by[cur] += 1
    return counts_by, exe


def ptxas_facts(log, kernel, key=r"ILi(\d+)E"):
    """{instantiation: {registers, spill_stores, spill_loads}} of the
    entry functions whose mangled name matches `kernel` + `key` in
    `-Xptxas -v` output, keyed by `key`'s groups that matched, joined by
    "/" (by default the first template argument, an int: the head size
    of `flash_tc_kernel<D>`);
    where several entry functions share a key, the largest of each."""
    facts, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            hit = re.search(kernel + key, line)
            cur = None
            if hit:
                cur = "/".join(g for g in hit.groups() if g).replace(
                    "13__nv_bfloat16", "bf16")
                cur = int(cur) if cur.isdigit() else cur
                facts.setdefault(cur, {})
        elif cur is not None and (hit := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            f = facts[cur]
            f["spill_stores"] = max(f.get("spill_stores", 0),
                                    int(hit.group(1)))
            f["spill_loads"] = max(f.get("spill_loads", 0), int(hit.group(2)))
        elif cur is not None and (hit := re.search(r"Used (\d+) registers",
                                                   line)):
            f = facts[cur]
            f["registers"] = max(f.get("registers", 0), int(hit.group(1)))
    return facts


def sdpa_time(q, k, v, W, reps):
    """One PyTorch call computing the same attention, timed as a yardstick
    (never used by the port): `is_causal` for the causal pass, a boolean
    band mask for a window. Returns (ms, backend) or ("not measured",
    reason)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    T = q.shape[2]
    kw = dict(is_causal=True)
    if W is not None and W < T:
        pos = torch.arange(T, device=DEV)
        kw = dict(attn_mask=(pos[None, :] <= pos[:, None])
                  & (pos[None, :] > pos[:, None] - W))
    reasons = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for gqa in (True, False):
            kk, vv = k, v
            if not gqa:  # the kv heads expanded beforehand, outside the clock
                g = q.shape[1] // k.shape[1]
                kk, vv = (x.repeat_interleave(g, dim=1) for x in (k, v))
            try:
                with sdpa_kernel([backend]):
                    def call():
                        return F.scaled_dot_product_attention(
                            q, kk, vv, enable_gqa=gqa, **kw)
                    ms = time_cuda(call, reps)
                return ms, f"{backend.name}{'' if gqa else ', kv expanded'}"
            except RuntimeError as e:
                reasons.append(f"{backend.name}/gqa={gqa}: {str(e)[:80]}")
    return "not measured", "; ".join(reasons)


def flash_main_shapes(reps):
    """B5 at the two shapes of the main path (gemma3-27b prefill of 32,768
    tokens: 32 q heads over 16 kv heads, D 128, bf16) with W = 1024 (local
    layers) and None (global layers): the tensor-core kernel (the main
    path's) and the FMA kernel held against the plain version, and timed
    in this one call beside the plain version, SDPA and the bound."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    q = torch.randn(1, 32, 32768, 128, device=DEV, generator=gen).bfloat16()
    k, v = (torch.randn(1, 16, 32768, 128, device=DEV,
                        generator=gen).bfloat16() for _ in range(2))
    recs = []
    for W, name in ((1024, "local_w1024"), (None, "global_causal")):
        def tc():
            return flash_attention_tc_cuda(q, k, v, window=W)

        def fma():
            return flash_attention_fma_cuda(q, k, v, window=W)
        out, out_fma = tc(), fma()
        plain_ms, ref = time_host(lambda: flash_attention_plain(
            q, k, v, window=W))
        err, ok = flash_err(out, ref)
        fma_err, fma_ok = flash_err(out_fma, ref)
        if not (ok and fma_ok):
            raise AssertionError(f"B5 != plain beyond tolerance at {name}: "
                                 f"tc {err}, fma {fma_err}")
        del ref, out, out_fma
        slow_reps = reps if W else max(reps // 4, 1)
        ms = time_cuda(tc, reps)
        fma_ms = time_cuda(fma, slow_reps)
        lib_ms, lib = sdpa_time(q, k, v, W, slow_reps)
        bound, by = flash_bound(q, k, W)
        pairs = flash_live_pairs(1, 32, 32768, W)
        recs.append({"shape": name, "q": list(q.shape), "kv": list(k.shape),
                     "dtype": "bfloat16", "window": W, "live_pairs": pairs,
                     "ms": ms, "fma_ms": fma_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library": lib,
                     "bound_ms": bound, "bound_by": by,
                     "tflop_per_s": 4 * 128 * pairs / ms / 1e9,
                     "bound_share": bound / ms,
                     "fma_tflop_per_s": 4 * 128 * pairs / fma_ms / 1e9,
                     "tc_speedup_over_fma": fma_ms / ms,
                     "max_abs_err": err, "fma_max_abs_err": fma_err,
                     "within_tolerance": ok and fma_ok})
    return recs


def split_tf32_shapes(name, q, k, v, windows, reps):
    """The split-TF32 kernel (the route of f32) and the FMA kernel at one
    shape: each held against the plain version
    and timed in this one call beside plain, SDPA, the bound and two
    yardsticks (the split's own passes at the TF32 peak; the FMA
    units)."""
    B, Hq, T, D = q.shape
    recs = []
    for W in windows:
        def tf():
            return flash_attention_tf32x3_cuda(q, k, v, window=W)

        def fma():
            return flash_attention_fma_cuda(q, k, v, window=W)
        out, out_fma = tf(), fma()
        plain_ms, ref = time_host(lambda: flash_attention_plain(
            q, k, v, window=W))
        err, ok = flash_err(out, ref)
        fma_err, fma_ok = flash_err(out_fma, ref)
        if not (ok and fma_ok):
            raise AssertionError(f"B5 != plain beyond tolerance at {name} "
                                 f"W={W}: tf32x3 {err}, fma {fma_err}")
        del ref, out, out_fma
        ms = time_cuda(tf, reps)
        fma_ms = time_cuda(fma, reps)
        ms_again = time_cuda(tf, reps)
        lib_ms, lib = sdpa_time(q, k, v, W, reps)
        bound, by = flash_bound(q, k, W)
        split_bound, _ = flash_bound(q, k, W, units="split")
        fma_bound, _ = flash_bound(q, k, W, units="fma")
        pairs = flash_live_pairs(B, Hq, T, W)
        recs.append({"shape": f"{name}_{'causal' if W is None else W}",
                     "q": list(q.shape), "kv": list(k.shape),
                     "dtype": str(q.dtype).split(".")[-1], "window": W,
                     "live_pairs": pairs, "ms": ms, "ms_again": ms_again,
                     "fma_ms": fma_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library": lib,
                     "bound_ms": bound, "bound_by": by,
                     "split_bound_ms": split_bound,
                     "fma_bound_ms": fma_bound,
                     "tflop_per_s": 4 * D * pairs / ms / 1e9,
                     "bound_share": bound / ms,
                     "split_bound_share": split_bound / ms,
                     "fma_tflop_per_s": 4 * D * pairs / fma_ms / 1e9,
                     "speedup_over_fma": fma_ms / ms,
                     "max_abs_err": err, "fma_max_abs_err": fma_err,
                     "within_tolerance": ok and fma_ok})
    return recs


def flash_f32_shapes(reps):
    """B5 at the shapes the main path gives the split-TF32 kernel: the f32
    prefill of the `lm` phase (2 x 2,048 tokens, 32 q / 16 kv heads, D
    128), W = 1024 and None."""
    gen = torch.Generator(device=DEV).manual_seed(13)
    q = torch.randn(2, 32, 2048, 128, device=DEV, generator=gen)
    k, v = (torch.randn(2, 16, 2048, 128, device=DEV, generator=gen)
            for _ in range(2))
    return split_tf32_shapes("f32", q, k, v, (1024, None), reps)


#: The wgmma kernel's shapes at the head sizes it stages as whole chunks
#: (32 heads, MHA, causal): stablelm-3b's D 80 as one 4,096-token serving
#: pass (the shape the split-TF32 kernel was timed at before) and, with
#: its lse, at stablelm-3b's training microbatch (2 x 2,048: the train
#: step's launch); D 16 as one 4,096-token serving pass.
TC_NARROW_SHAPES = (("bf16_d80", (1, 4096, 80, False)),
                    ("bf16_d80_train_lse", (2, 2048, 80, True)),
                    ("bf16_d16", (1, 4096, 16, False)))


def flash_tc_narrow_shapes(reps):
    """`flash_tc.cu` at `TC_NARROW_SHAPES`: held against the plain version
    (its lse against the plain lse within `LSE_TOL` where the launch
    writes one) and timed in this one call beside plain, the FMA kernel
    (serving shapes), SDPA and the bound."""
    gen = torch.Generator(device=DEV).manual_seed(29)
    recs = []
    for name, (B, T, D, with_lse) in TC_NARROW_SHAPES:
        q, k, v = (torch.randn(B, 32, T, D, device=DEV, generator=gen)
                   .bfloat16() for _ in range(3))

        def tc():
            return la_mod._tc_forward(q, k, v, None, with_lse)
        out, lse = tc()
        # The plain pass in one block of T x T: its result does not depend
        # on the tiling beyond f32 rounding, and one block runs in a
        # fraction of the 128-row tiles' time.
        plain_ms, (ref, ref_lse) = time_host(lambda: flash_attention_plain(
            q, k, v, block_q=T, block_k=T, return_lse=True))
        err, ok = flash_err(out, ref)
        rec = {"shape": name, "q": list(q.shape), "kv": list(k.shape),
               "dtype": "bfloat16", "window": None, "with_lse": with_lse}
        if with_lse:
            d = (lse - ref_lse).abs()
            rec["lse_err"] = float(d.max())
            ok = ok and bool((d <= LSE_TOL * (1 + ref_lse.abs())).all())
        else:
            out_fma = flash_attention_fma_cuda(q, k, v)
            rec["fma_max_abs_err"], fma_ok = flash_err(out_fma, ref)
            ok = ok and fma_ok
            del out_fma
        if not ok:
            raise AssertionError(f"flash_tc != plain beyond tolerance at "
                                 f"{name}: {err} {rec}")
        del ref, ref_lse, out, lse
        ms = time_cuda(tc, reps)
        if not with_lse:
            rec["fma_ms"] = time_cuda(
                lambda: flash_attention_fma_cuda(q, k, v), reps)
        rec["ms_again"] = time_cuda(tc, reps)
        lib_ms, lib = sdpa_time(q, k, v, None, reps)
        bound, by = flash_bound(q, k, None)
        pairs = flash_live_pairs(B, 32, T, None)
        rec.update({"live_pairs": pairs, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "library": lib,
                    "bound_ms": bound, "bound_by": by,
                    "tflop_per_s": 4 * D * pairs / ms / 1e9,
                    "bound_share": bound / ms, "max_abs_err": err,
                    "within_tolerance": ok})
        recs.append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# B5-bwd (csrc/flash_tc_bwd.cu) vs its plain version.
# ---------------------------------------------------------------------------

#: B5-bwd vs plain (stated before the kernel's first card run, never
#: loosened): for each of dq, dk, dv, max |kernel - plain| <= 2^-6 * max
#: |plain| and relative L2 <= 2^-7, the plain version computing in f32 from
#: the same bf16 inputs (the kernel feeds P and dS to the tensor cores as
#: one bf16 each and rounds its outputs to bf16). The forward's lse within
#: 2^-14 * (1 + |plain lse|) of the plain lse.
#: One exception, added after the first card run: at W = 1 every query has
#: one live key, its softmax is constant and the exact dq and dk are 0;
#: kernel and plain version both return f32 rounding there (dP - delta,
#: two sums of the same products in other orders), so a tolerance relative
#: to the plain dq or dk compares noise with noise. There dq and dk are
#: held to the exact 0: max |kernel| <= 2^-6 * max |plain dv| (the scale of
#: the rows' one nonzero gradient); dv keeps the rule above.
BWD_MAX_TOL = 2 ** -6
BWD_L2_TOL = 2 ** -7
LSE_TOL = 2 ** -14


def bwd_errs(got, want, W=None, max_tol=BWD_MAX_TOL, l2_tol=BWD_L2_TOL):
    """{name: max |got - want|, its share of max |want|, rel L2} and
    whether all are within the tolerance, max |err| <= `max_tol` x max
    |want| and rel L2 <= `l2_tol` (at W = 1, dq and dk against the exact
    0, their share of max |plain dv| within `max_tol`)."""
    errs, ok = {}, True
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if W == 1 and name != "dv":
            mx = float(g.float().abs().max())
            share = mx / max(float(want[2].float().abs().max()), 1e-30)
            errs[name] = {"max_abs": mx, "share_of_max_dv": share,
                          "plain_max_abs": float(w.float().abs().max()),
                          "exact": 0.0}
            ok = ok and share <= max_tol
            continue
        d = (g.float() - w.float())
        peak = float(w.float().abs().max())
        mx = float(d.abs().max())
        l2 = float(d.norm() / w.float().norm().clamp_min(1e-30))
        errs[name] = {"max_abs_err": mx, "max_share": mx / max(peak, 1e-30),
                      "rel_l2": l2}
        ok = ok and mx <= max_tol * peak and l2 <= l2_tol
    return errs, ok


def route_forward(q):
    """The forward with lse that `FlashAttention` runs on q's (dtype, D):
    `flash_tc.cu` for the tc route (bf16), `flash_tf32x3.cu` for the
    other (f32)."""
    return la_mod._tc_forward if kernel_route(q.dtype, q.shape[-1]) == "tc" \
        else la_mod._tf32x3_forward


def flash_bwd_case(q, k, v, dout, W):
    """B5's forward on its route (`route_forward`) with its lse and B5-bwd,
    against the plain forward (`return_lse=True`) and
    `flash_attention_bwd_plain`, all on the card from the same bf16
    inputs. Returns (kernel grads, plain grads, lse error, lse within
    tolerance, max |dq| difference of a second B5-bwd call on the same
    inputs: dq's f32 reductions come in an order that varies from call to
    call, reported and not gated)."""
    out_k, lse_k = route_forward(q)(q, k, v, W, True)
    got = flash_attention_bwd_tc_cuda(q, k, v, out_k, lse_k, dout, window=W)
    dq_again = flash_attention_bwd_tc_cuda(q, k, v, out_k, lse_k, dout,
                                           window=W)[0]
    dq_rep = float((dq_again.float() - got[0].float()).abs().max())
    del dq_again
    T = q.shape[2]
    blk = 128 if T % 128 == 0 else T
    out_p, lse_p = flash_attention_plain(q, k, v, window=W, block_q=blk,
                                         block_k=blk, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, out_p, lse_p, dout, window=W)
    torch.cuda.synchronize()
    fin = torch.isfinite(lse_p)
    assert torch.equal(fin, torch.isfinite(lse_k)), "lse: inf rows differ"
    d = (lse_k - lse_p.float())[fin].abs()
    lse_err = float(d.max()) if d.numel() else 0.0
    lse_ok = bool((d <= LSE_TOL * (1 + lse_p.float()[fin].abs())).all())
    return got, want, lse_err, lse_ok, dq_rep


def flash_bwd_matrix(quick):
    """bf16 x D {64, 128, 256, 16, 80} x W {full, 1, 1,024, 40 (< a
    64-row tile)} x G {1, 2, 8}, T ragged (not a multiple of 64) from 647
    to 2,100: every case within the tolerance, behind `flash_tc.cu`'s lse
    (its lse within `LSE_TOL` of the plain lse). Returns (cases, worst
    errors)."""
    gen = torch.Generator(device=DEV).manual_seed(19)
    grid = list(itertools.product((64, 128, 256, 16, 80),
                                  (None, 1, 1024, 40), (1, 2, 8)))
    if quick:
        grid = grid[::3]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0, "rel_l2": 0.0, "lse": 0.0,
             "w1_exact_zero": 0.0, "dq_repeat_max_abs": 0.0}
    for i, (D, W, group) in enumerate(grid):
        T = (647, 1100, 1500, 2100)[i % 4]
        B, Hkv = (2, 8 // group) if group > 1 else (1, 4)
        if D == 256 and group == 8:
            B, Hkv = 1, 1               # paligemma's heads: 8 q over 1 kv
        q, k, v, dout = (torch.randn(B, h, T, D, device=DEV,
                                     generator=gen).bfloat16()
                         for h in (Hkv * group, Hkv, Hkv, Hkv * group))
        got, want, lse_err, lse_ok, dq_rep = flash_bwd_case(q, k, v, dout,
                                                            W)
        errs, ok = bwd_errs(got, want, W)
        worst["dq_repeat_max_abs"] = max(worst["dq_repeat_max_abs"], dq_rep)
        if not (ok and lse_ok):
            raise AssertionError(
                f"B5-bwd != plain beyond tolerance: D={D} W={W} G={group} "
                f"T={T} {errs} lse {lse_err}")
        for name, e in errs.items():
            if "exact" in e:
                worst["w1_exact_zero"] = max(worst["w1_exact_zero"],
                                             e["share_of_max_dv"])
                continue
            worst[name] = max(worst[name], e["max_share"])
            worst["rel_l2"] = max(worst["rel_l2"], e["rel_l2"])
        worst["lse"] = max(worst["lse"], lse_err)
    return len(grid), worst


def flash_bwd_bound(q, k, W):
    """Least time of an attention backward on these inputs
    (`kernels.work.flash_bwd`: 10*D FLOP a live pair at the dense bf16
    peak for bf16 — B5-bwd — and at the TF32 peak for f32 — the f32
    backward; q, k, v, o, dO and lse read once, dq, dk, dv written
    once)."""
    B, Hq, T, D = q.shape
    return kernel_work.flash_bwd(B, Hq, k.shape[1], T, D, W,
                                 q.element_size()).bound()


def sdpa_bwd_time(q, k, v, dout, W, reps):
    """The backward of one `F.scaled_dot_product_attention` call on the same
    inputs, timed as a yardstick (never used by the port): the band as a
    boolean mask where a backend takes it, else causal (no band) and said
    so. Returns (ms, what) or ("not measured", reasons)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    T = q.shape[2]
    kws = [("causal", dict(is_causal=True))]
    if W is not None and W < T:
        pos = torch.arange(T, device=DEV)
        kws = [("band mask", dict(attn_mask=(pos[None, :] <= pos[:, None])
                                  & (pos[None, :] > pos[:, None] - W))),
               ("causal, no band", dict(is_causal=True))]
    reasons = []
    for label, kw in kws:
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION):
            g = q.shape[1] // k.shape[1]
            qq, kk, vv = (x.detach().clone().requires_grad_()
                          for x in (q, k.repeat_interleave(g, dim=1),
                                    v.repeat_interleave(g, dim=1)))
            try:
                with sdpa_kernel([backend]):
                    out = F.scaled_dot_product_attention(qq, kk, vv, **kw)

                    def call():
                        return torch.autograd.grad(out, (qq, kk, vv), dout,
                                                   retain_graph=True)
                    ms = time_cuda(call, reps)
                return ms, f"{backend.name}, {label}, kv expanded"
            except RuntimeError as e:
                reasons.append(f"{backend.name}/{label}: {str(e)[:80]}")
    return "not measured", "; ".join(reasons)


#: B5-bwd's timed shapes: qwen3-0.6b's training shape (4 x 16 q / 8 kv
#: heads x 4,096, D 128, causal), gemma3-27b's local layer (1 x 32 / 16 x
#: 32,768, D 128, W 1,024) and stablelm-3b's training microbatch (2 x 32
#: heads (MHA) x 2,048, D 80, causal).
BWD_SHAPES = (("qwen3_train_causal", (4, 16, 8, 4096, 128, None)),
              ("gemma3_local_w1024", (1, 32, 16, 32768, 128, 1024)),
              ("stablelm_train_d80", (2, 32, 32, 2048, 80, None)))


def flash_bwd_shapes(reps):
    """B5-bwd at `BWD_SHAPES`: held against plain, timed beside plain,
    SDPA's backward and the bound, with its route's forward with lse."""
    gen = torch.Generator(device=DEV).manual_seed(23)
    recs = []
    for name, (B, Hq, Hkv, T, D, W) in BWD_SHAPES:
        q, k, v, dout = (torch.randn(B, h, T, D, device=DEV,
                                     generator=gen).bfloat16()
                         for h in (Hq, Hkv, Hkv, Hq))
        got, want, lse_err, lse_ok, dq_rep = flash_bwd_case(q, k, v, dout,
                                                            W)
        errs, ok = bwd_errs(got, want)
        del got, want
        if not (ok and lse_ok):
            raise AssertionError(f"B5-bwd != plain at {name}: {errs} "
                                 f"lse {lse_err}")
        forward = route_forward(q)
        out, lse = forward(q, k, v, W, True)
        plain_ms, _ = time_host(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, dout, window=W))
        ms = time_cuda(lambda: flash_attention_bwd_tc_cuda(
            q, k, v, out, lse, dout, window=W), reps)
        fwd_ms = time_cuda(lambda: forward(q, k, v, W, True), reps)
        lib_ms, lib = sdpa_bwd_time(q, k, v, dout, W, reps)
        bound, by = flash_bwd_bound(q, k, W)
        pairs = flash_live_pairs(B, Hq, T, W)
        recs.append({"shape": name, "q": list(q.shape), "kv": list(k.shape),
                     "window": W, "live_pairs": pairs, "ms": ms,
                     "fwd_with_lse_ms": fwd_ms,
                     "fwd_with_lse_bound_ms": flash_bound(q, k, W)[0],
                     "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library": lib,
                     "bound_ms": bound, "bound_by": by,
                     "tflop_per_s": kernel_work.FLASH_BWD_OPS_PER_PAIR_PER_D * D * pairs
                     / ms / 1e9, "bound_share": bound / ms, "errs": errs,
                     "dq_repeat_max_abs": dq_rep,
                     "lse_err": lse_err, "within_tolerance": ok and lse_ok})
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# The f32 backward (`csrc/flash_tf32x3_bwd.cu`) vs its plain version.
# ---------------------------------------------------------------------------

#: The f32 backward (f32 only) vs `flash_attention_bwd_plain` (stated
#: before its first run in this script): f32 gradients at f32 level, each
#: of dq, dk, dv within `REC_TOL` (1e-4) x max |plain| and rel L2
#: `REC_TOL` (the same f32 function, P recomputed from the forward's lse,
#: summed in another order and with dq's sums by reductions in varying
#: order); at W = 1 dq and dk against their exact 0 within the same share
#: of max |plain dv|.
def split_bwd_errs(got, want, W=None):
    return bwd_errs(got, want, W, REC_TOL, REC_TOL)


def tf32x3_bwd_case(q, k, v, dout, W):
    """The split-TF32 forward with its lse and the f32 backward, against
    the plain forward (`return_lse=True`) and `flash_attention_bwd_plain`,
    all on the card from the same inputs; the same tuple as
    `flash_bwd_case`."""
    out_k, lse_k = la_mod._tf32x3_forward(q, k, v, W, True)
    got = flash_attention_bwd_tf32x3_cuda(q, k, v, out_k, lse_k, dout,
                                          window=W)
    dq_again = flash_attention_bwd_tf32x3_cuda(q, k, v, out_k, lse_k, dout,
                                               window=W)[0]
    dq_rep = float((dq_again.float() - got[0].float()).abs().max())
    del dq_again
    T = q.shape[2]
    blk = 128 if T % 128 == 0 else T
    out_p, lse_p = flash_attention_plain(q, k, v, window=W, block_q=blk,
                                         block_k=blk, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, out_p, lse_p, dout, window=W)
    torch.cuda.synchronize()
    fin = torch.isfinite(lse_p)
    assert torch.equal(fin, torch.isfinite(lse_k)), "lse: inf rows differ"
    d = (lse_k - lse_p.float())[fin].abs()
    lse_err = float(d.max()) if d.numel() else 0.0
    lse_ok = bool((d <= LSE_TOL * (1 + lse_p.float()[fin].abs())).all())
    return got, want, lse_err, lse_ok, dq_rep


def tf32x3_bwd_matrix(quick):
    """f32 x D {16, 64, 80, 128, 256} x W {full, 1, 40 (< a 64-key tile),
    1,024} x G {1, 2, 8}, T ragged (not a multiple of 32 or 64) from 647 to
    2,100: every case within the tolerance. Returns (cases, worst errors
    by dtype)."""
    gen = torch.Generator(device=DEV).manual_seed(29)
    routes = [(torch.float32, D) for D in la_mod.KERNEL_HEAD_DIMS]
    grid = list(itertools.product(routes, (None, 1, 40, 1024), (1, 2, 8)))
    if quick:
        grid = grid[::5]
    worst = {}
    for i, ((dtype, D), W, group) in enumerate(grid):
        T = (647, 1100, 1500, 2100)[i % 4]
        B, Hkv = (2, 8 // group) if group > 1 else (1, 4)
        q, k, v, dout = (torch.randn(B, h, T, D, device=DEV,
                                     generator=gen).to(dtype)
                         for h in (Hkv * group, Hkv, Hkv, Hkv * group))
        got, want, lse_err, lse_ok, dq_rep = tf32x3_bwd_case(q, k, v, dout,
                                                             W)
        errs, ok = split_bwd_errs(got, want, W)
        if not (ok and lse_ok):
            raise AssertionError(
                f"f32 backward != plain beyond tolerance: {dtype} "
                f"D={D} W={W} G={group} T={T} {errs} lse {lse_err}")
        w = worst.setdefault(str(dtype).split(".")[-1], {
            "dq": 0.0, "dk": 0.0, "dv": 0.0, "rel_l2": 0.0, "lse": 0.0,
            "w1_exact_zero": 0.0, "dq_repeat_max_abs": 0.0,
            "max_abs_err": 0.0})
        w["dq_repeat_max_abs"] = max(w["dq_repeat_max_abs"], dq_rep)
        for name, e in errs.items():
            if "exact" in e:
                w["w1_exact_zero"] = max(w["w1_exact_zero"],
                                         e["share_of_max_dv"])
                continue
            w[name] = max(w[name], e["max_share"])
            w["rel_l2"] = max(w["rel_l2"], e["rel_l2"])
            w["max_abs_err"] = max(w["max_abs_err"], e["max_abs_err"])
        w["lse"] = max(w["lse"], lse_err)
        del q, k, v, dout, got, want
    return len(grid), worst


#: The f32 backward's timed shape: f32 at qwen3-0.6b's heads (2 x 16 q /
#: 8 kv x 2,048, D 128, causal). (stablelm-3b's bf16 microbatch moved to
#: B5-bwd's `BWD_SHAPES` with its backward.)
SPLIT_BWD_SHAPES = (("qwen3_f32_d128", (2, 16, 8, 2048, 128, None,
                                        torch.float32)),)


def tf32x3_bwd_shapes(reps, ptxas):
    """The f32 backward at `SPLIT_BWD_SHAPES`: held against plain, timed
    beside plain, SDPA's backward (kv expanded) and the bound, with the
    forward's training launch (with lse) and serving launch, and the
    backward's registers and spills by kernel and head size (`ptxas`)."""
    gen = torch.Generator(device=DEV).manual_seed(31)
    recs = []
    for name, (B, Hq, Hkv, T, D, W, dtype) in SPLIT_BWD_SHAPES:
        q, k, v, dout = (torch.randn(B, h, T, D, device=DEV,
                                     generator=gen).to(dtype)
                         for h in (Hq, Hkv, Hkv, Hq))
        got, want, lse_err, lse_ok, dq_rep = tf32x3_bwd_case(q, k, v, dout,
                                                             W)
        errs, ok = split_bwd_errs(got, want)
        del got, want
        if not (ok and lse_ok):
            raise AssertionError(f"f32 backward != plain at {name}: "
                                 f"{errs} lse {lse_err}")
        out, lse = la_mod._tf32x3_forward(q, k, v, W, True)
        plain_ms, _ = time_host(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, dout, window=W))
        ms = time_cuda(lambda: flash_attention_bwd_tf32x3_cuda(
            q, k, v, out, lse, dout, window=W), reps)
        fwd_ms = time_cuda(lambda: la_mod._tf32x3_forward(q, k, v, W, True),
                           reps)
        serve_ms = time_cuda(lambda: flash_attention_tf32x3_cuda(
            q, k, v, window=W), reps)
        lib_ms, lib = sdpa_bwd_time(q, k, v, dout, W, reps)
        bound, by = flash_bwd_bound(q, k, W)
        pairs = flash_live_pairs(B, Hq, T, W)
        recs.append({"shape": name, "q": list(q.shape), "kv": list(k.shape),
                     "dtype": str(dtype).split(".")[-1], "window": W,
                     "live_pairs": pairs, "ms": ms, "fwd_with_lse_ms": fwd_ms,
                     "fwd_serving_ms": serve_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library": lib,
                     "bound_ms": bound, "bound_by": by,
                     "tflop_per_s": kernel_work.FLASH_BWD_OPS_PER_PAIR_PER_D * D * pairs
                     / ms / 1e9, "bound_share": bound / ms, "errs": errs,
                     "dq_repeat_max_abs": dq_rep, "lse_err": lse_err,
                     "ptxas": ptxas, "within_tolerance": ok and lse_ok})
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# The language-model serving path: gemma3-27b at full width.
# ---------------------------------------------------------------------------

LM_ARCH = "gemma3-27b"
#: The counter of the B5 kernel each compute dtype's prefill launches.
B5_KERNEL = {torch.bfloat16: "flash_tc", torch.float32: "flash_tf32x3"}


def rel_l2(a, b):
    """Relative L2 difference per position (over the vocab axis)."""
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


def chunked_route_checks():
    """`attention_apply(impl="chunked")` at T = 200 (not a multiple of the
    kernels' 128-row tiles) at gemma3-27b's width and head layout (32 q /
    16 kv heads of 128), f32 and bf16, causal and W = 64: it launches the
    kernel `kernel_route` names, no plain version, and agrees with
    `impl="naive"` on the same weights and input within the checks of the
    `lm` phase (f32: atol = rtol = 2e-3; bf16: relative L2 per position
    <= 2^-5). `impl="pallas"` at the same T keeps the reference wrapper's
    block rule and raises; "chunked" in float16, which no kernel is built
    for, raises and launches nothing."""
    cfg = get_config(LM_ARCH)
    T = 200
    recs = []
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=DEV).manual_seed(17)
        p = attn_mod.attention_init(gen, cfg, dt)
        x = torch.randn(1, T, cfg.d_model, device=DEV, generator=gen).to(dt)
        pos = torch.arange(T, device=DEV)[None]
        for window in (None, 64):
            before = counts()
            out = attn_mod.attention_apply(p, cfg, x, pos, window=window,
                                           impl="chunked")
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in counts().items()}
            assert got[B5_KERNEL[dt]] == 1 and got["plain_flash"] == 0, got
            ref = attn_mod.attention_apply(p, cfg, x, pos, window=window,
                                           impl="naive")
            assert out.shape == ref.shape and bool(torch.isfinite(out).all())
            d = (out.float() - ref.float()).abs()
            err = rel_l2(out.float(), ref.float())
            ok = bool((d <= 2e-3 + 2e-3 * ref.float().abs()).all()) \
                if dt == torch.float32 else float(err.max()) <= 2 ** -5
            recs.append({"dtype": str(dt).split(".")[-1], "tokens": T,
                         "window": window, "kernel": B5_KERNEL[dt],
                         "max_abs_err": float(d.max()),
                         "rel_l2_max": float(err.max()),
                         "within_tolerance": ok})
            if not ok:
                raise AssertionError(f"chunked != naive at T={T}: "
                                     f"{recs[-1]}")
        try:
            attn_mod.attention_apply(p, cfg, x, pos, impl="pallas")
        except ValueError as e:
            assert "must divide block sizes" in str(e), e
        else:
            raise AssertionError("impl='pallas' at T=200 did not raise")
        del p
    gen = torch.Generator(device=DEV).manual_seed(17)
    p = attn_mod.attention_init(gen, cfg, torch.float16)
    x = torch.randn(1, T, cfg.d_model, device=DEV, generator=gen).half()
    before = counts()
    try:
        attn_mod.attention_apply(p, cfg, x, pos, impl="chunked")
    except ValueError as e:
        assert "one dtype in" in str(e), e
    else:
        raise AssertionError("impl='chunked' in float16 did not raise")
    assert counts() == before, (before, counts())
    return recs


def lm_config(quick):
    """gemma3-27b at full width; depth cut to 14 of 62 layers (two whole
    5 local + 1 global periods and the two local remainder layers, since
    62 % 6 = 14 % 6 = 2), or 8 layers with --quick."""
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=8 if quick else 14)
    assert cfg.remainder == ("local", "local"), cfg.remainder
    return cfg


def lm_tokens(cfg, B, T, seed):
    """(B, T) prompt tokens of the repo's synthetic stream, on the card."""
    toks = TokenPipeline(cfg.vocab_size, B, T, seed=seed).batch(0)["tokens"]
    return torch.from_numpy(toks[:, :T]).to(DEV)


def teacher_forcing(params, cfg, toks, dtype, paths, tag):
    """Feed `toks` one token at a time from empty caches through
    `make_serve_step` and hold every position's logits against
    `make_prefill_step(last_only=False)` on the same tokens (the JAX
    package's tests/test_archs_smoke.py check). Also measures how far
    replacing the first half of the context moves the prefill logits of
    the second half: the scale the agreement is small against."""
    B, T = toks.shape
    prefill_all = make_prefill_step(cfg, compute_dtype=dtype,
                                    last_only=False)
    with paths.path(f"lm_prefill_all{tag}"):
        ref = prefill_all(params, {"tokens": toks})
        torch.cuda.synchronize()
    half = T // 2
    other = toks.clone()
    other[:, :half] = (other[:, :half] + 1
                       + torch.arange(half, device=DEV) % 97) % cfg.vocab_size
    ctx = rel_l2(prefill_all(params, {"tokens": other})[:, half:],
                 ref[:, half:])
    serve = make_serve_step(cfg, compute_dtype=dtype)
    cache = init_cache(cfg, B, T, dtype, device=DEV)
    dec = torch.empty_like(ref)
    with paths.path(f"lm_decode{tag}"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            lg, cache = serve(params, {"tokens": toks[:, t:t + 1]}, cache)
            dec[:, t] = lg[:, 0]
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    assert bool(torch.isfinite(dec).all())
    err = rel_l2(dec, ref)
    d = (dec - ref).abs()
    return {
        "batch": B, "steps": T, "dtype": str(dtype).split(".")[-1],
        "ms_per_step": dec_s * 1e3 / T, "tokens_per_s": B * T / dec_s,
        "launches": paths.paths[f"lm_decode{tag}"],
        "prefill_launches": paths.paths[f"lm_prefill_all{tag}"],
        "rel_l2_max": float(err.max()), "rel_l2_mean": float(err.mean()),
        "max_abs_err": float(d.max()),
        "allclose_2e-3": bool((d <= 2e-3 + 2e-3 * ref.abs()).all()),
        "logit_abs_max": float(ref.abs().max()),
        "argmax_agree": float((dec.argmax(-1) == ref.argmax(-1))
                              .float().mean()),
        "context_rel_l2_median": float(ctx.median()),
        "ring_wraps": cfg.window is not None and T > cfg.window}


def lm_phase(args, paths):
    quick = args.quick
    cfg = lm_config(quick)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "n_layers_published": get_config(LM_ARCH).n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "window": cfg.window}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, args.seed, torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    rec["init_seconds"] = time.perf_counter() - t0
    rec["params"] = sum(t.numel() for t in tree_leaves(params))
    rec["param_gb"] = sum(t.numel() * t.element_size()
                          for t in tree_leaves(params)) / 1e9
    per_prefill = cfg.n_layers   # one B5 launch per attention layer

    # (a) prefill of one 32,768-token sequence (prefill_32k's length).
    T = 4096 if quick else 32768
    toks = lm_tokens(cfg, 1, T, args.seed)
    prefill = make_prefill_step(cfg)            # bf16, last-position logits
    with paths.path("lm_prefill"):
        logits = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
    got = paths.paths["lm_prefill"]
    assert got["flash_tc"] == per_prefill and got["flash_fma"] == 0 \
        and got["flash_tf32x3"] == 0, got
    assert logits.shape == (1, 1, cfg.vocab_size), logits.shape
    assert bool(torch.isfinite(logits).all())
    trace = device_trace(lambda: prefill(params, {"tokens": toks}))
    wall_ms = trace.get("wall_ms") \
        or time_host(lambda: prefill(params, {"tokens": toks}))[0]
    rec["prefill"] = {"tokens": T, "seconds": wall_ms / 1e3,
                      "tokens_per_s": T / (wall_ms / 1e3),
                      "trace": trace, "launches": got,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("lm_progress", {"prefill": rec["prefill"]})

    # (b) decode through the caches vs prefill logits (teacher forcing).
    Bd, Td = (2, 1152) if quick else (4, 1152)
    dtoks = lm_tokens(cfg, Bd, Td, args.seed + 1)
    tf = teacher_forcing(params, cfg, dtoks, torch.bfloat16, paths, "")
    assert tf.pop("prefill_launches")["flash_tc"] == per_prefill
    # bf16 bound: the logits are bf16-rounded in both paths (unit roundoff
    # u = 2^-9), and the paths round at different places inside attention
    # (f32 softmax in B5, bf16 probabilities in decode), each layer
    # carrying the last layer's difference: 16 u.
    tf["tolerance"] = "rel L2 per position <= 2^-5 (16 bf16 unit roundoffs)"
    rec["decode"] = tf
    if not tf["rel_l2_max"] <= 2 ** -5:
        raise AssertionError(f"bf16 decode != prefill: {tf}")
    serve = make_serve_step(cfg)

    def decode_steps(n=32):
        c = init_cache(cfg, Bd, Td, torch.bfloat16, device=DEV)
        for t in range(n):
            serve(params, {"tokens": dtoks[:, t:t + 1]}, c)
    rec["decode"]["trace_32_steps"] = device_trace(decode_steps)
    emit("lm_progress", {"decode": rec["decode"]})
    del params
    torch.cuda.empty_cache()

    # (c) f32: the kernel path vs impl="naive", full f32 products; then
    # decode vs prefill in f32, where the agreement is sharp enough to set
    # against how far the context moves the logits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p32 = init_params(cfg, args.seed, torch.float32, device=DEV)
    Bf, Tf = (1, 512) if quick else (2, 2048)
    ftoks = lm_tokens(cfg, Bf, Tf, args.seed + 2)
    kern = make_prefill_step(cfg, compute_dtype=torch.float32,
                             last_only=False)
    naive = make_prefill_step(dataclasses.replace(cfg, attn_impl="naive"),
                              compute_dtype=torch.float32, last_only=False)
    with paths.path("lm_prefill_f32"):
        a = kern(p32, {"tokens": ftoks})
        torch.cuda.synchronize()
    got = paths.paths["lm_prefill_f32"]
    assert got["flash_tf32x3"] == per_prefill and got["flash_fma"] == 0 \
        and got["flash_tc"] == 0, got
    with paths.path("lm_prefill_f32_naive"):
        b = naive(p32, {"tokens": ftoks})
        torch.cuda.synchronize()
    got = paths.paths["lm_prefill_f32_naive"]
    assert got["flash_tf32x3"] == 0 and got["flash_fma"] == 0, got
    d = (a - b).abs()
    ok = bool((d <= 2e-3 + 2e-3 * b.abs()).all())
    rec["f32_check"] = {
        "batch": Bf, "tokens": Tf, "allow_tf32": {
            "matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32},
        "max_abs_err": float(d.max()), "rel_l2_max": float(rel_l2(a, b).max()),
        "logit_abs_max": float(b.abs().max()),
        "tolerance": "atol = rtol = 2e-3 (the JAX package's own f32 "
                     "decode-vs-forward bound, tests/test_archs_smoke.py)",
        "within_tolerance": ok}
    del a, b, d
    if not ok:
        raise AssertionError(f"f32 kernel path != naive: {rec['f32_check']}")
    tf = teacher_forcing(p32, cfg, dtoks[:2], torch.float32, paths, "_f32")
    assert tf.pop("prefill_launches")["flash_tf32x3"] == per_prefill
    tf["tolerance"] = ("atol = rtol = 2e-3 (as above), and rel L2 per "
                       "position <= 1/4 of the median change that replacing "
                       "the first half of the context makes")
    tf["within_tolerance"] = tf.pop("allclose_2e-3") \
        and tf["rel_l2_max"] <= tf["context_rel_l2_median"] / 4
    rec["f32_check"]["decode"] = tf
    del p32
    torch.cuda.empty_cache()
    if not tf["within_tolerance"]:
        raise AssertionError(f"f32 decode != prefill: {tf}")
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


# ---------------------------------------------------------------------------
# Training: qwen3-0.6b whole, through make_train_step.
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-0.6b"
#: Labels of the train step's trace: B5 and B5-bwd by kernel, then the
#: library's kernels by the part of the name they share (cuBLAS GEMMs are
#: named nvjet / xmma / cutlass; PyTorch's elementwise and reduction
#: kernels by their templates).
TRAIN_KERNELS = {"flash_tc": "flash_tc_kernel",
                 "flash_tc_bwd_wgmma": "flash_bwd_wgmma_kernel",
                 "flash_tc_bwd_prep": "flash_bwd_prep_kernel",
                 "flash_tc_bwd_dq_cast": "flash_bwd_dq_cast_kernel",
                 "gemm_nvjet": "nvjet", "gemm_xmma": "xmma",
                 "gemm_cutlass": "cutlass", "elementwise": "elementwise",
                 "reduce": "reduce_kernel", "copies": "Memcpy"}
TRAIN_B, TRAIN_T, TRAIN_NM, TRAIN_STEPS = 8, 4096, 2, 3
#: Card gradient check (stated before its first card run): the loss on the
#: B5 route within 2^-7 relative of `attn_impl="naive"`'s, each leaf's
#: gradient within relative L2 2^-5 (bf16 compute on both sides, which
#: round at other places inside attention: 16 bf16 unit roundoffs).
GRAD_LOSS_TOL = 2 ** -7
GRAD_LEAF_TOL = 2 ** -5


#: The block kinds whose mixer is B5.
ATTN_KINDS = ("attn", "local", "moe", "moe_swa")


def launches_per_step(cfg, nm, kinds, fwd, bwd):
    """Launches one train step implies of the kernels that each layer of
    `kinds` launches once forward (`fwd`) and once backward (`bwd`). Per
    microbatch, with remat: the forward runs every block once; the
    backward replays each checkpointed period only until it has
    recomputed what the period's checkpoint saved (the inputs of its
    blocks' own checkpoints: PyTorch's non-reentrant checkpoint stops
    early), so every block of a period but the last runs again there; and
    each block's own checkpoint replays its block once more before its
    backward. So a block runs its forward three times, or twice as the
    last (or only) block of its period; a remainder layer (no checkpoint)
    once; the backward once per layer."""
    k = len(cfg.pattern)
    runs = [(3 if i < k - 1 else 2) if cfg.remat else 1 for i in range(k)]
    f = nm * (cfg.n_periods * sum(n_ for kind, n_ in zip(cfg.pattern, runs)
                                  if kind in kinds)
              + sum(kind in kinds for kind in cfg.remainder))
    b = nm * (cfg.n_periods * sum(kind in kinds for kind in cfg.pattern)
              + sum(kind in kinds for kind in cfg.remainder))
    return {**{key: f for key in fwd}, **{key: b for key in bwd}}


def model_flop(cfg, params, B, T):
    """Model FLOP of one train step (no recompute counted): 6 per
    parameter of every product and token (the tied table counted once, as
    the readout's product; norm scales excluded), plus attention's 12*D
    per live (query, key) pair and q head (4*D forward, 8*D backward)."""
    def prod_params(tree, path=""):
        if isinstance(tree, dict):
            return sum(prod_params(v, f"{path}/{k}") for k, v in tree.items())
        return 0 if "norm" in path or path.endswith(("/ln1", "/ln2")) \
            else tree.numel()
    dense = 6 * prod_params(params) * B * T
    attn = 12 * cfg.head_dim * cfg.n_layers * flash_live_pairs(
        B, cfg.n_heads, T, None)
    return dense + attn


#: Card gradient check of the f32 route (stated before its first card
#: run): qwen3-0.6b cut to 4 layers at f32 compute (TF32 off) on both
#: sides, attention on the split-TF32 kernel and its backward against
#: `attn_impl="naive"`: the loss within 1e-4 relative, each leaf's
#: gradient within relative L2 1e-3 (the xlstm check's bounds).
F32_GRAD_LOSS_TOL = 1e-4
F32_GRAD_LEAF_TOL = 1e-3


def kernel_vs_naive_grads(cfg4, seed, dtype, keys, loss_tol, leaf_tol,
                          absent=(), paths=None, tag=None):
    """`cfg4`'s loss and every leaf's gradient, 2 x 1,024 tokens at
    compute `dtype`, f32 params, with attention on B5 (the routes
    `kernel_route` and `bwd_route` pick; its forward and backward counters
    `keys`, and counters `absent` that neither side may move) against
    `attn_impl="naive"`. With `paths`, the kernel side runs as the main
    path `tag`. Returns (the record, params, batch); raises beyond the
    tolerances."""
    params = init_params(cfg4, seed, torch.float32, device=DEV)
    toks = lm_tokens(cfg4, 2, 1025, seed + 5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    res = {}
    for impl in ("chunked", "naive"):
        c = dataclasses.replace(cfg4, attn_impl=impl)
        with (paths.path(tag) if paths is not None and impl == "chunked"
              else contextlib.nullcontext()):
            before = counts()
            res[impl] = train_mod.value_and_grad(params, c, batch, dtype)
            got = {key: val - before[key] for key, val in counts().items()}
        assert all((got[key] > 0) == (impl == "chunked") for key in keys), \
            (impl, got)
        assert all(got[key] == 0 for key in absent), (impl, got)
        if impl == "chunked":
            launched = {key: val for key, val in got.items() if val}
    (l_k, g_k), (l_n, g_n) = res["chunked"], res["naive"]
    loss_rel = float((l_k - l_n).abs() / l_n.abs())
    leaf = {}
    for (_, a), (path, b) in zip(tree_leaves_with_path(g_k),
                                 tree_leaves_with_path(g_n)):
        leaf["/" + "/".join(path)] = float((a - b).norm()
                                           / b.norm().clamp_min(1e-30))
    ok = loss_rel <= loss_tol and max(leaf.values()) <= leaf_tol
    rec = {"n_layers": cfg4.n_layers, "batch": 2, "tokens": 1024,
           "compute": str(dtype).split(".")[-1], "launches": launched,
           "loss": float(l_k), "loss_naive": float(l_n),
           "loss_rel_err": loss_rel, "leaf_rel_l2": leaf,
           "leaf_rel_l2_max": max(leaf.values()),
           "tolerance": f"loss within {loss_tol} relative, each leaf's "
                        f"gradient rel L2 <= {leaf_tol}",
           "within_tolerance": ok}
    if not ok:
        raise AssertionError(f"B5 route gradients != naive: {rec}")
    return rec, params, batch


def train_grad_check(cfg, seed):
    """qwen3-0.6b at full width cut to 4 layers, 2 x 1,024 tokens, bf16
    compute, f32 params: the loss and every leaf's gradient with attention
    on B5 (`flash_tc` + B5-bwd) against `attn_impl="naive"`; then one
    compressed (int8 error-feedback) step at the trivial pod mesh."""
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    rec, params, batch = kernel_vs_naive_grads(
        cfg4, seed, torch.bfloat16, ("flash_tc", "flash_tc_bwd"),
        GRAD_LOSS_TOL, GRAD_LEAF_TOL)
    rec["compressed_step"] = compressed_step(cfg4, params, batch,
                                             ("flash_tc_bwd",),
                                             ("plain_flash",))
    return rec


def f32_grad_check(cfg, seed, paths):
    """qwen3-0.6b at full width cut to 4 layers (D 128), f32 compute and
    params (TF32 off), 2 x 1,024 tokens: the loss and every leaf's
    gradient with attention on the split-TF32 route (`flash_tf32x3` and
    the f32 backward's wgmma kernel, the main path `lm_train_f32_grads`:
    the f32 route's training launches; none of the backward's mma.sync
    kernel, which takes D 256 only) against `attn_impl="naive"`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec, _, _ = kernel_vs_naive_grads(
        dataclasses.replace(cfg, n_layers=4), seed, torch.float32,
        ("flash_tf32x3", "flash_tf32x3_bwd"), F32_GRAD_LOSS_TOL,
        F32_GRAD_LEAF_TOL, absent=("flash_tc", "flash_tc_bwd",
                                   "flash_tf32x3_bwd_mma_sync"),
        paths=paths, tag="lm_train_f32_grads")
    return rec


def compressed_step(cfg, params, batch, used, plain):
    """One `make_compressed_train_step` step (int8 error feedback) at the
    trivial pod mesh: a finite loss, opt.step 1, each counter of `used`
    launched and none of `plain` called."""
    state = {"params": params, "opt": adamw_init(params),
             "err": init_error_buffer(params)}
    step = make_compressed_train_step(
        cfg, make_debug_mesh(data=1, model=1, pod=1), peak_lr=1e-3)
    before = counts()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    got = {key: val - before[key] for key, val in counts().items()}
    assert bool(torch.isfinite(m["loss"])) \
        and int(state["opt"]["step"]) == 1 \
        and all(got[key] > 0 for key in used) \
        and all(got[key] == 0 for key in plain), (m, got)
    return {"mesh": {"pod": 1, "data": 1, "model": 1},
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "launches": {k_: v_ for k_, v_ in got.items() if v_}}


#: The dry run's peak memory against the card's (stated before its first
#: card run): the meta trace's arguments plus the peak of the live bytes it
#: allocated, within 5 % of `torch.cuda.max_memory_allocated` over the
#: same step on the card.
DRYRUN_PEAK_TOL = 0.05


def _count(counter):
    return {"product_flops": counter.flops, "aten_bytes": counter.aten_bytes,
            "aten_calls": counter.aten_calls, "kernels": counter.kernels}


def dryrun_card_check(cfg, state, batch, nm):
    """One more `make_train_step` step on the card under the dry run's
    `StepCounter` (its kernels launching and reporting their work), then
    the same step traced on meta tensors (`launch.specs.abstract_state`,
    the batch's shapes): the product FLOPs, the aten bytes and each
    kernel's calls, operations and bytes equal as integers (a mismatch
    raises with the ops that differ), and the trace's arguments plus its
    live-bytes peak within `DRYRUN_PEAK_TOL` of the card's
    `max_memory_allocated` over the step."""
    step = make_train_step(cfg, num_microbatches=nm, peak_lr=1e-3,
                           compute_dtype=torch.bfloat16)
    args_ = tree_leaves(state) + list(batch.values())
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with dryrun.StepCounter(args_) as card:
        step(state, batch)
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card_peak = torch.cuda.max_memory_allocated()
    meta_state = abstract_state(cfg)
    meta_batch = {k_: torch.empty(v_.shape, dtype=v_.dtype, device="meta")
                  for k_, v_ in batch.items()}
    margs = tree_leaves(meta_state) + list(meta_batch.values())
    t0 = time.perf_counter()
    with dryrun.StepCounter(margs) as meta:
        step(meta_state, meta_batch)
    meta_s = time.perf_counter() - t0
    arg_bytes = sum(t.numel() * t.element_size() for t in margs)
    predicted = arg_bytes + meta.peak
    rec = {"arch": cfg.name, "batch": list(next(iter(batch.values())).shape),
           "card": _count(card), "meta": _count(meta),
           "equal": _count(card) == _count(meta),
           "card_seconds": card_s, "meta_seconds": meta_s,
           "argument_bytes": arg_bytes,
           "allocated_before_bytes": allocated,
           "traced_peak_temp_bytes": meta.peak,
           "predicted_peak_bytes": predicted,
           "card_peak_bytes": card_peak,
           "peak_rel_err": predicted / card_peak - 1,
           "peak_tol": DRYRUN_PEAK_TOL}
    if not rec["equal"]:
        ops = sorted(set(card.by_op) | set(meta.by_op))
        rec["ops_differing"] = {
            op: {"card": card.by_op.get(op), "meta": meta.by_op.get(op)}
            for op in ops if card.by_op.get(op) != meta.by_op.get(op)}
        raise AssertionError(f"dry run != card count: {rec}")
    assert abs(rec["peak_rel_err"]) <= DRYRUN_PEAK_TOL, rec
    return rec


#: The dry run's subset on the card machine's host: every shape of these
#: archs on the single-pod mesh, and the alignment cells.
DRYRUN_ARCHS = ("qwen3-0.6b", "xlstm-125m", "rapidx-align")


def dryrun_phase(lm_train, lm_train_xl, mesh):
    """(a) `launch.dryrun` on the meta device for `DRYRUN_ARCHS` on the
    single mesh: ok / skip / error counts, seconds, GB and GFLOP per
    device, each LM cell beside `analytic_roofline`'s FLOPs per device;
    B6's scratch size in Python against its libraries'; (b) the train
    steps' card-against-meta counts (`dryrun_card_check`, run inside
    `lm_train` and `lm_train_xlstm`); (c) the mesh phase's trace read by
    `collective_bytes_by_kind`, all zero. Any error fails the run."""
    t0 = time.perf_counter()
    cells = []
    counts = collections.Counter()
    out_dir = str(build.build_dir() / "dryrun_smoke")
    for arch, shape, mesh_name in dryrun.plan(list(DRYRUN_ARCHS),
                                              meshes=("single",)):
        rec = dryrun.run_cell(arch, shape, mesh_name, skip_existing=False,
                              results_dir=out_dir)
        tag = "skip" if rec.get("skipped") else rec["status"]
        counts[tag] += 1
        cell = {"cell": f"{arch}/{shape}/{mesh_name}", "status": tag,
                "seconds": rec["compile_seconds"]}
        if tag == "ok":
            cell.update(
                gb_per_device=rec["memory"]["total_per_device"] / 1e9,
                gflop_per_device=rec["flops_per_device"] / 1e9,
                collective_bytes_per_device=rec["collectives"]
                ["total_bytes"])
            if arch != "rapidx-align":
                cell["analytic_gflop_per_device"] = analytic_roofline(
                    rec)["flops_per_device"] / 1e9
        else:
            cell["error"] = rec.get("error")
        cells.append(cell)
    assert counts["error"] == 0, cells
    scratch = {}
    for name in ("rglru_scan", "rglru_scan_bwd"):
        for B, T, D in ((1, 32768, 4096), (2, 4096, 4096), (3, 1000, 1003)):
            py, lib = rglru_mod.scratch_bytes(B, T, D), \
                rglru_mod._lib(name)[1](B, T, D)
            assert py == lib, (name, B, T, D, py, lib)
            scratch[f"{name}/{B}x{T}x{D}"] = py
    checks = {"lm_train": lm_train["dryrun_check"],
              "lm_train_xlstm": lm_train_xl["dryrun_check"]}
    coll = mesh["trace"]["collectives"]
    assert coll["total_bytes"] == 0 and all(
        coll[k]["count"] == 0 for k in COLLECTIVE_KINDS), coll
    return {"subset": {"cells": cells, "counts": dict(counts),
                       "seconds": time.perf_counter() - t0},
            "card_vs_meta": {k_: {key: v_[key] for key in (
                "arch", "batch", "equal", "card", "card_seconds",
                "meta_seconds", "argument_bytes", "allocated_before_bytes",
                "traced_peak_temp_bytes", "predicted_peak_bytes",
                "card_peak_bytes", "peak_rel_err", "peak_tol")}
                for k_, v_ in checks.items()},
            "rglru_scratch_bytes_equal": scratch,
            "mesh_collectives": coll,
            "seconds": time.perf_counter() - t0
            + sum(v_["card_seconds"] + v_["meta_seconds"]
                  for v_ in checks.values())}


def train_run(args, paths, cfg, tag, B, T, nm, seed, trace_kernels,
              want_per_step, count_step=False):
    """`make_train_step` on `cfg` (f32 params and AdamW moments, bf16
    compute), B x T tokens in `nm` microbatches, `TRAIN_STEPS` steps on
    one batch inside the main path `tag`: finite losses, the second <=
    1.2 x the first, opt.step == TRAIN_STEPS, and each kernel's launches
    equal to `TRAIN_STEPS` x `want_per_step` (no plain version: the path
    fails on one). Step 2 is timed on the host clock, step 3 traced
    (`trace_kernels`). Returns (the record, the final state)."""
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, args.seed, torch.float32,
                             device=DEV).tree()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    toks = lm_tokens(cfg, B, T + 1, args.seed + seed)
    batch = split_microbatches({"tokens": toks[:, :-1],
                                "labels": toks[:, 1:]}, nm)
    step = make_train_step(cfg, num_microbatches=nm, peak_lr=1e-3,
                           compute_dtype=torch.bfloat16)
    losses, wall = [], []
    trace = None
    with paths.path(tag):
        for i in range(TRAIN_STEPS):
            if i == TRAIN_STEPS - 1:
                trace = device_trace(
                    lambda: losses.append(step(state, batch)[1]),
                    kernels=trace_kernels, wall_ms=wall[-1])
                continue
            ms, (_, m) = time_host(lambda: step(state, batch))
            wall.append(ms)
            losses.append(m)
    got = paths.paths[tag]
    want = {k_: TRAIN_STEPS * v_ for k_, v_ in want_per_step.items()}
    loss = [float(m["loss"]) for m in losses]
    assert all(np.isfinite(loss)), loss
    assert loss[1] <= 1.2 * loss[0], loss
    assert int(state["opt"]["step"]) == TRAIN_STEPS
    assert all(got[k_] == v_ for k_, v_ in want.items()), (got, want)
    step_ms = wall[-1]
    counted = dryrun_card_check(cfg, state, batch, nm) if count_step \
        else None
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "batch": B, "tokens": T, "num_microbatches": nm,
           "dtypes": {"params": "float32", "moments": "float32",
                      "compute": "bfloat16"},
           "losses": loss, "grad_norms": [float(m["grad_norm"])
                                          for m in losses],
           "lrs": [float(m["lr"]) for m in losses],
           "opt_step": int(state["opt"]["step"]),
           "first_step_ms": wall[0], "ms_per_step": step_ms,
           "tokens_per_s": B * T / (step_ms / 1e3),
           "launches": got, "launches_expected": want,
           "trace": trace,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if counted is not None:
        rec["dryrun_check"] = counted
    return rec, state


def lm_train_phase(args, paths):
    """qwen3-0.6b whole (28 layers, full width), f32 params and AdamW
    moments, bf16 compute, B 8 x T 4,096 in two microbatches, three
    `make_train_step` steps on one batch (the JAX package's
    test_train_step_reduces_and_stays_finite at full size), through
    `train_run`: B5 launches as the remat scheme implies and none of the
    f32 routes; the model FLOP and MFU of a step. Then the card gradient
    check (`train_grad_check`) and the f32 one on the split-TF32 route
    (`f32_grad_check`)."""
    cfg = get_config(TRAIN_ARCH)
    B, T, nm = (2, 1024, 2) if args.quick else (TRAIN_B, TRAIN_T, TRAIN_NM)
    rec, state = train_run(args, paths, cfg, "lm_train", B, T, nm, 3,
                           TRAIN_KERNELS, launches_per_step(
                               cfg, nm, ATTN_KINDS, ("flash_tc",),
                               ("flash_tc_bwd",)), count_step=True)
    got = rec["launches"]
    assert got["flash_tf32x3"] == 0 and got["flash_fma"] == 0, got
    flop = model_flop(cfg, state["params"], B, T)
    rec.update(model_flop_per_step=flop,
               model_flop="6 x product params x tokens + 12 x D x live "
                          "(query, key) pairs x q heads x layers",
               train_mfu=flop / (rec["ms_per_step"] / 1e3) / BF16_FLOP_PER_S)
    del state
    torch.cuda.empty_cache()
    emit("lm_progress", {"lm_train": {k_: v_ for k_, v_ in rec.items()
                                      if k_ != "trace"}})
    rec["grad_check"] = train_grad_check(cfg, args.seed)
    torch.cuda.empty_cache()
    rec["f32_grad_check"] = f32_grad_check(cfg, args.seed, paths)
    torch.cuda.empty_cache()
    return rec


#: The training launcher's path (`launch.train.main`) on qwen3-0.6b whole:
#: a fresh run to step 3 (saves at 0 and 3), a resume to step 5, then
#: `run_resilient_loop` with the launcher's step and data functions from
#: step 5 to 8 with a NaN injected at step 6 (rolled back to the step-5
#: checkpoint, step 6 skipped, a save at 8). The reference's loop cannot
#: save at 7 after skipping step 6, the last step of a 7-step run, so the
#: loop runs one more step.
RESILIENT_STEPS = (3, 5, 8)
RESILIENT_FAIL = 6
#: Checkpoints on disk at once at most: keep_last 3 and one being written.
RESILIENT_DISK_FACTOR = 4


def tagged(events, run):
    return [dict(e, run=run) for e in events]


def lm_train_resilient_phase(args, paths):
    """`launch.train.main` on qwen3-0.6b whole (28 layers, f32 state, bf16
    compute, B 8 x T 4,096 in two microbatches) through a fresh run, a
    round trip of its last checkpoint through disk (`checkpoint.restore`
    on the card: every leaf `torch.equal`, same dtype and device), a
    resume, a NaN rollback (`run_resilient_loop`) and an elastic re-place
    (`plan_mesh` + `reshard`), as the main path `lm_train_resilient`: B5
    and B5-bwd launches as `launches_per_step` implies for every step run,
    no plain version. The checkpoints go under `build/` (its free space
    checked first against 4 x a checkpoint) and are deleted after."""
    cfg = get_config(TRAIN_ARCH)
    B, T, nm = (2, 1024, 2) if args.quick else (TRAIN_B, TRAIN_T, TRAIN_NM)
    argv = ["--arch", TRAIN_ARCH, "--global-batch", str(B), "--seq", str(T),
            "--microbatches", str(nm)]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    ckpt = os.path.join(root, "ckpt_resilient")
    shutil.rmtree(ckpt, ignore_errors=True)
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      tree_leaves_with_path(abstract_state(cfg)))
    free = shutil.disk_usage(root).free
    if free < RESILIENT_DISK_FACTOR * state_bytes:
        raise RuntimeError(
            f"{free} bytes free under {root}; {RESILIENT_DISK_FACTOR} "
            f"checkpoints of {state_bytes} bytes need "
            f"{RESILIENT_DISK_FACTOR * state_bytes}")
    fresh_n, resume_n, loop_n = RESILIENT_STEPS
    per_step = launches_per_step(cfg, nm, ATTN_KINDS, ("flash_tc",),
                                 ("flash_tc_bwd",))
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": B,
           "tokens": T, "num_microbatches": nm, "state_bytes": state_bytes,
           "disk_free_bytes": free}
    try:
        with paths.path("lm_train_resilient"):
            t0 = time.perf_counter()
            state, fresh = train_launcher.main(
                argv + ["--steps", str(fresh_n), "--ckpt-dir", ckpt])
            rec["fresh_s"] = time.perf_counter() - t0
            assert fresh["start_step"] == 0 and int(
                state["opt"]["step"]) == fresh_n, fresh
            assert latest_step(ckpt, all_steps=True) == [0, fresh_n]
            assert not [f for f in os.listdir(ckpt) if f.endswith(".tmp")]
            rec["checkpoint_bytes"] = os.path.getsize(os.path.join(
                ckpt, f"step_{fresh_n:08d}", "arrays.npz"))
            t0 = time.perf_counter()
            back, meta = ckpt_restore(ckpt, state)
            torch.cuda.synchronize()
            rec["round_trip_restore_s"] = time.perf_counter() - t0
            n_leaves = 0
            for (path, a), (_, b) in zip(tree_leaves_with_path(state),
                                         tree_leaves_with_path(back)):
                assert (a.dtype, a.device, a.shape) \
                    == (b.dtype, b.device, b.shape) and torch.equal(a, b), \
                    path
                n_leaves += 1
            assert meta["step"] == fresh_n
            rec["round_trip"] = {"leaves": n_leaves, "bit_equal": True,
                                 "device": str(DEV)}
            del back, state
            torch.cuda.empty_cache()

            t0 = time.perf_counter()
            state, resumed = train_launcher.main(
                argv + ["--steps", str(resume_n), "--ckpt-dir", ckpt])
            rec["resume_s"] = time.perf_counter() - t0
            assert resumed["start_step"] == fresh_n \
                and int(state["opt"]["step"]) == resume_n \
                and len(resumed["loss"]) == resume_n - fresh_n, resumed
            assert latest_step(ckpt) == resume_n

            loop_args = train_launcher.parse_args(
                argv + ["--steps", str(loop_n), "--ckpt-dir", ckpt])
            data_fn, step_fn = train_launcher.train_functions(loop_args, cfg,
                                                              DEV)
            manager = CheckpointManager(ckpt, keep_last=3)
            monitor = StepMonitor()
            log = []
            t0 = time.perf_counter()
            state, loop = run_resilient_loop(
                state, step_fn, data_fn, num_steps=loop_n, manager=manager,
                policy=RecoveryPolicy(ckpt_every=loop_args.ckpt_every),
                monitor=monitor, fail_at={RESILIENT_FAIL},
                start_step=resume_n, log=log.append)
            rec["rollback_run_s"] = time.perf_counter() - t0
            assert loop["rollbacks"] == 1 \
                and loop["skipped"] == [RESILIENT_FAIL], loop
            assert latest_step(ckpt) == loop_n
            assert latest_step(ckpt, all_steps=True) == [fresh_n, resume_n,
                                                         loop_n]
            # Steps 5, 6 (NaN), 5 again after the rollback, 7.
            assert len(loop["loss"]) == 3
            assert int(state["opt"]["step"]) == loop_n - 1
            assert all(t.device == DEV
                       for _, t in tree_leaves_with_path(state))
        losses = fresh["loss"] + resumed["loss"] + loop["loss"]
        assert all(np.isfinite(losses)), losses
        n_steps = fresh_n + (resume_n - fresh_n) + 4
        got = paths.paths["lm_train_resilient"]
        want = {k_: n_steps * v_ for k_, v_ in per_step.items()}
        assert all(got[k_] == v_ for k_, v_ in want.items()) \
            and got["flash_tf32x3"] == 0 and got["flash_fma"] == 0, \
            (got, want)

        t0 = time.perf_counter()
        # A one-card mesh: `reshard` refuses a mesh over several cards (the
        # port keeps every parameter whole on one card).
        mesh = plan_mesh(1, model_parallel=1)
        placed = reshard(state["params"], mesh)
        torch.cuda.synchronize()
        target = mesh.devices.reshape(-1)[0]
        for (path, a), (_, b) in zip(tree_leaves_with_path(state["params"]),
                                     tree_leaves_with_path(placed)):
            assert b.device == target and torch.equal(a, b), path
        rec["elastic"] = {"mesh": mesh.shape, "device": str(target),
                          "leaves_equal": True,
                          "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    steps_s = fresh["step_seconds"][1:] + resumed["step_seconds"][1:] \
        + monitor.durations[1:]
    events = (tagged(fresh["checkpoints"], "fresh")
              + tagged(resumed["checkpoints"], "resume")
              + tagged(manager.events, "rollback"))
    rollback_restores = [e for e in manager.events if e["op"] == "restore"]
    rec.update(
        losses={"fresh": fresh["loss"], "resume": resumed["loss"],
                "rollback_loop": loop["loss"]},
        loss_step5_repeat_rel=abs(loop["loss"][1] - loop["loss"][0])
        / abs(loop["loss"][0]),
        step_seconds={"fresh": fresh["step_seconds"],
                      "resume": resumed["step_seconds"],
                      "rollback_loop": monitor.durations},
        ms_per_step=float(np.median(steps_s)) * 1e3,
        saves=[e for e in events if e["op"] == "save"],
        restores=[e for e in events if e["op"] == "restore"],
        rollback={"rollbacks": loop["rollbacks"], "skipped": loop["skipped"],
                  "restore_s": rollback_restores[0]["seconds"],
                  "log": log, "latest_step": loop_n,
                  "opt_step": int(state["opt"]["step"])},
        launches=got, launches_expected=want, steps_run=n_steps)
    del state, placed
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Recurrent kernels (B6-B8) vs their plain versions.
# ---------------------------------------------------------------------------

#: Kernel vs plain for B6-B8 (stated before their first card run): both
#: sides compute in f32, the kernels summing in other orders (B6's chunked
#: scan, B7's reassociated chunk products and warp scans, B8's split dot
#: products), so each f32 output may differ by 1e-4 of the largest |plain
#: value| of that output; a bf16 output (B6's y) by one bf16 ulp of the
#: value more (both round an f32 result).
REC_TOL = 1e-4
# Special-function (MUFU) operations per (b, t, d) of B6's gates: an
# exponential and a reciprocal for each sigmoid, the exponential of a,
# the square root.
RGLRU_SFU_PER_ELEM = 6
# MUFU results per SM per clock on Hopper (4 per SM sub-partition).
SFU_PER_SM_CLOCK = 16


def rec_err(out, ref, rel=REC_TOL):
    """(max |out - ref|, within `rel` x max |ref| (`REC_TOL` by default);
    a bf16 output one bf16 ulp of the value more)."""
    d = (out.float() - ref.float()).abs()
    tol = rel * float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        r = ref.float().abs()
        ok = bool((d <= torch.exp2(torch.floor(torch.log2(
            r.clamp_min(1e-30))) - 7) + tol).all())
    else:
        ok = float(d.max()) <= tol
    return float(d.max()), ok


def rec_errs(outs, refs, rel=REC_TOL):
    errs = [rec_err(a, b, rel) for a, b in zip(outs, refs)]
    return max(e for e, _ in errs), all(ok for _, ok in errs)


def sfu_floor_ms(n_ops):
    """(ms, facts): the least time the card's special-function units take
    for `n_ops` MUFU operations — 16 results per SM per clock (Hopper's
    four SFU quads per SM), at the SM count torch reports and the
    highest SM clock nvidia-smi gives."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    per_s = sms * SFU_PER_SM_CLOCK * mhz * 1e6
    return n_ops / per_s * 1e3, {"sms": sms, "max_sm_mhz": mhz,
                                 "mufu_per_s": per_s}


def rglru_inputs(B, T, D, dtype, seed, with_h0=False, lam_dtype=None,
                 wa_shift=0.0):
    """Random dense outputs wa, wx and x (N(0, 1), wa shifted by
    `wa_shift`), Lambda in the Griffin init's range in `lam_dtype` (x's
    by default) and, `with_h0`, an incoming h. `wa_shift` = -8 is the
    long-memory recipe: r = sigmoid(wa) ~ 3e-4, a ~ 0.998 — the product of
    a over 64 steps ~ 0.8, Griffin's intended a in [0.9, 0.999] — where
    the unshifted recipe (a ~ 0.04) forgets the carry within a few steps."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    wa, wx, x = (torch.randn(B, T, D, device=DEV, generator=g).to(dtype)
                 for _ in range(3))
    if wa_shift:
        wa = (wa.float() + wa_shift).to(dtype)
    lam = (0.01 + 0.49 * torch.rand(D, device=DEV, generator=g)).to(
        lam_dtype or dtype)
    h0 = torch.randn(B, D, device=DEV, generator=g) if with_h0 else None
    return wa, wx, x, lam, h0


def rglru_check(name, B, T, D, dtype, seed, with_h0=False, reps=0,
                lam_dtype=None, wa_shift=0.0):
    """B6 against `rglru_scan_plain` on `rglru_inputs`; when `reps` > 0
    timed, with the SFU floor beside the bound."""
    wa, wx, x, lam, h0 = rglru_inputs(B, T, D, dtype, seed, with_h0,
                                      lam_dtype, wa_shift)
    out = rglru_mod.rglru_scan_cuda(wa, wx, x, lam, h0)
    torch.cuda.synchronize()
    plain_ms, ref = time_host(
        lambda: rglru_mod.rglru_scan_plain(wa, wx, x, lam, h0))
    err, ok = rec_errs(out, ref)
    rec = {"shape": name, "B": B, "T": T, "D": D,
           "dtype": str(dtype).split(".")[-1],
           "lam_dtype": str(lam.dtype).split(".")[-1], "h0": with_h0,
           "wa_shift": wa_shift,
           "tile": [rglru_mod.KERNEL_CHUNK, rglru_mod.KERNEL_CHANNELS,
                    rglru_mod.KERNEL_WARPS],
           "max_abs_err": err, "within_tolerance": ok, "plain_ms": plain_ms}
    if reps:
        bound, by = kernel_work.rglru(B, T, D, x.element_size(),
                                      lam.element_size(), with_h0).bound()

        sfu_ms, sfu = sfu_floor_ms(B * T * D * RGLRU_SFU_PER_ELEM)
        rec.update(ms=time_cuda(
            lambda: rglru_mod.rglru_scan_cuda(wa, wx, x, lam, h0), reps),
            bound_ms=bound, bound_by=by, sfu_floor_ms=sfu_ms, sfu=sfu)
    if not ok:
        raise AssertionError(f"B6 != plain: {rec}")
    return rec


def sm_clock_sampler():
    """A background `nvidia-smi` that samples the SM clock (MHz) and the
    board's power draw (W) every 20 ms; `stop()` ends it and returns the
    (MHz, W) samples."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    time.sleep(0.5)  # nvidia-smi's own start-up

    def stop():
        proc.terminate()
        out, _ = proc.communicate(timeout=10)
        return [tuple(float(v) for v in line.split(","))
                for line in out.splitlines() if line.count(",") == 1]
    return stop


def rglru_in_context(B, T, D, seed, rounds):
    """B6 at recurrentgemma-9b's prefill shape timed per call in two
    settings, with the SM clock and power sampled during each: alone,
    calls back to back; and as in the prefill, each call right after the
    two dense products that make its wa and wx (bf16 GEMMs of (B T, D) by
    (D, D), their outputs its inputs). CUDA events around each B6 call
    (its memset and kernel); the median over `rounds` calls."""
    wa, wx, x, lam, _ = rglru_inputs(B, T, D, torch.bfloat16, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    w_a, w_x = ((torch.randn(D, D, device=DEV, generator=g) / D ** 0.5)
                .to(torch.bfloat16) for _ in range(2))
    xs = x.view(B * T, D)

    def run(between_gemms):
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(rounds)]
        a_in, x_in = wa, wx
        torch.cuda.synchronize()
        stop = sm_clock_sampler()
        try:
            torch.cuda._sleep(int(200 * 2e6))  # ~0.2 s: the host runs ahead
            for e0, e1 in ev:
                if between_gemms:
                    a_in = (xs @ w_a).view(B, T, D)
                    x_in = (xs @ w_x).view(B, T, D)
                e0.record()
                rglru_mod.rglru_scan_cuda(a_in, x_in, x, lam)
                e1.record()
            torch.cuda.synchronize()
        finally:
            samples = stop()
        ms = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
        mhz = sorted(m for m, _ in samples)
        watts = sorted(w for _, w in samples)
        return {"ms_median": ms[len(ms) // 2], "ms_min": ms[0],
                "ms_max": ms[-1], "samples": len(samples),
                "sm_mhz_median": mhz[len(mhz) // 2] if mhz else None,
                "sm_mhz_min": mhz[0] if mhz else None,
                "power_w_median": watts[len(watts) // 2] if watts else None}
    alone = run(False)
    return {"rounds": rounds, "alone": alone,
            "between_gemms": run(True), "alone_again": run(False)}


def mlstm_inputs(B, H, T, D, seed, with_state=False, extreme=0,
                 spike=6.0, shared_qk=True):
    """q, k, v as the (B, H, T, D) views `_mlstm_qkv_gates` makes (k
    scaled by 1/sqrt(D)), gates i~ ~ N(0, 1) and f~ = log_sigmoid(N(0, 1)
    + 1); a random carried state when `with_state`. `extreme` = the chunk
    length L: tests/test_torch_xlstm_passes.py's extreme gates, by chunk c
    — i~ + `spike` on the middle step when c % 3 == 0, i~ - 40 on every
    step when c % 3 == 1 (M_c keeps the carried m), the forget
    pre-activation - 8 on the middle step when c % 3 == 2 (M_c = G_c) —
    and, with `shared_qk`, q, k shifted by 2 and 2/sqrt(D) on every column
    (a shared direction that keeps the normaliser away from zero, so that
    f32 in any order is good to ~1e-6 of the largest output). Without it
    and with a spike of 15 some rows' |n . q| nears the stabiliser's floor
    exp(-m), and f32 in any order strays (`mlstm_f64_witness`)."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def heads():
        return torch.randn(B, T, H, D, device=DEV, generator=g) \
            .transpose(1, 2)
    q, k, v = heads(), heads() / D ** 0.5, heads()
    it = torch.randn(B, T, H, device=DEV, generator=g)
    fpre = torch.randn(B, T, H, device=DEV, generator=g) + 1.0
    if extreme:
        L = extreme
        t = torch.arange(T, device=DEV)[None, :, None]
        c, mid = t // L, t % L == L // 2
        it = torch.where(mid & (c % 3 == 0), it + spike, it)
        it = torch.where(c % 3 == 1, it - 40.0, it)
        fpre = torch.where(mid & (c % 3 == 2), fpre - 8.0, fpre)
        if shared_qk:
            q, k = q + 2.0, k + 2.0 / D ** 0.5
    it = it.transpose(1, 2)
    ft = torch.nn.functional.logsigmoid(fpre).transpose(1, 2)
    state = xlstm_mod.mlstm_state_init(B, H, D, device=DEV)
    if with_state:
        state = {"C": torch.randn(B, H, D, D, device=DEV, generator=g),
                 "n": torch.randn(B, H, D, device=DEV, generator=g),
                 "m": torch.randn(B, H, device=DEV, generator=g)}
    return q, k, v, it, ft, state


def mlstm_bounds(B, H, T, D, L):
    """{"whole" and each pass: (ms, what binds, fma_ms)} of B7
    (`kernels.work.mlstm`: the products at the TF32 peak, the other f32
    operations on the FMA units); `fma_ms` with every operation on the
    FMA units, the bound before the products went to the tensor cores."""
    return {key: (*w.bound(), w.at("f32").bound()[0])
            for key, w in kernel_work.mlstm(B, H, T, D, L).items()}


def mlstm_check(name, B, H, T, D, chunk, seed, with_state=False,
                extreme=0, reps=0):
    """B7 on the card: the whole (the three pass kernels) against
    `mlstm_chunk_scan_plain`, and each pass kernel against its plain
    version fed by the plain versions of the passes before it. With
    `reps`, the whole and each pass alone timed."""
    q, k, v, it, ft, state = mlstm_inputs(B, H, T, D, seed, with_state,
                                          extreme)
    args = (q, k, v, it, ft, state, chunk)
    keys = ("C", "n", "m")
    h, st = xlstm_mod.mlstm_chunk_scan_cuda(*args)
    torch.cuda.synchronize()
    plain_ms, (hr, sr) = time_host(
        lambda: xlstm_mod.mlstm_chunk_scan_plain(*args))
    refs = [hr, *(sr[k_] for k_ in keys)]
    err, ok = rec_errs([h, *(st[k_] for k_ in keys)], refs)

    def parts(work, scal, m_col):
        return [work[..., :D, :D], work[..., D, :D], scal[..., m_col]]
    passes = {}
    ms1, (wp, sp) = time_host(
        lambda: xlstm_mod.mlstm_chunk_states_plain(k, v, it, ft, chunk))
    wc, sc = xlstm_mod.mlstm_chunk_states_cuda(k, v, it, ft, chunk)
    passes["mlstm_chunk_states"] = (ms1, *rec_errs(
        parts(wc, sc, 0) + [sc[..., 1]], parts(wp, sp, 0) + [sp[..., 1]]))
    wc, sc = wp.clone(), sp.clone()
    ms2, sr2 = time_host(
        lambda: xlstm_mod.mlstm_state_scan_plain(wp, sp, state))
    st2 = xlstm_mod.mlstm_state_scan_cuda(wc, sc, state)
    passes["mlstm_state_scan"] = (ms2, *rec_errs(
        parts(wc, sc, 2) + [st2[k_] for k_ in keys],
        parts(wp, sp, 2) + [sr2[k_] for k_ in keys]))
    ms3, hp = time_host(lambda: xlstm_mod.mlstm_chunk_outputs_plain(
        q, k, v, it, ft, wp, sp, chunk))
    hc = xlstm_mod.mlstm_chunk_outputs_cuda(q, k, v, it, ft, wp, sp, chunk)
    passes["mlstm_chunk_outputs"] = (ms3, *rec_err(hc, hp))
    rec = {"shape": name, "B": B, "H": H, "T": T, "D": D, "chunk": chunk,
           "state_in": with_state, "extreme_gates": bool(extreme),
           "max_abs_err": err, "within_tolerance": ok, "plain_ms": plain_ms,
           "scratch_bytes": xlstm_mod.mlstm_work_bytes(B, H, T, D, chunk),
           "passes": {key: {"plain_ms": p[0], "max_abs_err": p[1],
                            "within_tolerance": p[2]}
                      for key, p in passes.items()}}
    if reps:
        bounds = mlstm_bounds(B, H, T, D, chunk)
        rec.update(ms=time_cuda(
            lambda: xlstm_mod.mlstm_chunk_scan_cuda(*args), reps),
                   bound_ms=bounds["whole"][0],
                   bound_by=bounds["whole"][1],
                   fma_bound_ms=bounds["whole"][2])
        wt, stt = wp.clone(), sp.clone()
        for key, fn in (
                ("mlstm_chunk_states",
                 lambda: xlstm_mod.mlstm_chunk_states_cuda(k, v, it, ft,
                                                           chunk)),
                ("mlstm_state_scan",
                 lambda: xlstm_mod.mlstm_state_scan_cuda(wt, stt, state)),
                ("mlstm_chunk_outputs",
                 lambda: xlstm_mod.mlstm_chunk_outputs_cuda(
                     q, k, v, it, ft, wp, sp, chunk))):
            passes_rec = rec["passes"][key]
            passes_rec.update(ms=time_cuda(fn, reps),
                              bound_ms=bounds[key][0],
                              bound_by=bounds[key][1],
                              fma_bound_ms=bounds[key][2])
    if not (ok and all(p[2] for p in passes.values())):
        raise AssertionError(f"B7 != plain: {rec}")
    return rec


def mlstm_f64_witness(name, B, H, T, D, chunk, seed):
    """B7 at the extreme gates' ill-conditioned recipe
    (`mlstm_inputs(..., spike=15, shared_qk=False)`, a carried state),
    where f32 in any summation order may stray from the exact answer by
    more than `REC_TOL`: the kernel and the f32 plain version held against
    `mlstm_chunk_scan_plain` in f64 on the same inputs, so that the record
    shows which side strays. Gate (stated before its first card run), per
    output: the kernel's distance from the f64 result <= the f32 plain
    version's distance from it + REC_TOL x max |f64|. Whether the kernel
    also lies within REC_TOL x max |f64| outright is recorded beside."""
    q, k, v, it, ft, state = mlstm_inputs(B, H, T, D, seed, True, chunk,
                                          spike=15.0, shared_qk=False)
    args = (q, k, v, it, ft, state, chunk)
    keys = ("C", "n", "m")

    def outs(h_st):
        return [h_st[0], *(h_st[1][k_] for k_ in keys)]
    ref = outs(xlstm_mod.mlstm_chunk_scan_plain(
        *(x.double() for x in args[:5]),
        {k_: x.double() for k_, x in state.items()}, chunk))
    plain = outs(xlstm_mod.mlstm_chunk_scan_plain(*args))
    designs = {"new": outs(xlstm_mod.mlstm_chunk_scan_cuda(*args))}
    torch.cuda.synchronize()

    def dist(a, b):
        return [float((x.double() - y.double()).abs().max())
                for x, y in zip(a, b)]
    tols = [REC_TOL * float(r.abs().max()) for r in ref]
    plain_d = dist(plain, ref)
    rec = {"shape": name, "B": B, "H": H, "T": T, "D": D, "chunk": chunk,
           "recipe": "i~ + 15 spike, no shared q/k direction, carried state",
           "outputs": ["h", *keys], "tol_f64": tols,
           "plain_f32_vs_f64": plain_d}
    ok = True
    for key, out in designs.items():
        d = dist(out, ref)
        gate = all(x <= p + t for x, p, t in zip(d, plain_d, tols))
        ok = ok and gate
        rec[key] = {"vs_f64": d, "vs_plain_f32": dist(out, plain),
                    "within_rec_tol_of_f64": all(
                        x <= t for x, t in zip(d, tols)),
                    "within_gate": gate}
    rec["within_gate"] = ok
    if not ok:
        raise AssertionError(f"B7 strays from f64 beyond f32 plain: {rec}")
    return rec


def witness_summary(witness):
    """`mlstm_f64_witness` records of several seeds, h only: each side's
    largest distance from the f64 result, the seeds on which each side
    lies beyond REC_TOL x max |f64|, and on how many seeds the kernel lies
    nearer the f64 result than the f32 plain version."""
    def beyond(side):
        return [w["shape"] for w in witness if side(w) > w["tol_f64"][0]]
    return {
        "seeds": len(witness),
        "max_vs_f64": max(w["new"]["vs_f64"][0] for w in witness),
        "max_plain_f32_vs_f64": max(w["plain_f32_vs_f64"][0]
                                    for w in witness),
        "beyond_tol": {
            "new": beyond(lambda w: w["new"]["vs_f64"][0]),
            "plain_f32": beyond(lambda w: w["plain_f32_vs_f64"][0])},
        "new_nearer_than_plain_f32": sum(
            w["new"]["vs_f64"][0] < w["plain_f32_vs_f64"][0]
            for w in witness)}


def slstm_inputs(B, T, H, Dh, dtype, seed, with_state=False):
    """wx ~ N(0, 1) (the dense outputs of a normalised input), R ~ N(0,
    1/Dh) as the init; a random state when `with_state` (n > 0, as the
    recurrence keeps it)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    d = H * Dh
    wx = {gn: torch.randn(B, T, d, device=DEV, generator=g).to(dtype)
          for gn in "zifo"}
    r = {gn: (torch.randn(H, Dh, Dh, device=DEV, generator=g)
              * Dh ** -0.5).to(dtype) for gn in "zifo"}
    state = xlstm_mod.slstm_state_init(B, H, Dh, device=DEV)
    if with_state:
        state = {"h": torch.rand(B, H, Dh, device=DEV, generator=g) * 2 - 1,
                 "c": torch.randn(B, H, Dh, device=DEV, generator=g),
                 "n": 1 + torch.rand(B, H, Dh, device=DEV, generator=g),
                 "m": torch.randn(B, H, Dh, device=DEV, generator=g)}
    return wx, r, state


def slstm_check(name, B, T, H, Dh, dtype, seed, with_state=False, reps=0):
    """B8 against `slstm_scan_plain`; timed with `reps`."""
    wx, r, state = slstm_inputs(B, T, H, Dh, dtype, seed, with_state)
    keys = ("h", "c", "n", "m")
    h, st = xlstm_mod.slstm_scan_cuda(wx, r, state)
    torch.cuda.synchronize()
    plain_ms, (hr, sr) = time_host(
        lambda: xlstm_mod.slstm_scan_plain(wx, r, state))
    refs = [hr, *(sr[k_] for k_ in keys)]
    err, ok = rec_errs([h, *(st[k_] for k_ in keys)], refs)
    rec = {"shape": name, "B": B, "T": T, "H": H, "Dh": Dh,
           "dtype": str(dtype).split(".")[-1], "state_in": with_state,
           "cluster": xlstm_mod.slstm_cluster(Dh),
           "max_abs_err": err, "within_tolerance": ok, "plain_ms": plain_ms}
    if reps:
        bound, by = kernel_work.slstm(B, T, H, Dh, wx["z"].element_size(),
                                      r["z"].element_size()).bound()
        ms = time_cuda(lambda: xlstm_mod.slstm_scan_cuda(wx, r, state), reps)
        rec.update(ms=ms, bound_ms=bound, bound_by=by,
                   us_per_step=ms * 1e3 / T)
    if not ok:
        raise AssertionError(f"B8 != plain: {rec}")
    return rec


#: Cluster sizes the exchange probe and B8 are tried at (16 needs the
#: non-portable cluster attribute and may not launch).
PROBE_CLUSTERS = (2, 4, 6, 8, 16)
#: The probe's variants by launch index: 0-2 B8's all-gather of h, 3-7
#: B8-bwd's reduce-scatter of dh_rec (4-7 need <= 32 units a block; 4-5
#: split the first design's step, 6-7 this design's).
PROBE_VARIANTS = ("dsmem_cluster_sync", "st_async_mbarrier",
                  "st_async_mbarrier_cell", "bwd_reduce_scatter",
                  "bwd_dot4x32", "bwd_dot4x32_cell", "bwd_dot_quad",
                  "bwd_dot_quad_linear")
PROBE_DESCRIPTIONS = (
    "plain DSMEM stores + cluster barrier (B8's first design)",
    "st.async into each rank + own mbarrier parity wait",
    "the same + the sLSTM cell update on each unit's thread",
    "B8-bwd's reduce-scatter: each row's st.async into the owner's slot, "
    "the owner's mbarrier wait, the CL-slot sum, one block barrier",
    "the same + B8-bwd's first dot (thread = row, 32 units x 4 gates of R "
    "in registers, four chains 32 deep) on the chain",
    "bwd_dot4x32 + B8-bwd's first cell (precise expf / log1pf / tanhf, "
    "divisions, from a record that changes every step) after the slot "
    "sum, on the chain",
    "the reduce-scatter + B8-bwd's dot of quads (4 rows x 8 units x 4 gates "
    "a thread, the quad's sums reduce-scattered by shuffles)",
    "bwd_dot_quad + the linear update alone after the slot sum: B8-bwd's "
    "chain")


def slstm_exchange_probe(quick):
    """`models/csrc/slstm_probe.cu` at B8's main grid shape (xlstm-125m: 4
    heads of Dh 192, one cluster each) over T empty steps: µs per step of
    each exchange variant at each cluster size, in turns (each size's
    variants back to back, twice). The least of B8's one-way all-gathers
    is B8's latency floor per step (`floor_us_per_step`), the least of
    the reduce-scatters alone B8-bwd's (`bwd_floor_us_per_step`); at
    B8-bwd's cluster (`slstm_cluster(Dh)`) the step split into the
    exchange, each dot and each cell on the chain (`bwd_split_us`)."""
    import ctypes
    fn = build.load("slstm_probe").slstm_probe_launch
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    xl = get_config("xlstm-125m")
    Dh, BH = xl.d_model // xl.n_heads, xl.n_heads
    T = 4096 if quick else 32768
    out = torch.empty(BH, Dh, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    us = {v: {} for v in PROBE_VARIANTS}
    errors = {}
    for cl in PROBE_CLUSTERS:
        units = -(-Dh // cl)
        for rep in range(2):
            for vi, v in enumerate(PROBE_VARIANTS):
                if vi >= 4 and units > xlstm_mod.SLSTM_MAX_UNITS:
                    continue
                err = fn(vi, cl, BH, Dh, 64, out.data_ptr(), stream)
                if err:
                    errors[f"{v}@{cl}"] = err
                    continue
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                err = fn(vi, cl, BH, Dh, T, out.data_ptr(), stream)
                t1.record()
                torch.cuda.synchronize()
                assert err == 0 and torch.isfinite(out).all(), (v, cl, err)
                step = t0.elapsed_time(t1) * 1e3 / T
                us[v][cl] = min(us[v].get(cl, step), step)
    exchange = [(t, v, cl) for v in PROBE_VARIANTS[:2]
                for cl, t in us[v].items()]
    floor, floor_variant, floor_cluster = min(exchange)
    bwd = us["bwd_reduce_scatter"]
    bwd_floor, bwd_cluster = min((t, cl) for cl, t in bwd.items())
    kc = xlstm_mod.slstm_cluster(Dh)
    split = None
    if all(kc in us[v] for v in PROBE_VARIANTS[3:]):
        x, d4, c4, q, ql = (us[v][kc] for v in PROBE_VARIANTS[3:])
        split = {"cluster": kc, "exchange": x, "dot4x32": d4 - x,
                 "dot_quad": q - x,
                 "cell_precise": c4 - d4, "linear_update": ql - q,
                 "first_design_without_memory": c4,
                 "this_design_without_memory": ql}
    return {"T": T, "B_H": BH, "Dh": Dh, "us_per_step": us,
            "launch_errors": errors, "floor_us_per_step": floor,
            "floor_variant": floor_variant, "floor_cluster": floor_cluster,
            "bwd_floor_us_per_step": bwd_floor,
            "bwd_floor_cluster": bwd_cluster, "bwd_split_us": split,
            "variants": dict(zip(PROBE_VARIANTS, PROBE_DESCRIPTIONS))}


def recurrent_checks(quick, built):
    """B6, B7 and B8 against their plain versions on the card, each at
    the main path's shape (recurrentgemma-9b's and xlstm-125m's prefill of
    one 32,768-token sequence; --quick 4,096), timed there, and at ragged
    edges: B6 at T = 1,000 (not a multiple of its tile) with an incoming
    h, f32 and bf16, bf16 x with an f32 Lambda, D = 1,003 (no 16-byte
    rows), and the long-memory recipe (a ~ 0.998) at the main shape
    (timed) and at B 4 x T 1,000 with h0 in f32; B7 with chunk 40 (not
    its 64-row tile) and
    a carried state, the ragged T = 200 = 5 chunks of 40, D 16 at chunk
    16, B 2 at 3 chunks, and the extreme gates that switch M_c between the
    carried m and G_c (and, at their ill-conditioned first recipe and 16
    seeds, the kernel and the f32 plain version against an f64 plain
    result: `mlstm_f64_witness`); B8 at T = 37 with a state, at Dh = 20
    (not a multiple of its cluster ranks), at T = 1 (decode) in bf16, at
    the largest head size the wrapper takes (256) and at B 64 x 4 heads
    (more clusters than the SMs hold at once). B7's pass kernels'
    registers and spills (`-Xptxas -v` of this run's build) and HGMMA
    instructions by kernel (`cuobjdump -sass`): passes 1 and 3 run on
    wgmma, so each has some where cuobjdump is found."""
    T = 4096 if quick else 32768
    reps = 3 if quick else 5
    rg = get_config("recurrentgemma-9b")
    xl = get_config("xlstm-125m")
    d = rg.d_model
    b6 = [rglru_check("main", 1, T, d, torch.bfloat16, 21, reps=reps),
          rglru_check("ragged_f32", 2, 1000, d, torch.float32, 22,
                      with_h0=True),
          rglru_check("ragged_bf16", 2, 1000, d, torch.bfloat16, 23,
                      with_h0=True),
          rglru_check("long_memory_main", 1, T, d, torch.bfloat16, 35,
                      reps=reps, wa_shift=-8.0),
          rglru_check("long_memory_b4_f32_h0", 4, 1000, d, torch.float32,
                      36, with_h0=True, wa_shift=-8.0),
          rglru_check("bf16_x_f32_lam", 2, 1000, d, torch.bfloat16, 37,
                      with_h0=True, lam_dtype=torch.float32),
          rglru_check("d1003_f32", 3, 77, 1003, torch.float32, 38,
                      with_h0=True, wa_shift=-8.0)]
    H, D = xl.n_heads, xl.head_dim
    b7 = [mlstm_check("main", 1, H, T, D, 64, 24, reps=reps),
          mlstm_check("chunk40_state", 2, H, 200, D, 40, 25,
                      with_state=True),
          mlstm_check("d16_chunk16", 2, 3, 48, 16, 16, 26, with_state=True),
          mlstm_check("b2_3chunks", 2, H, 192, D, 64, 31, with_state=True),
          mlstm_check("extreme_gates", 2, H, 1024, D, 64, 32,
                      with_state=True, extreme=64)]
    witness = [mlstm_f64_witness(f"extreme_gates_spike15_seed{seed}", 2, H,
                                 1024, D, 64, seed)
               for seed in range(32, 48)]
    b7_ptxas = ptxas_facts(
        built["logs"].get("mlstm_chunk", ""), "mlstm_",
        r"(chunk_states|state_scan|chunk_outputs)_kernel"
        r"(?:ILi(\d+)E(?:Lb([01])E)?|E)") \
        or "not measured (library not rebuilt)"
    hgmma, where = sass_count("mlstm_chunk", "HGMMA",
                              by=r"mlstm_(chunk_states|state_scan|"
                                 r"chunk_outputs)_kernel")
    if hgmma != "not measured":
        assert hgmma.get("chunk_states", 0) > 0 \
            and hgmma.get("chunk_outputs", 0) > 0, hgmma
    b7[0].update(ptxas=b7_ptxas, hgmma=hgmma if hgmma != "not measured"
                 else f"not measured ({where})")
    Dh = xl.d_model // xl.n_heads
    b8 = [slstm_check("main", 1, T, H, Dh, torch.bfloat16, 27, reps=reps),
          slstm_check("ragged_f32_state", 2, 37, H, Dh, torch.float32, 28,
                      with_state=True),
          slstm_check("dh20", 2, 16, 3, 20, torch.float32, 29,
                      with_state=True),
          slstm_check("dh256", 1, 64, 2, xlstm_mod.SLSTM_MAX_HEAD_DIM,
                      torch.float32, 33, with_state=True),
          slstm_check("b64_h4", 64, 32, H, Dh, torch.bfloat16, 34,
                      with_state=True),
          slstm_check("decode_bf16", 4, 1, H, Dh, torch.bfloat16, 30,
                      with_state=True, reps=20)]
    return {"rglru_scan": b6,
            "rglru_in_context": rglru_in_context(1, T, d, 21,
                                                 100 if quick else 400),
            "mlstm_chunk": b7, "mlstm_f64_witness": witness, "slstm": b8}


# ---------------------------------------------------------------------------
# The recurrent backwards (B7-bwd, B8-bwd) vs their plain versions.
# ---------------------------------------------------------------------------

#: Kernel vs plain backward for B7-bwd and B8-bwd (stated before their
#: first card run): both sides compute in f32 from the same forward
#: record, the kernels summing in other orders (B7-bwd's products — on the
#: FMA units then, since on the tensor cores from three bf16 pieces an
#: operand — and float atomics, B8-bwd's split partial sums), so each gradient
#: tensor may differ by 1e-3 of the largest |plain value| of that tensor;
#: a bf16 output by one bf16 ulp of the value more.
BWD_REC_TOL = 1e-3
#: The kernels' names in -Xptxas -v output and in a profiler trace.
B7_BWD_PASSES = ("mlstm_bwd_outputs", "mlstm_bwd_scan", "mlstm_bwd_inputs")


def mlstm_bwd_bounds(B, H, T, D, L):
    """{"whole" and each pass: (ms, what binds, fma_ms)} of B7-bwd
    (`kernels.work.mlstm_bwd`: the products at the TF32 peak, the other
    f32 operations on the FMA units); `fma_ms` with every operation on
    the FMA units, as the first design counted it."""
    return {key: (*w.bound(), w.at("f32").bound()[0])
            for key, w in kernel_work.mlstm_bwd(B, H, T, D, L).items()}


def mlstm_bwd_check(name, B, H, T, D, chunk, seed, with_state=False,
                    extreme=0, reps=0):
    """B7-bwd on the card: the whole (three pass kernels) against
    `mlstm_chunk_scan_bwd_plain`, and each pass kernel against its plain
    version fed by the plain versions of the passes before it, from one
    forward of the kernels (with each row's dot). `with_state`: a random
    carried state and random final-state gradients (the gauge term).
    Counts the rows on each branch of the denominator. The forward's
    outputs pass asked for the rows' normalisers (the launch training
    makes) is first held against `mlstm_chunk_outputs_plain(...,
    with_dot=True)` on the same inputs: its h and dot within `REC_TOL`.
    With `reps`, the whole and each pass timed, and the plain whole on
    the host clock."""
    q, k, v, it, ft, state = mlstm_inputs(B, H, T, D, seed, with_state,
                                          extreme)
    g = torch.Generator(device=DEV).manual_seed(seed + 1000)
    work, scal = xlstm_mod.mlstm_chunk_states_cuda(k, v, it, ft, chunk)
    s1 = xlstm_mod.mlstm_state_scan_cuda(work, scal, state)
    h, dot = xlstm_mod.mlstm_chunk_outputs_cuda(q, k, v, it, ft, work, scal,
                                                chunk, with_dot=True)
    torch.cuda.synchronize()
    fwd_err, fwd_ok = rec_errs([h, dot], xlstm_mod.mlstm_chunk_outputs_plain(
        q, k, v, it, ft, work, scal, chunk, with_dot=True))
    dh = torch.randn(B, T, H * D, device=DEV, generator=g)
    fin = (None, None, None)
    if with_state:
        fin = (torch.randn(B, H, D, D, device=DEV, generator=g),
               torch.randn(B, H, D, device=DEV, generator=g),
               torch.randn(B, H, device=DEV, generator=g))
    args = (q, k, v, it, ft, h, dot, work, scal, s1["C"], s1["n"], dh, *fin,
            chunk)
    got = xlstm_mod.mlstm_chunk_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    plain_ms, ref = time_host(
        lambda: xlstm_mod.mlstm_chunk_scan_bwd_plain(*args))
    err, ok = rec_errs(got, ref, BWD_REC_TOL)
    *_, on_dot = xlstm_mod._bwd_rows(dot, it, ft, scal, chunk)
    gauge = xlstm_mod.mlstm_gauge(*fin, s1["C"], s1["n"])
    passes = {}
    ms1, (wp, sp) = time_host(lambda: xlstm_mod.mlstm_bwd_outputs_plain(
        q, dh, h, dot, it, ft, work, scal, chunk))
    wk, sk = xlstm_mod.mlstm_bwd_outputs_cuda(q, dh, h, dot, it, ft, work,
                                              scal, chunk)
    passes["mlstm_bwd_outputs"] = (ms1, *rec_errs(
        [wk, sk[..., 0]], [wp, sp[..., 0]], BWD_REC_TOL))
    wk, sk = wp.clone(), sp.clone()
    ms2, cp = time_host(lambda: xlstm_mod.mlstm_bwd_scan_plain(
        wp, sp, work, scal, fin[0], fin[1], gauge))
    ck = xlstm_mod.mlstm_bwd_scan_cuda(wk, sk, work, scal, fin[0], fin[1],
                                       gauge)
    passes["mlstm_bwd_scan"] = (ms2, *rec_errs(
        [wk, sk[..., 1], sk[..., 2], *ck], [wp, sp[..., 1], sp[..., 2], *cp],
        BWD_REC_TOL))
    ms3, ip = time_host(lambda: xlstm_mod.mlstm_bwd_inputs_plain(
        q, k, v, it, ft, dh, h, dot, work, scal, wp, sp, fin[2], chunk))
    ik = xlstm_mod.mlstm_bwd_inputs_cuda(q, k, v, it, ft, dh, h, dot, work,
                                         scal, wp, sp, fin[2], chunk)
    passes["mlstm_bwd_inputs"] = (ms3, *rec_errs(ik, ip, BWD_REC_TOL))
    rec = {"shape": name, "B": B, "H": H, "T": T, "D": D, "chunk": chunk,
           "state_in": with_state, "extreme_gates": bool(extreme),
           "rows_on_dot_branch": int(on_dot.sum()),
           "rows_on_floor_branch": int((~on_dot).sum()),
           "forward_with_dot": {"max_abs_err": fwd_err,
                                "within_tolerance": fwd_ok},
           "max_abs_err": err, "within_tolerance": ok, "plain_ms": plain_ms,
           "scratch_bytes": xlstm_mod.mlstm_work_bytes(B, H, T, D, chunk),
           "passes": {key: {"plain_ms": p[0], "max_abs_err": p[1],
                            "within_tolerance": p[2]}
                      for key, p in passes.items()}}
    if reps:
        bounds = mlstm_bwd_bounds(B, H, T, D, chunk)
        rec.update(ms=time_cuda(
            lambda: xlstm_mod.mlstm_chunk_scan_bwd_cuda(*args), reps),
            bound_ms=bounds["whole"][0], bound_by=bounds["whole"][1],
            fma_bound_ms=bounds["whole"][2],
            forward_ms=time_cuda(lambda: xlstm_mod.mlstm_chunk_scan_cuda(
                q, k, v, it, ft, state, chunk), reps))
        wt, st_ = wp.clone(), sp.clone()
        for key, fn in (
                ("mlstm_bwd_outputs",
                 lambda: xlstm_mod.mlstm_bwd_outputs_cuda(
                     q, dh, h, dot, it, ft, work, scal, chunk)),
                ("mlstm_bwd_scan",
                 lambda: xlstm_mod.mlstm_bwd_scan_cuda(
                     wt, st_, work, scal, None, None, None)),
                ("mlstm_bwd_inputs",
                 lambda: xlstm_mod.mlstm_bwd_inputs_cuda(
                     q, k, v, it, ft, dh, h, dot, work, scal, wp, sp, None,
                     chunk))):
            rec["passes"][key].update(ms=time_cuda(fn, reps),
                                      bound_ms=bounds[key][0],
                                      bound_by=bounds[key][1],
                                      fma_bound_ms=bounds[key][2])
    if not (fwd_ok and ok and all(p[2] for p in passes.values())):
        raise AssertionError(f"B7-bwd != plain: {rec}")
    if extreme and not (rec["rows_on_dot_branch"]
                        and rec["rows_on_floor_branch"]):
        raise AssertionError(f"B7-bwd: one denominator branch unused: {rec}")
    return rec


def slstm_bwd_check(name, B, T, H, Dh, dtype, seed, with_state=False,
                    reps=0, floor_us=None, flip=0.0):
    """B8-bwd against `slstm_scan_bwd_plain` on the record of one forward
    of the kernel; `with_state`: a random initial state and random
    final-state gradients. The forward asked for its record (the launch
    training makes) is first held against `slstm_scan_plain(...,
    with_saved=True)` on the same inputs: h, the final state and each of
    the record's rows within `REC_TOL`. `flip`: wx_i gets a square wave
    of that height and a period of 32 steps, so that the step's max
    flips between its branches within the run (asserted: both branches
    taken, flips counted). With `reps` timed: the call (kernel and dR's
    product), the kernel alone (`slstm_bwd_cells_cuda`) and dR's product
    alone; µs a step beside the backward's exchange floor `floor_us`."""
    wx, r, state = slstm_inputs(B, T, H, Dh, dtype, seed, with_state)
    if flip:
        wave = torch.where(torch.arange(T, device=DEV) % 32 < 16, flip,
                           -flip)
        wx["i"] = (wx["i"].float() + wave[None, :, None]).to(dtype)
    g = torch.Generator(device=DEV).manual_seed(seed + 1000)
    h, st, saved = xlstm_mod.slstm_scan_cuda(wx, r, state, with_saved=True)
    torch.cuda.synchronize()
    hp, stp, savedp = xlstm_mod.slstm_scan_plain(wx, r, state,
                                                 with_saved=True)
    keys = ("h", "c", "n", "m")
    fwd_err, fwd_ok = rec_errs(
        [h, *(st[k_] for k_ in keys), *saved.unbind(2)],
        [hp, *(stp[k_] for k_ in keys), *savedp.unbind(2)])
    dh = torch.randn(B, T, H * Dh, device=DEV, generator=g)
    fin = [None] * 4
    if with_state:
        fin = [torch.randn(B, H, Dh, device=DEV, generator=g)
               for _ in range(4)]
    rs = [r[gn] for gn in "zifo"]
    args = (rs, state["h"], state["c"], state["n"], state["m"], h, saved,
            dh, *fin)
    got = xlstm_mod.slstm_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    plain_ms, ref = time_host(lambda: xlstm_mod.slstm_scan_bwd_plain(*args))

    def flat(out):
        delta, dR, *rest = out
        return [delta, *dR, *rest]
    err, ok = rec_errs(flat(got), flat(ref), BWD_REC_TOL)
    wins = xlstm_mod.slstm_lsf_wins(savedp, state["m"])
    rec = {"shape": name, "B": B, "T": T, "H": H, "Dh": Dh,
           "dtype": str(dtype).split(".")[-1], "state_in": with_state,
           "cluster": xlstm_mod.slstm_cluster(Dh),
           "forward_with_saved": {"max_abs_err": fwd_err,
                                  "within_tolerance": fwd_ok},
           "lsf_wins_share": float(wins.float().mean()),
           "branch_flips": int((wins[:, 1:] != wins[:, :-1]).sum()),
           "max_abs_err": err, "within_tolerance": ok, "plain_ms": plain_ms}
    if flip and not (0.0 < rec["lsf_wins_share"] < 1.0
                     and rec["branch_flips"] > 0):
        raise AssertionError(f"B8-bwd {name}: the max never flipped: {rec}")
    if reps:
        bound, by = kernel_work.slstm_bwd(
            B, T, H, Dh, r["z"].element_size(), xlstm_mod.SLSTM_SAVED,
            True).bound()
        # The kernel alone: dR's 8 Dh, h and dR's bytes left out.
        kernel_bound, _ = kernel_work.slstm_bwd(
            B, T, H, Dh, r["z"].element_size(), xlstm_mod.SLSTM_SAVED,
            False).bound()
        ms = time_cuda(lambda: xlstm_mod.slstm_scan_bwd_cuda(*args), reps)
        kernel_ms = time_cuda(lambda: xlstm_mod.slstm_bwd_cells_cuda(
            *args[:1], *args[2:]), reps)
        dr_ms = time_cuda(lambda: xlstm_mod.slstm_bwd_dr(
            state["h"], h, got[0]), reps)
        rec.update(ms=ms, bound_ms=bound, bound_by=by,
                   us_per_step=ms * 1e3 / T, kernel_ms=kernel_ms,
                   kernel_us_per_step=kernel_ms * 1e3 / T,
                   kernel_bound_ms=kernel_bound, dr_ms=dr_ms,
                   max_active_clusters=xlstm_mod.slstm_bwd_max_clusters(Dh),
                   clusters=B * H,
                   forward_saved_ms=time_cuda(
                       lambda: xlstm_mod.slstm_scan_cuda(
                           wx, r, state, with_saved=True), reps),
                   forward_ms=time_cuda(
                       lambda: xlstm_mod.slstm_scan_cuda(wx, r, state), reps))
        if floor_us is not None:
            rec.update(exchange_floor_us_per_step=floor_us,
                       us_per_step_over_floor=rec["us_per_step"] / floor_us,
                       kernel_us_per_step_over_floor=rec[
                           "kernel_us_per_step"] / floor_us)
    if not (fwd_ok and ok):
        raise AssertionError(f"B8-bwd != plain: {rec}")
    return rec


#: MUFU operations per (b, t, d) of B6-bwd: the forward's six, then two
#: sigmoids (an exponential and a reciprocal each), a square root and a
#: reciprocal again in the chain.
RGLRU_BWD_SFU_PER_ELEM = 12


def rglru_saved_h(saved, B, T, D):
    """The inclusive h of every tile in the scratch of B6's launch,
    (n t-tiles, B, D) f32: per tile an aggregate (2 f32) and an inclusive
    h (1 f32) per slot, slot j * 32 + lane holding channel lane * V + j of
    the tile (`csrc/rglru_scan.cu`)."""
    L, C = rglru_mod.KERNEL_CHUNK, rglru_mod.KERNEL_CHANNELS
    nT, nDC = -(-T // L), -(-D // C)
    n = nT * B * nDC * C
    inc = saved[8 * n:12 * n].view(torch.float32)
    return inc.view(nT, B, nDC, C // 32, 32).transpose(3, 4).reshape(
        nT, B, nDC * C)[:, :, :D]


def rglru_bwd_check(name, B, T, D, dtype, seed, with_h0=False, reps=0,
                    lam_dtype=None, wa_shift=0.0, a_one=False):
    """B6-bwd against `rglru_scan_bwd_plain` on `rglru_inputs` with random
    dy and dh_last; `a_one`: wa = -40 everywhere (r ~ 4e-18, a = 1 in f32,
    where the clamp passes the square root's gradient nothing). First the
    forward's training launch (the same kernel, its scratch kept) against
    `rglru_scan_plain`: y, h_last and each tile's inclusive h (what B6-bwd
    reads) against the plain f32 h at the tile's last step, within
    `REC_TOL`. The backward's dlam of a second call on the same inputs is
    compared with the first (its f32 atomics land in varying order;
    reported, not gated). With `reps` timed, beside the serving launch,
    the bound and the SFU floor."""
    wa, wx, x, lam, h0 = rglru_inputs(B, T, D, dtype, seed, with_h0,
                                      lam_dtype, wa_shift)
    if a_one:
        wa = torch.full_like(wa, -40.0)
    g = torch.Generator(device=DEV).manual_seed(seed + 1000)
    dy = torch.randn(B, T, D, device=DEV, generator=g).to(dtype)
    dhl = torch.randn(B, D, device=DEV, generator=g)
    y, hl, saved = rglru_mod._forward_cuda(wa, wx, x, lam, h0)
    torch.cuda.synchronize()
    yp, hlp = rglru_mod.rglru_scan_plain(wa, wx, x, lam, h0)
    hs = rglru_mod._h_sequence(*rglru_mod._gate_values(wa, wx, x, lam), h0)
    ends = [min(t + rglru_mod.KERNEL_CHUNK, T) - 1
            for t in range(0, T, rglru_mod.KERNEL_CHUNK)]
    fwd_err, fwd_ok = rec_errs(
        [y, hl, rglru_saved_h(saved, B, T, D)],
        [yp, hlp, hs[:, ends].transpose(0, 1)])
    del hs
    args = (wa, wx, x, lam, h0, saved, dy, dhl)
    got = rglru_mod.rglru_scan_bwd_cuda(*args)
    dlam_again = rglru_mod.rglru_scan_bwd_cuda(*args)[3]
    torch.cuda.synchronize()
    dlam_rep = float((dlam_again.float() - got[3].float()).abs().max())
    plain_ms, ref = time_host(lambda: rglru_mod.rglru_scan_bwd_plain(
        wa, wx, x, lam, h0, dy, dhl))
    names = ("dwa", "dwx", "dx", "dlam", "dh0")
    errs = {n_: rec_err(a, b) for n_, a, b in zip(names, got, ref)
            if b is not None}
    ok = all(e[1] for e in errs.values())
    rec = {"shape": name, "B": B, "T": T, "D": D,
           "dtype": str(dtype).split(".")[-1],
           "lam_dtype": str(lam.dtype).split(".")[-1], "h0": with_h0,
           "wa_shift": wa_shift, "a_one": a_one,
           "forward_with_saved": {"max_abs_err": fwd_err,
                                  "within_tolerance": fwd_ok},
           "errs": {n_: e[0] for n_, e in errs.items()},
           "max_abs_err": max(e[0] for e in errs.values()),
           "dlam_repeat_max_abs": dlam_rep,
           "within_tolerance": fwd_ok and ok, "plain_ms": plain_ms}
    if reps:
        n = B * T * D
        w = kernel_work.rglru_bwd(B, T, D, x.element_size(),
                                  lam.element_size(), with_h0,
                                  rglru_mod.KERNEL_CHUNK,
                                  rglru_mod.KERNEL_CHANNELS)
        bound, by = w.bound()
        nbytes = w.nbytes
        sfu_ms, _ = sfu_floor_ms(n * RGLRU_BWD_SFU_PER_ELEM)
        rec.update(
            ms=time_cuda(lambda: rglru_mod.rglru_scan_bwd_cuda(*args), reps),
            bound_ms=bound, bound_by=by, bound_bytes=nbytes,
            sfu_floor_ms=sfu_ms,
            forward_ms=time_cuda(
                lambda: rglru_mod.rglru_scan_cuda(wa, wx, x, lam, h0), reps))
    if not rec["within_tolerance"]:
        raise AssertionError(f"B6-bwd != plain: {rec}")
    return rec


def recurrent_bwd_checks(quick, built, floor_us):
    """B6-bwd, B7-bwd and B8-bwd against their plain backwards on the card.
    B6-bwd at recurrentgemma-9b's training microbatch (2 x 4,096 x 4,096
    bf16; --quick T 1,024), timed there, f32 with an h0, ragged T
    (1,000), D 1,003, the long-memory recipe and a = 1 exactly. B7-bwd and
    B8-bwd at xlstm-125m's training shape (B 4 x H 4 x T 4,096, D 192, chunk 64;
    sLSTM bf16 wx and R; --quick T 1,024), timed there, and at ragged
    edges: B7-bwd at chunk 40 with a carried state (T = 200, five chunks
    of 40), D 16 at chunk 16, and the extreme gates of `mlstm_check` (both
    denominator branches counted); B8-bwd at T 37 in f32 with a state, at
    Dh 20, at Dh 256 and at Dh 192 with the step's max flipping between
    its branches. With each kernel's registers and spills (B8-bwd's also
    beside its µs a step and the backward's exchange floor `floor_us`)."""
    xl = get_config("xlstm-125m")
    H, D = xl.n_heads, xl.head_dim
    T = 1024 if quick else TRAIN_T
    B = TRAIN_B // TRAIN_NM
    reps = 3 if quick else 5
    b7 = [mlstm_bwd_check("train", B, H, T, D, 64, 41, reps=reps),
          mlstm_bwd_check("chunk40_state", 2, H, 200, D, 40, 42,
                          with_state=True),
          mlstm_bwd_check("d16_chunk16", 2, 3, 48, 16, 16, 43,
                          with_state=True),
          mlstm_bwd_check("extreme_gates", 2, H, 1024, D, 64, 44,
                          with_state=True, extreme=64)]
    Dh = xl.d_model // xl.n_heads
    b8 = [slstm_bwd_check("train", B, T, H, Dh, torch.bfloat16, 45,
                          reps=reps, floor_us=floor_us),
          slstm_bwd_check("ragged_f32_state", 2, 37, H, Dh, torch.float32,
                          46, with_state=True),
          slstm_bwd_check("dh20", 2, 16, 3, 20, torch.float32, 47,
                          with_state=True),
          slstm_bwd_check("dh256", 1, 64, 2, xlstm_mod.SLSTM_MAX_HEAD_DIM,
                          torch.float32, 48, with_state=True),
          slstm_bwd_check("max_flip", 2, 256, H, Dh, torch.float32, 49,
                          with_state=True, flip=4.0)]
    rg = get_config("recurrentgemma-9b")
    b6 = [rglru_bwd_check("train", RG_TRAIN_B // RG_TRAIN_NM, T, rg.d_model,
                          torch.bfloat16, 51, reps=reps),
          rglru_bwd_check("f32_h0", 2, 1024, 512, torch.float32, 52,
                          with_h0=True),
          rglru_bwd_check("ragged_t1000", 1, 1000, 256, torch.bfloat16, 53,
                          with_h0=True, lam_dtype=torch.float32),
          rglru_bwd_check("d1003", 2, 200, 1003, torch.float32, 54,
                          with_h0=True, lam_dtype=torch.bfloat16),
          rglru_bwd_check("long_memory", 1, 2048, 1024, torch.bfloat16, 55,
                          wa_shift=-8.0),
          rglru_bwd_check("a_one", 2, 300, 256, torch.float32, 56,
                          with_h0=True, a_one=True)]
    logs = built["logs"]
    ptxas = {
        "rglru_scan_bwd": ptxas_facts(logs.get("rglru_scan_bwd", ""),
                                      "rglru_scan_bwd_kernel",
                                      r"I(f|13__nv_bfloat16)(f|13__nv_bfl"
                                      r"oat16)Lb([01])E"),
        "mlstm_chunk_bwd": ptxas_facts(
            logs.get("mlstm_chunk_bwd", ""), "mlstm_bwd_",
            r"(outputs|scan|inputs)_kernel(?:ILi(\d+)E|E)"),
        "slstm_bwd": ptxas_facts(logs.get("slstm_bwd", ""),
                                 "slstm_bwd_kernel",
                                 r"I(f|13__nv_bfloat16)Lb([01])E")}
    b8[0]["ptxas"] = ptxas["slstm_bwd"] or "not measured (library not " \
        "rebuilt)"
    return {"rglru_scan_bwd": b6, "mlstm_chunk_bwd": b7, "slstm_bwd": b8,
            "ptxas": {k_: v_ or "not measured (library not rebuilt)"
                      for k_, v_ in ptxas.items()}}


# ---------------------------------------------------------------------------
# Training: xlstm-125m whole, through make_train_step (B7, B8 and their
# backwards).
# ---------------------------------------------------------------------------

XL_TRAIN_ARCH = "xlstm-125m"
#: Labels of the xlstm train step's trace: B7 and B7-bwd by pass, B8 and
#: B8-bwd, then the library's kernels as in `TRAIN_KERNELS`.
XL_TRAIN_KERNELS = {
    **{key: f"{key}_kernel" for key in (
        "mlstm_chunk_states", "mlstm_state_scan", "mlstm_chunk_outputs",
        *B7_BWD_PASSES, "slstm", "slstm_bwd")},
    **{k_: v_ for k_, v_ in TRAIN_KERNELS.items()
       if not k_.startswith("flash")}}
#: The kernels one layer of each recurrent kind launches forward and
#: backward.
XL_KERNELS = {"mlstm": (("mlstm_chunk_states", "mlstm_state_scan",
                         "mlstm_chunk_outputs"), B7_BWD_PASSES),
              "slstm": (("slstm",), ("slstm_bwd",))}
#: Card gradient check of xlstm-125m (stated before its first card run):
#: f32 compute on both sides, the card's kernels against the CPU's plain
#: versions and plain backwards: the loss within 1e-4 relative, each
#: leaf's gradient within relative L2 1e-3.
XL_GRAD_LOSS_TOL = 1e-4
XL_GRAD_LEAF_TOL = 1e-3


def xlstm_grad_check(cfg, seed):
    """xlstm-125m at full width cut to 4 layers, 2 x 512 tokens, f32 params
    and compute (TF32 off): the loss and every leaf's gradient on the card
    (B7, B8 and their backwards) against the same params and batch on the
    CPU (the plain versions and plain backwards); then one compressed
    (int8 error-feedback) step at the trivial pod mesh."""
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    rec, params, batch = card_vs_cpu_grads(
        cfg4, seed, 2, 512, XL_GRAD_LOSS_TOL, XL_GRAD_LEAF_TOL,
        [key for fwd, bwd in XL_KERNELS.values() for key in (*fwd, *bwd)])
    rec["compressed_step"] = compressed_step(
        cfg4, params, batch, ("slstm_bwd", "mlstm_bwd_inputs"),
        ("plain_slstm_bwd", "plain_mlstm_bwd_inputs"))
    return rec


def lm_train_xlstm_phase(args, paths):
    """xlstm-125m whole (12 layers: 6 mLSTM, 6 sLSTM, full width), f32
    params and AdamW moments, bf16 compute, B 8 x T 4,096 in two
    microbatches, three `make_train_step` steps on one batch through
    `train_run`: the B7, B7-bwd, B8 and B8-bwd launches the remat scheme
    implies and no plain version. Then the card gradient check
    (`xlstm_grad_check`)."""
    cfg = get_config(XL_TRAIN_ARCH)
    B, T, nm = (2, 1024, 2) if args.quick else (TRAIN_B, TRAIN_T, TRAIN_NM)
    want = {}
    for kind, (fwd, bwd) in XL_KERNELS.items():
        want.update(launches_per_step(cfg, nm, (kind,), fwd, bwd))
    rec, state = train_run(args, paths, cfg, "lm_train_xlstm", B, T, nm, 13,
                           XL_TRAIN_KERNELS, want, count_step=True)
    del state
    torch.cuda.empty_cache()
    emit("lm_progress", {"lm_train_xlstm": {k_: v_ for k_, v_ in rec.items()
                                            if k_ != "trace"}})
    rec["grad_check"] = xlstm_grad_check(cfg, args.seed)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Training: recurrentgemma-9b at full width cut to 6 layers (B6 and B6-bwd,
# B5 and B5-bwd at D 256), and stablelm-3b whole (B5's wgmma forward and
# B5-bwd at D 80).
# ---------------------------------------------------------------------------

RG_TRAIN_ARCH = "recurrentgemma-9b"
#: Two periods of (rglru, rglru, local): 6 layers of 38, full width.
RG_TRAIN_LAYERS = 6
RG_TRAIN_B, RG_TRAIN_T, RG_TRAIN_NM = 4, 4096, 2
#: Labels of the recurrentgemma train step's trace.
#: (B5-bwd at D 256 runs its split kernel.)
RG_TRAIN_KERNELS = {"rglru_scan": "rglru_scan_kernel",
                    "rglru_scan_bwd": "rglru_scan_bwd_kernel",
                    "flash_tc_bwd_wgmma_split":
                        "flash_bwd_wgmma_split_kernel",
                    **TRAIN_KERNELS}
#: The kernels one layer of each kind launches forward and backward.
RG_KERNELS = {"rglru": (("rglru_scan",), ("rglru_scan_bwd",)),
              "local": (("flash_tc",), ("flash_tc_bwd",))}
#: Card gradient check of recurrentgemma-9b (stated before its first card
#: run): f32 compute on both sides, the card's kernels (B6 and B6-bwd; B5's
#: split-TF32 route and its backward at D 256) against the CPU's plain
#: versions and plain backwards: the loss within 1e-4 relative, each
#: leaf's gradient within relative L2 1e-3 (the xlstm check's bounds).
RG_GRAD_LOSS_TOL = 1e-4
RG_GRAD_LEAF_TOL = 1e-3

SL_TRAIN_ARCH = "stablelm-3b"
SL_TRAIN_B, SL_TRAIN_T, SL_TRAIN_NM = 4, 2048, 2
#: Labels of the stablelm train step's trace: B5 (`flash_tc.cu` at D 80)
#: and B5-bwd behind it, as qwen3's.
SL_TRAIN_KERNELS = TRAIN_KERNELS
#: Card gradient check of stablelm-3b (stated before its first card run):
#: cut to 4 layers at full width, bf16 compute, 2 x 1,024 tokens, the loss
#: and every leaf's gradient on B5 (`flash_tc.cu`) and B5-bwd against
#: `attn_impl="naive"` within qwen3's bf16 bounds, `GRAD_LOSS_TOL` (2^-7
#: relative) and `GRAD_LEAF_TOL` (rel L2 2^-5).
SL_GRAD_LAYERS = 4


def card_vs_cpu_grads(cfg, seed, B, T, loss_tol, leaf_tol, kernels):
    """`cfg`'s loss and every leaf's gradient at f32 compute (TF32 off) on
    the card, against the same params and batch on the CPU (the plain
    versions and plain backwards); every kernel of `kernels` launched.
    Returns (the record, params, batch); raises beyond the tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = init_params(cfg, seed, torch.float32, device=DEV)
    toks = lm_tokens(cfg, B, T + 1, seed + 5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = counts()
    card_ms, (l_k, g_k) = time_host(lambda: train_mod.value_and_grad(
        params, cfg, batch, torch.float32))
    got = {key: val - before[key] for key, val in counts().items()}
    assert all(got[key] > 0 for key in kernels), got
    pc = tree_map(lambda t: t.detach().cpu(), params)
    t0 = time.perf_counter()
    l_c, g_c = train_mod.value_and_grad(
        pc, cfg, {key: val.cpu() for key, val in batch.items()},
        torch.float32)
    cpu_s = time.perf_counter() - t0
    loss_rel = float((l_k.cpu() - l_c).abs() / l_c.abs())
    leaf = {}
    for (_, a), (path, b) in zip(tree_leaves_with_path(g_k),
                                 tree_leaves_with_path(g_c)):
        leaf["/" + "/".join(path)] = float((a.cpu() - b).norm()
                                           / b.norm().clamp_min(1e-30))
    ok = loss_rel <= loss_tol and max(leaf.values()) <= leaf_tol
    rec = {"n_layers": cfg.n_layers, "batch": B, "tokens": T,
           "compute": "float32", "loss": float(l_k), "loss_cpu": float(l_c),
           "loss_rel_err": loss_rel, "leaf_rel_l2": leaf,
           "leaf_rel_l2_max": max(leaf.values()), "card_ms": card_ms,
           "cpu_seconds": cpu_s,
           "launches": {k_: v_ for k_, v_ in got.items() if v_},
           "tolerance": f"loss within {loss_tol} relative, each leaf's "
                        f"gradient rel L2 <= {leaf_tol} (f32 on both "
                        f"sides, TF32 off)",
           "within_tolerance": ok}
    if not ok:
        raise AssertionError(f"{cfg.name} card gradients != CPU: {rec}")
    return rec, params, batch


def lm_train_recurrentgemma_phase(args, paths):
    """recurrentgemma-9b at full width cut to 6 layers (two periods of
    (rglru, rglru, local)), f32 params and AdamW moments, bf16 compute, B
    4 x T 4,096 in two microbatches, three `make_train_step` steps on one
    batch through `train_run`: the B6, B6-bwd, B5 and B5-bwd (D 256, W
    2,048) launches the remat scheme implies and no plain version. Then
    a 3-layer cut (one period) at 1 x 512 tokens in f32, card against CPU
    (`card_vs_cpu_grads`)."""
    cfg = dataclasses.replace(get_config(RG_TRAIN_ARCH),
                              n_layers=RG_TRAIN_LAYERS)
    B, T, nm = (2, 1024, 2) if args.quick \
        else (RG_TRAIN_B, RG_TRAIN_T, RG_TRAIN_NM)
    want = {}
    for kind, (fwd, bwd) in RG_KERNELS.items():
        want.update(launches_per_step(cfg, nm, (kind,), fwd, bwd))
    rec, state = train_run(args, paths, cfg, "lm_train_recurrentgemma", B,
                           T, nm, 17, RG_TRAIN_KERNELS, want)
    del state
    torch.cuda.empty_cache()
    emit("lm_progress", {"lm_train_recurrentgemma": {
        k_: v_ for k_, v_ in rec.items() if k_ != "trace"}})
    rec["grad_check"] = card_vs_cpu_grads(
        dataclasses.replace(cfg, n_layers=3), args.seed, 1, 512,
        RG_GRAD_LOSS_TOL, RG_GRAD_LEAF_TOL,
        ("rglru_scan", "rglru_scan_bwd", "flash_tf32x3",
         "flash_tf32x3_bwd_mma_sync"))[0]
    torch.cuda.empty_cache()
    return rec


def lm_train_stablelm_phase(args, paths):
    """stablelm-3b whole (32 layers, D 80, MHA), f32 params and AdamW
    moments, bf16 compute, B 4 x T 2,048 in two microbatches, three
    `make_train_step` steps on one batch through `train_run`: attention on
    B5 (`flash_tc.cu`, bf16 at D 80, with its lse) and B5-bwd behind it,
    as many launches as the remat scheme implies, no split-TF32 kernel
    (forward or backward) and no plain version. Then the 4-layer cut's
    bf16 gradients against naive attention (`SL_GRAD_LAYERS`)."""
    cfg = get_config(SL_TRAIN_ARCH)
    B, T, nm = (2, 1024, 2) if args.quick \
        else (SL_TRAIN_B, SL_TRAIN_T, SL_TRAIN_NM)
    rec, state = train_run(args, paths, cfg, "lm_train_stablelm", B, T, nm,
                           19, SL_TRAIN_KERNELS, launches_per_step(
                               cfg, nm, ATTN_KINDS, ("flash_tc",),
                               ("flash_tc_bwd",)))
    got = rec["launches"]
    assert got["flash_tf32x3"] == 0 and got["flash_tf32x3_bwd"] == 0 \
        and got["flash_fma"] == 0, got
    del state
    torch.cuda.empty_cache()
    rec["grad_check"] = kernel_vs_naive_grads(
        dataclasses.replace(cfg, n_layers=SL_GRAD_LAYERS), args.seed,
        torch.bfloat16, ("flash_tc", "flash_tc_bwd"), GRAD_LOSS_TOL,
        GRAD_LEAF_TOL, absent=("flash_tf32x3", "flash_tf32x3_bwd"))[0]
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# The MoE and recurrent model families.
# ---------------------------------------------------------------------------

def model_prefill(cfg, params, T, seed, paths, name, kernels=None):
    """One T-token prefill (bf16, last-position logits) inside `paths`,
    then its device trace: tokens/s and busy share (and `kernels`' device
    ms, as `device_trace` takes them)."""
    toks = lm_tokens(cfg, 1, T, seed)
    prefill = make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    with paths.path(name):
        logits = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
    assert logits.shape == (1, 1, cfg.vocab_size), logits.shape
    assert bool(torch.isfinite(logits).all())
    trace = device_trace(lambda: prefill(params, {"tokens": toks}), kernels)
    wall_ms = trace.get("wall_ms") \
        or time_host(lambda: prefill(params, {"tokens": toks}))[0]
    return {"tokens": T, "seconds": wall_ms / 1e3,
            "tokens_per_s": T / (wall_ms / 1e3), "trace": trace,
            "launches": paths.paths[name],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def param_record(cfg, params):
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "n_layers_published": get_config(cfg.name).n_layers,
            "d_model": cfg.d_model, "pattern": list(cfg.pattern),
            "params": sum(t.numel() for t in tree_leaves(params)),
            "param_gb": sum(t.numel() * t.element_size()
                            for t in tree_leaves(params)) / 1e9}


def kinds_of(cfg):
    """Layers of each kind in cfg's stack."""
    return collections.Counter(cfg.pattern[i % len(cfg.pattern)]
                               for i in range(cfg.n_layers))


@contextlib.contextmanager
def moe_routing_count(stats):
    """Count, for every `moe_apply` call, the (token, expert) choices and
    those an expert kept within its capacity (the rest are dropped),
    through the port's own `route` on the same inputs."""
    orig = moe_mod.moe_apply

    def counted(p, cfg, x, **kw):
        N, d = x.shape[0] * x.shape[1], x.shape[2]
        chunk = kw.get("token_chunk", 8192)
        if not (N > chunk and N % chunk == 0):
            r = moe_mod.route(p, cfg, x.reshape(N, d),
                              capacity_factor=kw.get("capacity_factor", 1.25))
            stats["choices"] += N * cfg.moe_top_k
            stats["kept"] += int((r["combine"] > 0).sum())
        return orig(p, cfg, x, **kw)
    moe_mod.moe_apply = counted
    try:
        yield
    finally:
        moe_mod.moe_apply = orig
        stats["dropped"] = stats["choices"] - stats["kept"]


def moe_decode(cfg, params, B, T, seed, paths, name):
    """B x T tokens decoded from empty caches (bf16): ms per step, finite
    logits; then the same steps again with the routing counted (capacity
    drops) and the logits compared bit for bit with the first run."""
    toks = lm_tokens(cfg, B, T, seed)
    serve = make_serve_step(cfg)

    def run():
        cache = init_cache(cfg, B, T, torch.bfloat16, device=DEV)
        out = torch.empty((B, T, cfg.vocab_size), device=DEV)
        for t in range(T):
            lg, cache = serve(params, {"tokens": toks[:, t:t + 1]}, cache)
            out[:, t] = lg[:, 0]
        return out
    with paths.path(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = run()
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    assert bool(torch.isfinite(logits).all())
    stats = collections.Counter()
    with moe_routing_count(stats):
        again = run()

    def steps(n=16):
        cache = init_cache(cfg, B, T, torch.bfloat16, device=DEV)
        for t in range(n):
            serve(params, {"tokens": toks[:, t:t + 1]}, cache)
    return {"batch": B, "steps": T, "ms_per_step": dec_s * 1e3 / T,
            "trace_16_steps": device_trace(steps),
            "tokens_per_s": B * T / dec_s, "launches": paths.paths[name],
            "capacity_per_expert": moe_mod.capacity(cfg, B),
            "routing": dict(stats),
            "repeat_bitwise_equal": bool(torch.equal(logits, again))}


#: MoE layer, card vs CPU (f32, TF32 off): the CPU tests' bound, atol =
#: rtol = 1e-4 — the same f32 function with its products summed in
#: another order (cuBLAS vs the CPU's BLAS), a few thousand terms deep.
MOE_TOL = 1e-4


def min_gap(sorted_desc, k):
    """Smallest non-zero gap between the k-th and (k+1)-th values of the
    rows (exact ties go by the tie rule, not by rounding); None where no
    row has k + 1 values or every gap is 0."""
    if k >= sorted_desc.shape[1]:
        return None
    gap = sorted_desc[:, k - 1] - sorted_desc[:, k]
    gap = gap[gap > 0]
    return float(gap.min()) if gap.numel() else None


def moe_layer_check(arch, N, seed):
    """One full-width MoE layer of `arch`, random f32 weights made on the
    card, N tokens: `moe_apply` on the card (twice: bit for bit equal)
    against the same function on the CPU on copies of the same tensors.
    Routing (each token's top-k, each expert's top-C) equal; the f32
    margins at the k-th and C-th places say how far from a float flip the
    reference values were."""
    cfg = get_config(arch)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    p = moe_mod.moe_init(gen, cfg, torch.float32)
    x = torch.randn(1, N, cfg.d_model, device=DEV, generator=gen)
    card_ms, y = time_host(lambda: moe_mod.moe_apply(p, cfg, x))
    repeat_equal = bool(torch.equal(y, moe_mod.moe_apply(p, cfg, x)))
    r = moe_mod.route(p, cfg, x[0])
    pc = tree_map(lambda t: t.cpu(), p)
    xc = x.cpu()
    del p
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    yc = moe_mod.moe_apply(pc, cfg, xc)
    cpu_s = time.perf_counter() - t0
    rc = moe_mod.route(pc, cfg, xc[0])
    del pc
    srt = torch.sort(rc["probs"], dim=-1, descending=True).values
    k, C = cfg.moe_top_k, rc["idx"].shape[1]
    wt = torch.sort(rc["w"].T, dim=-1, descending=True).values
    d = (y.cpu() - yc).abs()
    ok = bool((d <= MOE_TOL + MOE_TOL * yc.abs()).all())
    rec = {"arch": arch, "tokens": N, "experts": cfg.moe_num_experts,
           "top_k": k, "d_ff": cfg.moe_d_ff, "capacity": C,
           "expert_weights_gb_bf16": 3 * cfg.moe_num_experts * cfg.d_model
           * cfg.moe_d_ff * 2 / 1e9,
           "top_i_equal": bool(torch.equal(r["top_i"].cpu(), rc["top_i"])),
           "idx_equal": bool(torch.equal(r["idx"].cpu(), rc["idx"])),
           "topk_margin_min": min_gap(srt, k),
           "capacity_margin_min": min_gap(wt, C),
           "max_abs_err": float(d.max()), "out_abs_max": float(yc.abs().max()),
           "within_tolerance": ok, "repeat_bitwise_equal": repeat_equal,
           "card_ms": card_ms, "cpu_seconds": cpu_s,
           "tolerance": "atol = rtol = 1e-4 (f32, TF32 off)"}
    if not (ok and rec["top_i_equal"] and rec["idx_equal"]
            and repeat_equal):
        raise AssertionError(f"MoE layer card != CPU: {rec}")
    return rec


def lm_moe_phase(args, paths):
    """qwen2-moe-a2.7b whole (24 layers, full width, bf16, random weights
    from --seed; --quick 4 layers): one 32,768-token prefill (--quick
    4,096; one B5 launch per layer), 4 x 256 decode steps (--quick 2 x
    64); then one full-width MoE layer each of qwen2-moe-a2.7b and
    mixtral-8x22b in f32 on the card against the CPU."""
    quick = args.quick
    cfg = get_config("qwen2-moe-a2.7b")
    if quick:
        cfg = dataclasses.replace(cfg, n_layers=4)
    t0 = time.perf_counter()
    params = init_params(cfg, args.seed, torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    rec = param_record(cfg, params)
    rec["init_seconds"] = time.perf_counter() - t0
    T = 4096 if quick else 32768
    rec["prefill"] = model_prefill(cfg, params, T, args.seed, paths,
                                   "lm_moe_prefill",
                                   kernels={"flash_tc": "flash_tc_kernel"})
    got = rec["prefill"]["launches"]
    assert got["flash_tc"] == cfg.n_layers and got["flash_tf32x3"] == 0, got
    # B5 at this prefill's shape: its traced device ms a launch beside the
    # bound (4*D FLOP a live pair at the bf16 peak; shapes only).
    b5 = rec["prefill"]["trace"].get("by_kernel", {}).get("flash_tc")
    qk = [torch.empty((1, h, T, cfg.head_dim), dtype=torch.bfloat16,
                      device="meta") for h in (cfg.n_heads, cfg.n_kv_heads)]
    bound, by = flash_bound(*qk, None)
    rec["prefill"]["b5"] = {
        "q": list(qk[0].shape), "kv": list(qk[1].shape), "window": None,
        "ms_per_launch": b5["ms"] / b5["count"] if b5 and b5["count"]
        else "not measured", "bound_ms": bound, "bound_by": by}
    stats = collections.Counter()
    with moe_routing_count(stats):
        make_prefill_step(cfg)(params, {"tokens": lm_tokens(cfg, 1, T,
                                                            args.seed)})
    rec["prefill"]["routing"] = dict(stats)
    emit("lm_progress", {"moe_prefill": rec["prefill"]})
    Bd, Td = (2, 64) if quick else (4, 256)
    rec["decode"] = moe_decode(cfg, params, Bd, Td, args.seed + 1, paths,
                               "lm_moe_decode")
    assert rec["decode"]["repeat_bitwise_equal"], rec["decode"]
    del params
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec["layer_checks"] = [
        moe_layer_check("qwen2-moe-a2.7b", 512, args.seed + 5),
        moe_layer_check("mixtral-8x22b", 128, args.seed + 6)]
    torch.cuda.empty_cache()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


def recurrent_model(args, arch, quick_layers, paths, tag, expect,
                    kernels=None):
    """`arch` whole at full width (--quick `quick_layers` layers): a bf16
    prefill of one 32,768-token sequence (--quick 4,096) with its kernel
    launches (and `kernels`' device ms in its trace, as `device_trace`
    takes them), then decode against prefill (teacher forcing) on 2 x 256
    tokens (--quick 2 x 128; multiples of the mLSTM chunk) in bf16 and,
    on f32 weights, in f32."""
    quick = args.quick
    cfg = get_config(arch)
    if quick:
        cfg = dataclasses.replace(cfg, n_layers=quick_layers)
    n = kinds_of(cfg)
    want = {key: sum(n[kind] for kind in kinds)
            for key, kinds in expect.items()}
    params = init_params(cfg, args.seed, torch.bfloat16, device=DEV)
    rec = param_record(cfg, params)
    T = 4096 if quick else 32768
    rec["prefill"] = model_prefill(cfg, params, T, args.seed, paths,
                                   f"lm_prefill{tag}", kernels)
    got = rec["prefill"]["launches"]
    assert all(got[key] == v for key, v in want.items()), (got, want)
    rec["prefill"]["expected_launches"] = want
    emit("lm_progress", {f"prefill{tag}": rec["prefill"]})
    Bt, Tt = (2, 128) if quick else (2, 256)
    toks = lm_tokens(cfg, Bt, Tt, args.seed + 3)
    tf = teacher_forcing(params, cfg, toks, torch.bfloat16, paths, tag)
    tf.pop("prefill_launches")
    tf["tolerance"] = "rel L2 per position <= 2^-5 (the lm line's bound)"
    tf["within_tolerance"] = tf["rel_l2_max"] <= 2 ** -5
    rec["decode_vs_prefill_bf16"] = tf
    del params
    torch.cuda.empty_cache()
    if not tf["within_tolerance"]:
        raise AssertionError(f"{arch} bf16 decode != prefill: {tf}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p32 = init_params(cfg, args.seed, torch.float32, device=DEV)
    tf = teacher_forcing(p32, cfg, toks, torch.float32, paths, f"{tag}_f32")
    tf.pop("prefill_launches")
    tf["tolerance"] = "atol = rtol = 2e-3 (the reference's own bound)"
    tf["within_tolerance"] = tf.pop("allclose_2e-3")
    rec["decode_vs_prefill_f32"] = tf
    rec["decode_depth_cut"] = "none: the teacher-forcing checks run the " \
        "whole stack"
    del p32
    torch.cuda.empty_cache()
    if not tf["within_tolerance"]:
        raise AssertionError(f"{arch} f32 decode != prefill: {tf}")
    return rec


def mixer_teacher_forcing(arch, kind, seed, B=2, T=256):
    """One `kind` block of `arch` at full width, f32 weights and input
    (TF32 off): its mixer output (block output minus input) from the
    prefill (the kernels) against one-token decode from an empty cache —
    the model-level check without the embeddings' residual stream, which
    at random weights dwarfs what the mixers add. The scale the agreement
    is small against: how far each position's output moves when its token
    is decoded alone, from an empty cache (what the carried state and conv
    context contribute)."""
    cfg = get_config(arch)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    p = block_mod.block_init(gen, cfg, kind, torch.float32)
    d = cfg.d_model
    x = torch.randn(B, T, d, device=DEV, generator=gen)
    pos = torch.arange(T, device=DEV)[None].expand(B, T)
    with torch.no_grad():
        ref = block_mod.block_apply(p, cfg, kind, x, pos) - x
        cache = block_mod.block_cache_init(cfg, kind, B, T, torch.float32,
                                           device=DEV)
        dec = torch.empty_like(ref)
        for t in range(T):
            y, cache = block_mod.block_decode(p, cfg, kind, x[:, t:t + 1],
                                              cache)
            dec[:, t] = (y - x[:, t:t + 1])[:, 0]
        xs = x.reshape(B * T, 1, d)
        alone = block_mod.block_decode(
            p, cfg, kind, xs, block_mod.block_cache_init(
                cfg, kind, B * T, 1, torch.float32, device=DEV))[0] - xs
        state = rel_l2(alone.reshape(B, T, d), ref)
    diff = (dec - ref).abs()
    err = rel_l2(dec, ref)
    rec = {"arch": arch, "kind": kind, "batch": B, "steps": T,
           "d_model": d, "max_abs_err": float(diff.max()),
           "out_abs_max": float(ref.abs().max()),
           "rel_l2_max": float(err.max()),
           "state_rel_l2_median": float(state.median()),
           "tolerance": "atol = rtol = 2e-3, and rel L2 per position <= "
                        "1/4 of the median change decoding each token "
                        "alone makes"}
    rec["within_tolerance"] = bool(
        (diff <= 2e-3 + 2e-3 * ref.abs()).all()) \
        and rec["rel_l2_max"] <= rec["state_rel_l2_median"] / 4
    if not rec["within_tolerance"]:
        raise AssertionError(f"{kind} mixer decode != prefill: {rec}")
    return rec


def lm_recurrent_phase(args, paths):
    """recurrentgemma-9b whole (38 layers: 26 RG-LRU, 12 local attention;
    --quick 8) and xlstm-125m whole (12 layers: 6 mLSTM, 6 sLSTM; --quick
    4)."""
    torch.cuda.reset_peak_memory_stats()
    rg = recurrent_model(args, "recurrentgemma-9b", 8, paths, "_rg",
                         {"rglru_scan": ("rglru",), "flash_tc": ("local",)},
                         {"rglru_scan": "rglru_scan_kernel",
                          "flash_tc": "flash_tc_kernel"})
    xl = recurrent_model(args, "xlstm-125m", 4, paths, "_xl",
                         {"mlstm_chunk_states": ("mlstm",),
                          "mlstm_state_scan": ("mlstm",),
                          "mlstm_chunk_outputs": ("mlstm",),
                          "slstm": ("slstm",)},
                         {key: f"{key}_kernel" for key in (
                             "mlstm_chunk_states", "mlstm_state_scan",
                             "mlstm_chunk_outputs", "slstm")})
    mixers = [mixer_teacher_forcing("recurrentgemma-9b", "rglru",
                                    args.seed + 7),
              mixer_teacher_forcing("xlstm-125m", "mlstm", args.seed + 8),
              mixer_teacher_forcing("xlstm-125m", "slstm", args.seed + 9)]
    return {"recurrentgemma": rg, "xlstm": xl, "mixers_f32": mixers,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def tree_leaves(tree):
    return [t for _, t in tree_leaves_with_path(tree)]


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


#: Launch counters of the kernels' wrappers and call counters of the
#: plain versions (the persistent plain version and the table walker's
#: plain version run through the two counted plain functions).
COUNTERS = {
    "banded_dp": banded_align_cuda,
    "traceback": tbd.decode_packed_tb_cuda,
    "traceback_table": tbd.decode_packed_tb_table_cuda,
    "persistent": persistent_align_cuda,
    "chain": chain_mod.chain_padded_cuda,
    "flash_tc": flash_attention_tc_cuda,
    "flash_tc_bwd": flash_attention_bwd_tc_cuda,
    "flash_tf32x3": flash_attention_tf32x3_cuda,
    "flash_tf32x3_bwd": flash_attention_bwd_tf32x3_cuda,
    "flash_fma": flash_attention_fma_cuda,
    "rglru_scan": rglru_mod.rglru_scan_cuda,
    "rglru_scan_bwd": rglru_mod.rglru_scan_bwd_cuda,
    "mlstm_chunk_states": xlstm_mod.mlstm_chunk_states_cuda,
    "mlstm_state_scan": xlstm_mod.mlstm_state_scan_cuda,
    "mlstm_chunk_outputs": xlstm_mod.mlstm_chunk_outputs_cuda,
    "slstm": xlstm_mod.slstm_scan_cuda,
    "mlstm_bwd_outputs": xlstm_mod.mlstm_bwd_outputs_cuda,
    "mlstm_bwd_scan": xlstm_mod.mlstm_bwd_scan_cuda,
    "mlstm_bwd_inputs": xlstm_mod.mlstm_bwd_inputs_cuda,
    "slstm_bwd": xlstm_mod.slstm_scan_bwd_cuda,
}
PLAIN = {
    "plain_banded": banded.banded_align_batch,
    "plain_traceback": tbd.decode_packed_tb_plain,
    "plain_chain": chain_mod.chain_padded_plain,
    "plain_flash": flash_attention_plain,
    "plain_flash_bwd": flash_attention_bwd_plain,
    "plain_rglru": rglru_mod.rglru_scan_plain,
    "plain_rglru_bwd": rglru_mod.rglru_scan_bwd_plain,
    "plain_mlstm": xlstm_mod.mlstm_chunk_scan_plain,
    "plain_mlstm_states": xlstm_mod.mlstm_chunk_states_plain,
    "plain_mlstm_scan": xlstm_mod.mlstm_state_scan_plain,
    "plain_mlstm_outputs": xlstm_mod.mlstm_chunk_outputs_plain,
    "plain_slstm": xlstm_mod.slstm_scan_plain,
    "plain_mlstm_bwd_outputs": xlstm_mod.mlstm_bwd_outputs_plain,
    "plain_mlstm_bwd_scan": xlstm_mod.mlstm_bwd_scan_plain,
    "plain_mlstm_bwd_inputs": xlstm_mod.mlstm_bwd_inputs_plain,
    "plain_slstm_bwd": xlstm_mod.slstm_scan_bwd_plain,
}


#: Wrappers that also count their launches by (sweep length T, pairs N).
SHAPED = {"banded_dp": banded_align_cuda,
          "traceback": tbd.decode_packed_tb_cuda,
          "persistent": persistent_align_cuda,
          "traceback_table": tbd.decode_packed_tb_table_cuda}


def sweep_class(T):
    """The bucket edge of a launch of sweep length T (a pair of bucket c
    sweeps at most 2c steps)."""
    return next((e for e in DEFAULT_BUCKET_EDGES if 2 * e >= T),
                DEFAULT_BUCKET_EDGES[-1])


#: Launch counters a wrapper keeps beside `launches`: (wrapper, attribute).
#: The f32 backward counts its D 256 kernel (mma.sync) apart.
EXTRA_COUNTERS = {
    "flash_tf32x3_bwd_mma_sync": (flash_attention_bwd_tf32x3_cuda,
                                  "mma_sync_launches"),
}


def counts():
    out = {k: fn.launches for k, fn in COUNTERS.items()}
    out.update({k: getattr(fn, attr)
                for k, (fn, attr) in EXTRA_COUNTERS.items()})
    out.update({k: fn.calls for k, fn in PLAIN.items()})
    return out


def zero_counts():
    for fn in COUNTERS.values():
        fn.launches = 0
    for fn, attr in EXTRA_COUNTERS.values():
        setattr(fn, attr, 0)
    for fn in PLAIN.values():
        fn.calls = 0
    for fn in SHAPED.values():
        fn.shapes.clear()
    for counter in BY_KIND.values():
        counter.clear()


#: Launches by kind of the wrappers that count them: B1 and B2 by body
#: ("warp" / "block").
BY_KIND = {"banded_dp": banded_align_cuda.bodies,
           "persistent": persistent_align_cuda.bodies}


class PathCounts:
    """Launch counts of the main paths: each path is driven inside
    `path(name)`, with every count set to 0 just before it and read just
    after; launches made to compare a kernel with its plain version fall
    outside. A path that calls a plain version fails."""

    def __init__(self):
        self.paths = {}
        self.shapes = {k: collections.Counter() for k in SHAPED}
        self.kinds = {k: collections.Counter() for k in BY_KIND}

    @contextlib.contextmanager
    def path(self, name):
        zero_counts()
        yield
        got = counts()
        assert all(got[k] == 0 for k in PLAIN), (name, got)
        self.paths[name] = got
        for k, fn in SHAPED.items():
            self.shapes[k].update(fn.shapes)
        for k, counter in BY_KIND.items():
            self.kinds[k].update(counter)

    def total(self, *keys):
        return sum(c[k] for c in self.paths.values() for k in keys)

    def by_class(self, key):
        """{bucket edge: {pairs per launch: launches}} of a kernel of
        `SHAPED` over all paths."""
        out = {}
        for (T, N), c in sorted(self.shapes[key].items()):
            cls = out.setdefault(sweep_class(T), {})
            cls[N] = cls.get(N, 0) + c
        return out


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


def device_trace(fn, kernels=None, wall_ms=None):
    """Time `fn` on the host clock (second call), then run it again under
    torch.profiler and sum the device time of every kernel and copy by
    name: the device's busy share of the untraced wall time, and where
    it went (tracing slows the host, so the traced wall time is given
    apart). `kernels` {label: part of a kernel's name}: the count and
    device ms of the trace's kernels whose name holds that part
    (`by_kernel`). Given `wall_ms` (an untraced call the caller timed),
    `fn` runs once, traced. Returns "not measured" in place of the numbers
    when the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if wall_ms is None:
        fn()                        # warm: pinned buffers, allocator
        wall_ms, _ = time_host(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms, _ = time_host(fn)
    by_name: dict = {}
    by_kernel = {label: [0, 0.0] for label in kernels or {}}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        rec = by_name.setdefault(evt.name[:60], [0, 0.0])
        rec[0] += 1
        rec[1] += evt.time_range.elapsed_us()
        for label, part in (kernels or {}).items():
            if part in evt.name:
                by_kernel[label][0] += 1
                by_kernel[label][1] += evt.time_range.elapsed_us()
    if not by_name:
        return {"device_busy_share": "not measured"}
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_events": sum(c for c, _ in by_name.values()),
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            "top": [{"name": k, "count": c, "ms": us / 1e3}
                    for k, (c, us) in top],
            "by_kernel": {label: {"count": c, "ms": us / 1e3}
                          for label, (c, us) in by_kernel.items()}}


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


def closed_loop(front, reads, refs):
    """A closed loop of single-pair requests through `front` (a started
    AlignmentService or AlignmentRouter), which it then closes. Returns
    (results, stats, seconds from the first submit to the last result)."""
    with front:
        t0 = time.perf_counter()
        futures = [front.submit(rd, rf) for rd, rf in zip(reads, refs)]
        results = [f.result(timeout=600) for f in futures]
        seconds = time.perf_counter() - t0
        stats = front.stats()
    stats.pop("priority", None)
    stats.pop("depth_signatures", None)
    return results, stats, seconds


def serve_run(engine, reads, refs):
    """A closed loop of single-pair requests through an AlignmentService
    over `engine`. Returns (results, service stats, seconds)."""
    return closed_loop(AlignmentService(engine, collect_tb=True,
                                        max_inflight_groups="auto"),
                       reads, refs)


def merge_spans(spans):
    """Sorted, non-overlapping union of (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stream_trace(fn):
    """Run `fn` once under torch.profiler; `stream_busy` of the device
    events in the exported trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = time_host(fn)
    path = build.build_dir() / "stream_trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    path.unlink()
    return stream_busy(events, wall_ms)


def stream_busy(events, wall_ms):
    """Per device stream of a chrome trace its kernels and copies and
    their busy ms (intervals merged); the ms during which two or more
    streams were busy at once; the busy share of `wall_ms`. "not
    measured" when the trace holds no device event."""
    spans, kernels = collections.defaultdict(list), collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        stream = e.get("args", {}).get("stream", e.get("tid"))
        t0 = float(e["ts"])
        spans[stream].append((t0, t0 + float(e.get("dur", 0))))
        kernels[stream] += e["cat"] == "kernel"
    if not spans:
        return {"streams": "not measured"}
    merged = {s: merge_spans(v) for s, v in spans.items()}
    edges = sorted((t, d) for v in merged.values() for a, b in v
                   for t, d in ((a, 1), (b, -1)))
    busy = overlap = 0.0
    active, last = 0, edges[0][0]
    for t, d in edges:
        busy += (t - last) * (active >= 1)
        overlap += (t - last) * (active >= 2)
        active, last = active + d, t
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall_ms,
            "two_or_more_streams_busy_ms": overlap / 1e3,
            "streams": [{"stream": s, "events": len(spans[s]),
                         "kernels": kernels[s],
                         "busy_ms": sum(b - a for a, b in v) / 1e3}
                        for s, v in sorted(merged.items(),
                                           key=lambda kv: str(kv[0]))]}


#: Per-replica service gauges the `router` line keeps.
REPLICA_KEYS = ("completed", "dispatches", "fill_ratio", "real_pairs",
                "padded_slots", "p50_ms", "p99_ms")


def replica_gauges(stats):
    """Fill ratio, flush causes and latency of each replica (of the one
    service at 1 replica) from its `stats()`."""
    per = stats["replicas"].values() if "replicas" in stats else [stats]
    return [{k: v for k, v in s.items()
             if k in REPLICA_KEYS or k.startswith("flush_")} for s in per]


def router_phase(paths, reads, refs):
    """The same closed loop through one AlignmentService and through an
    AlignmentRouter over two replicas, each over a fresh engine on the
    card and warmed up first; every result of the router equals the
    single service's. Then the two-replica loop once more, traced: how
    long the two replicas' streams were busy, and at the same time.
    Returns the record of the `router` line."""
    opts = dict(collect_tb=True, max_inflight_groups="auto",
                warmup=[(150, 150)])
    runs = {}
    for replicas in (1, 2):
        with paths.path(f"router_{replicas}"):
            if replicas == 1:
                front = AlignmentService(AlignmentEngine(backend="auto"),
                                         **opts)
                services = [front]
            else:
                front = AlignmentRouter(replicas,
                                        engine_opts=dict(backend="auto"),
                                        seed=0, **opts)
                services = [r.service for r in front.pool.replicas]
            results, stats, seconds = closed_loop(front, reads, refs)
        runs[replicas] = {
            "results": results, "seconds": seconds,
            "requests_per_s": len(results) / seconds,
            "streams": [svc.stream.cuda_stream for svc in services],
            "completed_by_replica": [svc.metrics.completed
                                     for svc in services],
            "by_replica": replica_gauges(stats),
            "launches": paths.paths[f"router_{replicas}"]}
    single = runs[1].pop("results")
    for p, res in enumerate(runs[2].pop("results")):
        assert res.keys() == single[p].keys(), p
        for key, v in res.items():
            assert (v == single[p][key] if key == "cigar"
                    else int(v) == int(single[p][key])), (p, key)
    streams = runs[2]["streams"]
    default = torch.cuda.default_stream(DEV).cuda_stream
    assert len(set(streams)) == 2 and default not in streams, streams
    assert all(c > 0 for c in runs[2]["completed_by_replica"]), runs[2]

    def loop():
        futures = [front.submit(rd, rf) for rd, rf in zip(reads, refs)]
        return [f.result(timeout=600) for f in futures]
    front = AlignmentRouter(2, engine_opts=dict(backend="auto"), seed=0,
                            **opts)
    with front:
        loop()                          # warm: pinned buffers, allocator
        trace = stream_trace(loop)
    return {"requests": len(reads), "equal_to_single_service": True,
            "replicas": {str(k): v for k, v in runs.items()},
            "trace_2_replicas": trace}


def launcher_phase(paths, quick):
    """`launch.serve --no-mesh` and `launch.map`, each at 1 and at 2
    replicas, through their `main`: at 2 replicas every request goes
    through an AlignmentRouter and the results equal the single
    service's. Returns the record of the `launchers` line."""
    serve_args = ["--reads", "128" if quick else "512", "--no-mesh"]
    map_args = ["--reads", "64" if quick else "200"]
    out = {}
    for name, main_fn, args in (("serve", serve_launcher.main, serve_args),
                                ("map", map_launcher.main, map_args)):
        got = {}
        for replicas in (1, 2):
            tag = f"launch_{name}_{replicas}"
            t0 = time.perf_counter()
            with paths.path(tag):
                got[replicas] = main_fn(args + ["--replicas", str(replicas)])
            out[tag] = {"argv": args + ["--replicas", str(replicas)],
                        "seconds": time.perf_counter() - t0,
                        "launches": paths.paths[tag]}
        if name == "serve":
            (one, _), (two, stats) = got[1], got[2]
            assert stats["replicas_serving"] == 2, stats
            assert all(s["completed"] > 0
                       for s in stats["replicas"].values()), stats
            assert [int(s) for s in one] == [int(s) for s in two]
        else:
            assert got[1] == got[2]
    return out


def shard_trace(fn):
    """Run `fn` once under torch.profiler (shapes recorded) and count, in
    the exported trace, the device kernels by device, the copies by kind,
    the NCCL kernels and the peer-to-peer copies (card to card), and read
    its collectives by kind (`collective_bytes_by_kind`): a sharded run
    holds none of the last three."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        wall_ms, _ = time_host(fn)
    path = build.build_dir() / "shard_trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        trace = json.load(fh)
    path.unlink()
    events = trace["traceEvents"]
    kernels, copies = collections.Counter(), collections.Counter()
    nccl = peer = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "kernel":
            kernels[str(e.get("args", {}).get("device"))] += 1
            nccl += "nccl" in e["name"].lower()
        elif e.get("cat") == "gpu_memcpy":
            copies[e["name"].split(" (")[0]] += 1
            peer += "PtoP" in e["name"]
    return {"traced_wall_ms": wall_ms, "kernels_by_device": dict(kernels),
            "copies_by_kind": dict(copies), "nccl_kernels": nccl,
            "peer_copies": peer,
            "collectives": collective_bytes_by_kind(trace)}


def mesh_phase(paths, reads, refs, out_all, short, eng64):
    """The sharded engine over a mesh of the visible cards: the ragged
    request through `align` at every shard count up to the card count,
    `torch.equal` to the unsharded engine's results (`out_all`); sharded
    and unsharded pairs/s in turns (unsharded, sharded, sharded,
    unsharded); `make_aligner` on one padded 150 bp group against
    `align_arrays`; a traced sharded run with no NCCL kernel and no peer
    copy; `launch.serve` with the mesh against `--no-mesh`. Returns the
    record of the `mesh` line."""
    t0 = time.perf_counter()
    n_dev = torch.cuda.device_count()
    out = {"cards": n_dev, "by_shards": {}}
    for shards in range(1, n_dev + 1):
        tag = f"mesh_{shards}"
        with paths.path(tag):
            engm = AlignmentEngine(backend="auto",
                                   mesh=make_debug_mesh(data=shards))
            assert engm.num_shards == shards, engm.num_shards
            got, rec = timed_align(engm, reads, refs, "global",
                                   f"ragged request, {shards} shard(s)")
        for key in SCALAR_KEYS + ("band",):
            assert torch.equal(torch.from_numpy(got[key]),
                               torch.from_numpy(out_all[key])), (tag, key)
        assert got["cigars"] == out_all["cigars"], tag
        out["by_shards"][shards] = dict(rec, launches=paths.paths[tag],
                                        equal_to_unsharded=True)
    # engm: the mesh over every card.
    rates = []
    for label, engine in (("unsharded", eng64), ("sharded", engm),
                          ("sharded", engm), ("unsharded", eng64)):
        with paths.path(f"mesh_turn_{len(rates)}"):
            _, rec = timed_align(engine, reads, refs, "global", label)
        rates.append({"engine": label, "pairs_per_s": rec["pairs_per_s"],
                      "seconds": rec["seconds"]})
    out["turns"] = rates
    # One padded 150 bp group, whole capacity blocks per shard.
    rows = 64 * n_dev
    spec = plan_buckets([len(x) for x in short[0][:rows]],
                        [len(x) for x in short[1][:rows]])[0].spec
    q, r, n, m = pad_group(short[0][:rows], short[1][:rows], spec,
                           pad_multiple=rows)
    with paths.path("mesh_aligner"):
        aligner = make_aligner(engm.mesh, MINIMAP2, band=spec.band,
                               collect_tb=True, t_max=spec.t_max,
                               decode="device")
        shards_out = aligner(q, r, n, m)
        ref = eng64.align_arrays(q, r, n, m, band=spec.band,
                                 collect_tb=True, t_max=spec.t_max,
                                 decode="device")
        torch.cuda.synchronize()
    assert len(shards_out) == n_dev
    for o, dev in zip(shards_out, engm.shard_devices):
        assert all(t.device == dev for t in o.values()), dev
    for key in ref:
        joined = torch.cat([o[key].cpu() for o in shards_out])
        assert torch.equal(joined, ref[key].cpu()), key
    out["aligner"] = {"rows": rows, "band": spec.band, "t_max": spec.t_max,
                      "equal_to_align_arrays": True,
                      "launches": paths.paths["mesh_aligner"]}
    with paths.path("mesh_trace"):
        trace = shard_trace(lambda: engm.align(reads, refs, collect_tb=True))
    assert sum(trace["kernels_by_device"].values()) > 0, trace
    assert trace["nccl_kernels"] == 0 and trace["peer_copies"] == 0, trace
    assert trace["collectives"]["total_bytes"] == 0, trace
    out["trace"] = trace
    served = {}
    for tag, argv in (("launch_serve_mesh", ["--reads", "512"]),
                      ("launch_serve_no_mesh", ["--reads", "512",
                                                "--no-mesh"])):
        with paths.path(tag):
            served[tag] = serve_launcher.main(argv)
        out[tag] = {"argv": argv, "launches": paths.paths[tag]}
    assert [int(x) for x in served["launch_serve_mesh"][0]] \
        == [int(x) for x in served["launch_serve_no_mesh"][0]]
    out["launch_serve_mesh_equal_to_no_mesh"] = True
    out["seconds"] = time.perf_counter() - t0
    return out


def roofline_phase(reads, refs, engine, pipelined, persistent, num_shards):
    """`alignment_roofline` on the H100's int32 record for each bucket
    class of the ragged request (mean length (n + m) / 2, band, pairs; its
    dispatch slices as the pipelined dispatch groups) and for the whole
    request, pipelined and persistent, beside the measured pairs/s and
    the share of the bound; the measured host time per dispatch slice
    against the model's assumed `DISPATCH_OVERHEAD_S`; and B1's
    kernel-table bound at the same classes (`kernel_work.
    WAVEFRONT_OPS_PER_CELL` per
    cell, not the model's 15). Host arithmetic only."""
    t0 = time.perf_counter()
    classes, totals = [], {"pipelined": 0.0, "persistent_overlap": 0.0}
    b1_total_ms, slices_total = 0.0, 0
    for g in engine.plan([len(x) for x in reads], [len(x) for x in refs]):
        n = np.asarray([len(reads[i]) for i in g.indices], np.int64)
        m = np.asarray([len(refs[i]) for i in g.indices], np.int64)
        pairs, spec = len(g.indices), g.spec
        bucket = max(spec.q_len, spec.r_len)
        slices = -(-pairs // (spec.capacity * num_shards))
        rec = {"length": float((n + m).mean() / 2), "band": spec.band,
               "global_batch": pairs, "shape": f"bucket{bucket}",
               "mesh": str(num_shards), "mesh_shape": [num_shards],
               "n_groups": slices}
        pipe = alignment_roofline(dict(rec, dispatch="pipelined"),
                                  H100_INT32)
        pers = alignment_roofline(dict(rec, dispatch="persistent"),
                                  H100_INT32)
        b1_ms, b1_by = wavefront_bound(n, m, pairs, spec.q_len, spec.r_len,
                                       spec.t_max, spec.band, True)
        totals["pipelined"] += pipe["step_time_total_s"]
        totals["persistent_overlap"] += pers["step_time_overlap_s"]
        b1_total_ms += b1_ms
        slices_total += slices
        classes.append({
            "bucket": bucket, "pairs": pairs,
            "length": rec["length"], "band": spec.band,
            "dispatch_slices": slices,
            "pipelined_bound_pairs_per_s": pipe["pairs_per_s_per_chip_bound"],
            "persistent_bound_pairs_per_s":
                pers["pairs_per_s_per_chip_bound"],
            "roofline_overlap_ms": pipe["step_time_overlap_s"] * 1e3,
            "roofline_dominant": pipe["dominant"],
            "roofline_ops_per_cell": 15,
            "b1_bound_ms": b1_ms, "b1_bound_by": b1_by,
            "b1_ops_per_cell": kernel_work.WAVEFRONT_OPS_PER_CELL,
            "b1_bound_pairs_per_s": pairs / (b1_ms / 1e3)})
    N = len(reads)
    pipe_bound = N / totals["pipelined"]
    pers_bound = N / (totals["persistent_overlap"] + DISPATCH_OVERHEAD_S)
    return {
        "hardware": dataclasses.asdict(H100_INT32), "shards": num_shards,
        "classes": classes, "pairs": N,
        "pipelined": {"bound_pairs_per_s": pipe_bound,
                      "measured_pairs_per_s": pipelined["pairs_per_s"],
                      "share": pipelined["pairs_per_s"] / pipe_bound},
        "persistent": {"bound_pairs_per_s": pers_bound,
                       "measured_pairs_per_s": persistent["pairs_per_s"],
                       "share": persistent["pairs_per_s"] / pers_bound},
        "b1_bound_pairs_per_s": N / (b1_total_ms / 1e3),
        "dispatch_slices": slices_total,
        "assumed_dispatch_overhead_ms": DISPATCH_OVERHEAD_S * 1e3,
        "measured_host_ms_per_dispatch_slice":
            pipelined["seconds"] * 1e3 / slices_total,
        "measured_host_ms_per_persistent_request":
            persistent["seconds"] * 1e3,
        "seconds": time.perf_counter() - t0}


def pad_lists(reads, refs):
    """Ragged (reads, refs) as padded (q, r, n, m) arrays."""
    n = np.asarray([len(x) for x in reads], np.int32)
    m = np.asarray([len(x) for x in refs], np.int32)
    q = np.full((len(reads), int(n.max())), 4, np.int8)
    r = np.full((len(refs), int(m.max())), 4, np.int8)
    for p, (a, b) in enumerate(zip(reads, refs)):
        q[p, :len(a)] = a
        r[p, :len(b)] = b
    return q, r, n, m


def edit_distance_phase(paths, streams):
    """Edit distance (paper Fig. 14) through the CUDA backend on each of
    `streams` ({name: (reads, refs)}), held against the plain backend on
    the same card (distances and CIGARs equal), then a 64-pair sample with
    a band over the whole matrix held against `levenshtein_reference`."""
    recs = []
    for name, (reads, refs) in streams.items():
        q, r, n, m = pad_lists(reads, refs)
        with paths.path(f"edit_distance_{name}"):
            ms, out = time_host(lambda: edit_distance_batch(
                q, r, n, m, with_traceback=True))
        plain_ms, plain = time_host(lambda: edit_distance_batch(
            q, r, n, m, with_traceback=True, backend="reference"))
        assert np.array_equal(out["distance"], plain["distance"]), name
        assert out["cigars"] == plain["cigars"], name
        for p, cig in enumerate(out["cigars"]):
            assert consumed(cig) == (n[p], m[p]), (name, p)
        recs.append({"stream": name, "pairs": len(reads), "band": out["band"],
                     "t_max": out["t_max"], "ms": ms,
                     "pairs_per_s": len(reads) / ms * 1e3,
                     "plain_ms": plain_ms,
                     "mean_distance": float(out["distance"].mean()),
                     "launches": paths.paths[f"edit_distance_{name}"]})
    reads, refs = next(iter(streams.values()))
    q, r, n, m = pad_lists(reads[:64], refs[:64])
    band = int(max(n.max(), m.max())) + 2
    full = edit_distance_batch(q, r, n, m, band=band)
    lev = [levenshtein_reference(reads[p], refs[p]) for p in range(64)]
    assert full["distance"].tolist() == lev
    # The single-pair entry point on the card (a batch of one through the
    # same kernels), at its own band (the path counted) == the plain
    # single-pair wavefront and host decoder on the CPU; at the full band
    # (a check, on the block body above band 128) == Levenshtein.
    with paths.path("edit_distance_single"):
        single = [edit_distance(reads[p], refs[p], with_traceback=True)
                  for p in range(8)]
    for p, own in enumerate(single):
        assert own == edit_distance(reads[p], refs[p], with_traceback=True,
                                    device="cpu"), p
        dist, cig = edit_distance(reads[p], refs[p], band=band,
                                  with_traceback=True)
        assert dist == lev[p] and consumed(cig) == (n[p], m[p]), p
    return {"streams": recs, "levenshtein_sample": {
        "pairs": 64, "band": band, "equal": True},
        "single_pair": {"pairs": 8, "equal_to_levenshtein": True,
                        "equal_to_plain_cpu": True,
                        "launches": paths.paths["edit_distance_single"]}}


def map_reads(index, sims, dispatch, bw, stats):
    """The read mapper over an AlignmentService over a fresh engine.
    Returns (results, service stats, seconds after the warm-up)."""
    engine = AlignmentEngine(backend="auto", dispatch=dispatch,
                             base_bandwidth=bw)
    # Streams, pinned buffers and libraries before the clock.
    engine.warmup([(len(sims[0].read), len(sims[0].read) + 40)],
                  mode="semiglobal", collect_tb=True)
    t0 = time.perf_counter()
    with AlignmentService(engine, mode="semiglobal", collect_tb=True,
                          max_wait_ms=2.0) as svc:
        res = ReadMapper(index, svc).map_batch([sr.read for sr in sims],
                                               stats=stats)
        svc_stats = svc.stats()
    return res, svc_stats, time.perf_counter() - t0


def check_served(results, one_shot):
    for p, res in enumerate(results):
        assert int(res["score"]) == int(one_shot["score"][p]), p
        assert res["cigar"] == one_shot["cigars"][p], p


def anchor_sets(index, reads):
    """Both strands' anchor lists of every read, in the order the mapper
    chains them."""
    out = []
    for read in reads:
        for probe in (read, reverse_complement(read)):
            hit = index.lookup(probe)
            out.append((hit.q_pos, hit.r_pos))
    return out


def recall(sims, results):
    hits = sum(1 for sr, r in zip(sims, results)
               if r.status == STATUS_MAPPED and r.strand == sr.strand
               and abs(r.ref_start - sr.locus) <= max(r.band, 1))
    return hits / len(sims)


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
    built = build.build_all()
    if args.quick:
        print("\n".join(built["logs"].values()), flush=True)
    emit("device", {"nvidia_smi": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "python": sys.version.split()[0],
                    "build_seconds": built["seconds"],
                    "built": built["built"]})
    paths = PathCounts()

    # ---- 2. B5 vs its plain version; the language-model serving path ----
    t0 = time.perf_counter()
    f_cases, f_worst = flash_matrix(args.quick)
    f_shapes = flash_main_shapes(3 if args.quick else 8)
    f32_shapes = flash_f32_shapes(3 if args.quick else 8)
    tc_narrow = flash_tc_narrow_shapes(3 if args.quick else 8)
    tc_ptxas = ptxas_facts(built["logs"].get("flash_tc", ""),
                           "flash_tc_kernel")
    if "flash_tc" in built["built"]:
        assert set(tc_ptxas) == {16, 64, 80, 128, 256} and all(
            f["spill_stores"] == 0 and f["spill_loads"] == 0
            for f in tc_ptxas.values()), tc_ptxas
    tf_ptxas = ptxas_facts(built["logs"].get("flash_tf32x3", ""),
                           "flash_tf32x3_kernel")
    if "flash_tf32x3" in built["built"]:
        assert all(f["spill_stores"] == 0 and f["spill_loads"] == 0
                   for f in tf_ptxas.values()), tf_ptxas
    hgmma, cuobjdump = sass_count("flash_tc", "HGMMA")
    if isinstance(hgmma, int):
        assert hgmma > 0, "no HGMMA instruction in flash_tc's SASS"
    # HGMMA by head size (both instantiations of a size summed).
    hgmma_by_d, _ = sass_count("flash_tc", "HGMMA",
                               by=r"flash_tc_kernelILi(\d+)E")
    if isinstance(hgmma_by_d, dict):
        assert all(hgmma_by_d.get(D_, 0) > 0 for D_ in (16, 64, 80, 128,
                                                          256)), hgmma_by_d
    hmma, _ = sass_count("flash_tf32x3", "HMMA")
    if isinstance(hmma, int):
        assert hmma > 0, "no HMMA instruction in flash_tf32x3's SASS"
    chunked_t200 = chunked_route_checks()
    emit("flash_checks", {
        "seconds": time.perf_counter() - t0, "cases": f_cases,
        "max_abs_err": f_worst, "shapes": f_shapes, "f32_shapes": f32_shapes,
        "tc_narrow_shapes": tc_narrow,
        "flash_tc_ptxas": tc_ptxas or "not measured (library not rebuilt)",
        "flash_tf32x3_ptxas": tf_ptxas
        or "not measured (library not rebuilt)",
        "flash_tc_hgmma": hgmma, "flash_tc_hgmma_by_d": hgmma_by_d,
        "flash_tf32x3_hmma": hmma,
        "cuobjdump": cuobjdump, "chunked_t200": chunked_t200,
        "tolerance": "f32: |err| <= 2e-5 + 2e-5*|plain| (the reference's "
                     "kernel test bound); bf16: one bf16 ulp of the value "
                     "(or 2e-5 if larger) — both round an f32 result"})
    t0 = time.perf_counter()
    bwd_cases, bwd_worst = flash_bwd_matrix(args.quick)
    bwd_shapes = flash_bwd_shapes(3 if args.quick else 8)
    t_split = time.perf_counter()
    split_ptxas = ptxas_facts(built["logs"].get("flash_tf32x3_bwd", ""), "",
                              r"(split_bwd_prep|split_bwd|split_kv|"
                              r"flash_tf32x3_bwd_prep|flash_tf32x3_bwd)"
                              r"_kernel(?:ILi(\d+)E|E)")
    if "flash_tf32x3_bwd" in built["built"]:
        assert split_ptxas and all(
            f["spill_stores"] == 0 and f["spill_loads"] == 0
            for key, f in split_ptxas.items()
            if str(key).startswith("split_bwd/")), split_ptxas
    split_cases, split_worst = tf32x3_bwd_matrix(args.quick)
    split_shapes = tf32x3_bwd_shapes(
        3 if args.quick else 8,
        split_ptxas or "not measured (library not rebuilt)")
    t_split = time.perf_counter() - t_split
    bwd_ptxas = ptxas_facts(built["logs"].get("flash_tc_bwd", ""),
                            "flash_bwd_",
                            r"(wgmma_split|wgmma|prep|dq_cast)_kernel"
                            r"(?:ILi(\d+)E|E)")
    if "flash_tc_bwd" in built["built"]:
        assert bwd_ptxas and all(
            f["spill_stores"] == 0 and f["spill_loads"] == 0
            for f in bwd_ptxas.values()), bwd_ptxas
    emit("flash_bwd_checks", {
        "seconds": time.perf_counter() - t0, "cases": bwd_cases,
        "worst": bwd_worst, "shapes": bwd_shapes,
        "flash_tc_bwd_ptxas": bwd_ptxas
        or "not measured (library not rebuilt)",
        "tf32x3_bwd": {
            "seconds": t_split, "cases": split_cases, "worst": split_worst,
            "shapes": split_shapes, "ptxas": split_ptxas
            or "not measured (library not rebuilt)",
            "kernels": "D 16-128: split_bwd_prep, split_kv, split_bwd "
                       "(wgmma, three bf16 pieces); D 256: "
                       "flash_tf32x3_bwd_prep, flash_tf32x3_bwd (mma.sync)",
            "tolerance": "f32 only: each of dq, dk, dv max |kernel - "
                         "plain| <= 1e-4 x max |plain| and rel L2 <= 1e-4 "
                         "(at W = 1 dq, dk <= 1e-4 x max |plain dv|); lse "
                         "as B5-bwd's; dq_repeat_max_abs reported, not "
                         "gated"},
        "tolerance": "each of dq, dk, dv: max |kernel - plain| <= 2^-6 x "
                     "max |plain| and rel L2 <= 2^-7 (plain in f32 from the "
                     "same bf16 inputs); lse within 2^-14 x (1 + |plain|); "
                     "at W = 1 dq and dk against their exact 0: max |kernel| "
                     "<= 2^-6 x max |plain dv|; dq_repeat_max_abs (two calls "
                     "on the same inputs) is reported, not gated"})
    t0 = time.perf_counter()
    lm = lm_phase(args, paths)
    lm["seconds"] = time.perf_counter() - t0
    emit("lm", lm)
    t0 = time.perf_counter()
    lm_train = lm_train_phase(args, paths)
    lm_train["seconds"] = time.perf_counter() - t0
    emit("lm_train", lm_train)
    t0 = time.perf_counter()
    lm_train_res = lm_train_resilient_phase(args, paths)
    lm_train_res["seconds"] = time.perf_counter() - t0
    emit("lm_train_resilient", lm_train_res)
    t0 = time.perf_counter()
    lm_train_xl = lm_train_xlstm_phase(args, paths)
    lm_train_xl["seconds"] = time.perf_counter() - t0
    emit("lm_train_xlstm", lm_train_xl)
    t0 = time.perf_counter()
    lm_train_rg = lm_train_recurrentgemma_phase(args, paths)
    lm_train_rg["seconds"] = time.perf_counter() - t0
    emit("lm_train_recurrentgemma", lm_train_rg)
    t0 = time.perf_counter()
    lm_train_sl = lm_train_stablelm_phase(args, paths)
    lm_train_sl["seconds"] = time.perf_counter() - t0
    emit("lm_train_stablelm", lm_train_sl)

    # ---- 2b. B6-B8 vs their plain versions; the MoE and recurrent
    # model families ----
    t0 = time.perf_counter()
    probe = slstm_exchange_probe(args.quick)
    probe["seconds"] = time.perf_counter() - t0
    emit("slstm_exchange", probe)
    t0 = time.perf_counter()
    rec_checks = recurrent_checks(args.quick, built)
    emit("recurrent_checks", dict(
        rec_checks, seconds=time.perf_counter() - t0,
        tolerance=f"f32 outputs: max |kernel - plain| <= {REC_TOL} x max "
                  f"|plain| of that output; bf16 outputs: one bf16 ulp of "
                  f"the value more"))
    t0 = time.perf_counter()
    rec_bwd = recurrent_bwd_checks(args.quick, built,
                                   probe["bwd_floor_us_per_step"])
    emit("recurrent_bwd_checks", dict(
        rec_bwd, seconds=time.perf_counter() - t0,
        tolerance=f"B7-bwd, B8-bwd: each gradient tensor: max |kernel - "
                  f"plain| <= {BWD_REC_TOL} x max |plain| of that tensor "
                  f"(f32 on both sides); bf16 outputs one bf16 ulp more. "
                  f"B6-bwd: {REC_TOL} x max |plain| per gradient tensor, "
                  f"one bf16 ulp of the value more for a bf16 output; its "
                  f"forward's training launch (y, h_last, each tile's "
                  f"inclusive h) within {REC_TOL} x max |plain|"))
    t0 = time.perf_counter()
    lm_moe = lm_moe_phase(args, paths)
    lm_moe["seconds"] = time.perf_counter() - t0
    emit("lm_moe", lm_moe)
    t0 = time.perf_counter()
    lm_rec = lm_recurrent_phase(args, paths)
    lm_rec["seconds"] = time.perf_counter() - t0
    emit("lm_recurrent", lm_rec)

    rng = np.random.default_rng(args.seed)
    genome = random_genome(4_000_000, seed=args.seed + 1)
    n_short, n_mid, n_long = (4096, 64, 64) if args.quick \
        else (65536, 2048, 256)
    short = bulk_pairs(genome, n_short, 150, "illumina", rng)
    # Reference windows sized so that every PacBio-profile read (about
    # 4.5 % longer than its window) stays inside the 2048 / 8192 bucket.
    mid = bulk_pairs(genome, n_mid, 1900, "pacbio", rng)
    long_ = bulk_pairs(genome, n_long, 7680, "pacbio", rng)
    t0 = time.perf_counter()
    index = MinimizerIndex(genome, k=13, w=8)
    index_seconds = time.perf_counter() - t0
    params = chain_mod.ChainParams(k=index.k)
    sim_ill = ReadSimulator(genome, "illumina", seed=args.seed + 3,
                            rc_prob=0.5)
    sim_pb = ReadSimulator(genome, "pacbio", seed=args.seed + 4,
                           rc_prob=0.5)
    n_ill, n_pb = (512, 64) if args.quick else (16384, 1024)
    ill = [sim_ill.sample(150) for _ in range(n_ill)]
    pb = [sim_pb.sample(1000) for _ in range(n_pb)]

    # ---- 3. alignment kernels vs plain versions ----
    t0 = time.perf_counter()
    cases, retired, worst_wf, worst_wk, bodies = kernel_matrix(*short,
                                                               args.quick)
    # One slice per bucket class the main paths launch (PERF.md ranks the
    # redesigns by launches x (ms - bound) per class); the 300 bp pairs of
    # the serve phase from a generator of their own, so that the streams
    # below stay as they were.
    bp300 = bulk_pairs(genome, 64, 300, "illumina",
                       np.random.default_rng(args.seed + 7))
    # The plain versions take PLAIN_ROWS rows of the mid and long slices
    # (each took them 9-56 s on all 64 rows).
    shapes = [("short_4096", short, 4096, 20, None),
              ("short_64", short, 64, 20, None),
              ("bp300_64", bp300, 64, 20, None),
              ("mid_64", mid, 64, 5, PLAIN_ROWS),
              ("long_64", long_, 64, 3, PLAIN_ROWS)]
    wf_shapes, wk_shapes = [], []
    for name, (reads, refs), cap, reps, p_rows in shapes:
        spec, q, r, n, m = padded_group(reads[:cap], refs[:cap], cap)
        wf, wk = shape_timing(name, spec, q, r, n, m, reps, p_rows)
        wf_shapes.append(wf)
        wk_shapes.append(wk)
        worst_wf = max(worst_wf, wf["max_abs_err"])
        worst_wk = max(worst_wk, wk["max_abs_err"])
    cases += len(shapes)
    p_cases, worst_p, worst_pt, p_bodies = persistent_matrix(*short,
                                                             args.quick)
    mix = [a[:64] + b[:64] + c[:8] for a, b, c in zip(short, mid, long_)]
    p_recs, pt_recs = [], []
    for name, (reads, refs), reps, p_rows in (
            ("short_64", [x[:64] for x in short], 20, None),
            ("mid_64", [x[:64] for x in mid], 5, PLAIN_ROWS),
            ("mix_64_64_8", mix, 3, PLAIN_ROWS)):
        table, (q, r, n, m) = on_card(persistent_groups(reads, refs))
        p_rec, pt_rec = persistent_timing(name, table, q, r, n, m, reps,
                                          plain_rows=p_rows)
        p_recs.append(p_rec)
        pt_recs.append(pt_rec)
        worst_p = max(worst_p, p_rec["max_abs_err"])
        worst_pt = max(worst_pt, pt_rec["max_abs_err"])
        p_cases += 1
    p_mix, pt_mix = p_recs[-1], pt_recs[-1]
    logs = built["logs"]
    ptxas = {
        "banded_dp_warp": ptxas_facts(
            logs.get("banded_dp", ""), "wavefront_warp_kernel",
            r"ILi(\d+)E"),
        "persistent_warp": ptxas_facts(
            logs.get("persistent", ""), "persistent_warp_kernel",
            r"I(Lb\dELb\dELb\dELb\d)E"),
        "traceback": ptxas_facts(logs.get("traceback", ""), "",
                                 r"\d(traceback(?:_table)?_kernel)E")}
    for name in ("persistent_warp", "traceback"):
        assert all(f["spill_stores"] == 0 and f["spill_loads"] == 0
                   for f in ptxas[name].values()), ptxas[name]
    emit("kernel_checks", {
        "seconds": time.perf_counter() - t0,
        "xdrop_retired_pairs": retired, "matrix_cases_by_body": bodies,
        "persistent_matrix_cases_by_body": p_bodies,
        "ptxas": {k: v or "not measured (library not rebuilt)"
                  for k, v in ptxas.items()},
        "kernels": [
            {"name": "banded_dp", "cases": cases, "equal": True,
             "kernel_ms": wf_shapes[-1]["ms"],
             "plain_ms": wf_shapes[-1]["plain_ms"], "shapes": wf_shapes},
            {"name": "traceback", "cases": cases, "equal": True,
             "kernel_ms": wk_shapes[-1]["ms"],
             "plain_ms": wk_shapes[-1]["plain_ms"], "shapes": wk_shapes},
            {"name": "persistent", "cases": p_cases, "equal": True,
             "shapes": p_recs},
            {"name": "traceback_table", "cases": p_cases, "equal": True,
             "shapes": pt_recs},
        ]})

    # ---- 4. engine: one ragged request, then the short class again ----
    reads = short[0] + mid[0] + long_[0]
    refs = short[1] + mid[1] + long_[1]
    with paths.path("engine"):
        eng64 = AlignmentEngine(backend="auto")           # capacity 64
        eng4k = AlignmentEngine(backend="auto", capacity=4096)
        assert eng64.backend_name == "cuda" and eng64.device.type == "cuda"
        eng64.warmup([(150, 150)], collect_tb=True)
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
            sc = cigar_score(out_s["cigars"][p], short[0][p], short[1][p],
                             MINIMAP2)
            assert sc == int(out_s["score"][p]), \
                (p, sc, int(out_s["score"][p]))
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
                    "counts": paths.paths["engine"]})

    # ---- 5. the same request through persistent dispatch ----
    with paths.path("engine_persistent"):
        engp = AlignmentEngine(backend="auto", dispatch="persistent")
        engp.warmup([(150, 150)], collect_tb=True)
        out_p, rec_p = timed_align(engp, reads, refs, "global",
                                   "ragged request, persistent")
        launches = rec_p["launches"]
        assert launches["persistent"] == 1, launches
        assert launches["traceback_table"] == 1, launches
        assert launches["banded_dp"] == 0 and launches["traceback"] == 0, \
            launches
        for key in ("score", "final_lo", "best_score", "best_i", "best_j",
                    "status", "band"):
            assert np.array_equal(out_p[key], out_all[key]), key
        assert out_p["cigars"] == out_all["cigars"]
        st: dict = {}
        engp.finalize_persistent(
            engp.enqueue_persistent(reads, refs, collect_tb=True), stats=st)
        p_traces = {
            "ragged": device_trace(lambda: engp.align(
                reads, refs, collect_tb=True)),
            "short_16384": device_trace(lambda: engp.align(
                short[0][:16384], short[1][:16384], collect_tb=True)),
            "long_256": device_trace(lambda: engp.align(
                *long_, collect_tb=True))}
    # The pipelined request once more, after the persistent one, for the
    # spread of the host clock within this run.
    with paths.path("engine_again"):
        _, rec_again = timed_align(eng64, reads, refs, "global",
                                   "ragged request, pipelined again")
    emit("engine_persistent", {
        "run": rec_p, "pipelined_again": rec_again,
        "equal_to_pipelined": True,
        "fetched_bytes_per_pair": st["fetched_bytes"] / len(reads),
        "traces": p_traces, "counts": paths.paths["engine_persistent"]})

    # ---- 5b. the sharded engine over the cards' mesh; the roofline ----
    mesh = mesh_phase(paths, reads, refs, out_all, short, eng64)
    emit("mesh", mesh)
    emit("dryrun", dryrun_phase(lm_train, lm_train_xl, mesh))
    emit("roofline", roofline_phase(reads, refs, eng64, runs[0], rec_p,
                                    eng64.num_shards))

    # ---- 6. serve: closed loop, pipelined then persistent ----
    n_req, n_req_mid = (2048, 32) if args.quick else (32768, 512)
    mix150 = bulk_pairs(genome, n_req // 2, 150, "illumina", rng)
    mix300 = bulk_pairs(genome, n_req // 2, 300, "illumina", rng)
    s_reads = [x for pair in zip(mix150[0], mix300[0]) for x in pair] \
        + mid[0][:n_req_mid]
    s_refs = [x for pair in zip(mix150[1], mix300[1]) for x in pair] \
        + mid[1][:n_req_mid]
    one_shot = eng4k.align(s_reads, s_refs, collect_tb=True)
    for name, engine in (("serve", eng64), ("serve_persistent", engp)):
        with paths.path(name):
            results, svc_stats, serve_s = serve_run(engine, s_reads, s_refs)
        check_served(results, one_shot)
        emit(name, {"requests": len(results), "seconds": serve_s,
                    "requests_per_s": len(results) / serve_s,
                    "launches": paths.paths[name], "stats": svc_stats})

    # ---- 7. the replicated tier: two replicas against one service ----
    n_rt, n_rt_mid = (1024, 32) if args.quick else (8192, 256)
    t0 = time.perf_counter()
    router = router_phase(
        paths, s_reads[:n_rt - n_rt_mid] + s_reads[n_req:n_req + n_rt_mid],
        s_refs[:n_rt - n_rt_mid] + s_refs[n_req:n_req + n_rt_mid])
    router["seconds"] = time.perf_counter() - t0
    emit("router", router)
    t0 = time.perf_counter()
    launchers = launcher_phase(paths, args.quick)
    launchers["seconds"] = time.perf_counter() - t0
    emit("launchers", launchers)

    # ---- 8. edit distance: CUDA backend vs plain, and vs Levenshtein ----
    n_ed, n_ed_mid = (512, 32) if args.quick else (4096, 256)
    t0 = time.perf_counter()
    edit = edit_distance_phase(paths, {
        "illumina_150": [x[:n_ed] for x in short],
        "pacbio_1900": [x[:n_ed_mid] for x in mid]})
    edit["seconds"] = time.perf_counter() - t0
    emit("edit_distance", edit)

    # ---- 9. read mapping: seed -> chain -> align ----
    classes = (("illumina", ill, None, 0.99), ("pacbio", pb, 64, 0.95))
    mapped, records = {}, []
    for dispatch in ("persistent", "pipelined"):
        for label, sims, bw, floor in classes:
            name = f"map_{dispatch}_{label}"
            st = {}
            with paths.path(name):
                res, svc_stats, wall = map_reads(index, sims, dispatch, bw,
                                                 st)
            rc = recall(sims, res)
            assert rc >= floor, (name, rc, floor)
            mapped[(dispatch, label)] = res
            records.append({
                "path": name, "reads": len(sims), "seconds": wall,
                "reads_per_s": len(sims) / wall, "recall": rc,
                "stage_seconds": st, "aligned": svc_stats["completed"],
                "p50_ms": svc_stats["p50_ms"], "p99_ms": svc_stats["p99_ms"],
                "launches": paths.paths[name]})
    for label, *_ in classes:
        assert mapped[("persistent", label)] \
            == mapped[("pipelined", label)], label
    chains = chain_checks(anchor_sets(index, [sr.read for sr in ill]),
                          anchor_sets(index, [sr.read for sr in pb]), params,
                          reps=3 if args.quick else 10)
    chain_ill, chain_pb = chains[:2]
    # B4's cost per run: each mapping path's launches at its set shape.
    chain_cost = sum(
        paths.paths[f"map_{d}_{label}"]["chain"] * (rec["ms"]
                                                     - rec["bound_ms"])
        for d in ("persistent", "pipelined")
        for label, rec in (("illumina", chain_ill), ("pacbio", chain_pb)))
    chain_ptxas = ptxas_facts(logs.get("chain", ""), "chain_kernel")
    assert all(f["spill_stores"] == 0 and f["spill_loads"] == 0
               for f in chain_ptxas.values()), chain_ptxas
    emit("map", {"genome": len(genome), "k": index.k, "w": index.w,
                 "minimizers": index.num_minimizers,
                 "index_seconds": index_seconds, "runs": records,
                 "persistent_equals_pipelined": True,
                 "chain_checks": chains,
                 "chain_cost_per_run_ms": chain_cost,
                 "chain_ptxas": chain_ptxas
                 or "not measured (library not rebuilt)"})

    # ---- 10. B2 and the table walker at the main paths' commonest tables -
    t0 = time.perf_counter()
    shape_counts = paths.shapes["persistent"]
    # The two commonest tables, held against plain, and the largest (the
    # whole ragged request), held kernel against kernel; their inputs
    # sampled in an untimed replay of the persistent paths (cheapest
    # first, until each shape has a sample; the Illumina mapping on a
    # quarter of its reads), so that the paths above ran unpatched.
    picks = [(key, True) for key, _ in shape_counts.most_common(2)]
    largest = max(shape_counts, key=lambda key: key[0] * key[1])
    if largest not in [key for key, _ in picks]:
        picks.append((largest, False))
    samples, replays_run = sample_tables(
        [key for key, _ in picks],
        [lambda: engp.align(reads, refs, collect_tb=True),
         lambda: map_reads(index, pb, "persistent", classes[1][2], {}),
         lambda: serve_run(engp, s_reads, s_refs),
         lambda: map_reads(index, ill[:len(ill) // 4], "persistent",
                           classes[0][2], {})])
    not_sampled = [f"{K}x{R}" for (K, R), _ in picks
                   if (K, R) not in samples]
    for (K, R), plain in picks:
        if (K, R) not in samples:
            continue
        count = shape_counts[(K, R)]
        table, q, r, n, m, mode, xdrop = samples[(K, R)]
        p_rec, pt_rec = persistent_timing(f"main_{K}x{R}", table, q, r, n,
                                          m, 20 if plain else 3, mode=mode,
                                          xdrop=xdrop, plain=plain)
        for rec in (p_rec, pt_rec):
            rec["main_path_launches"] = count
        p_recs.append(p_rec)
        pt_recs.append(pt_rec)
        worst_p = max(worst_p, p_rec["max_abs_err"])
        worst_pt = max(worst_pt, pt_rec["max_abs_err"])
    del samples
    emit("persistent_shapes", {
        "seconds": time.perf_counter() - t0,
        "launches_by_table_shape": {f"{K}x{R}": c for (K, R), c
                                    in shape_counts.most_common()},
        "replays_run": replays_run, "not_sampled": not_sampled,
        "persistent": p_recs[3:], "traceback_table": pt_recs[3:]})

    # ---- 11. the main paths went through the kernels ----
    tot = paths.total
    common = {"route": "cuda", "library_ms": None}
    wf, wk = wf_shapes[-1], wk_shapes[-1]
    kernels = [
        dict(common, name="banded_dp",
             source="src/repro_torch/kernels/banded_dp/csrc/banded_dp.cu",
             replaces="src/repro/kernels/banded_dp/banded_dp.py:432",
             launches=tot("banded_dp"), max_abs_err=worst_wf,
             launches_by_class=paths.by_class("banded_dp"),
             ms=wf["ms"], plain_ms=wf["plain_ms"], bound_ms=wf["bound_ms"],
             bound_by=wf["bound_by"], shape=wf["shape"],
             block_ms=wf["block_ms"],
             ms_by_shape={x["shape"]: x["ms"] for x in wf_shapes},
             block_ms_by_shape={x["shape"]: x["block_ms"]
                                for x in wf_shapes},
             bound_ms_by_shape={x["shape"]: x["bound_ms"]
                                for x in wf_shapes}),
        dict(common, name="traceback",
             source="src/repro_torch/core/csrc/traceback.cu",
             replaces="src/repro/core/traceback_device.py:43",
             launches=tot("traceback", "traceback_table"),
             launches_by_class=paths.by_class("traceback"),
             max_abs_err=max(worst_wk, worst_pt),
             ms=wk["ms"], plain_ms=wk["plain_ms"], bound_ms=wk["bound_ms"],
             bound_by=wk["bound_by"], shape=wk["shape"],
             ms_by_shape={x["shape"]: x["ms"] for x in wk_shapes},
             bound_ms_by_shape={x["shape"]: x["bound_ms"]
                                for x in wk_shapes},
             table_launches=tot("traceback_table"), table_ms=pt_mix["ms"],
             table_plain_ms=pt_mix["plain_ms"],
             table_bound_ms=pt_mix["bound_ms"],
             table_shape=pt_mix["shape"],
             table_ms_by_shape={x["shape"]: x["ms"] for x in pt_recs},
             table_held_against={x["shape"]: x["held_against"]
                                 for x in pt_recs},
             table_launches_by_class=paths.by_class("traceback_table")),
        dict(common, name="persistent",
             source="src/repro_torch/kernels/banded_dp/csrc/persistent.cu",
             replaces="src/repro/kernels/banded_dp/persistent.py:402",
             launches=tot("persistent"), max_abs_err=worst_p,
             launches_by_class=paths.by_class("persistent"),
             launches_by_body=dict(paths.kinds["persistent"]),
             ms=p_mix["ms"], plain_ms=p_mix["plain_ms"],
             bound_ms=p_mix["bound_ms"], bound_by=p_mix["bound_by"],
             shape=p_mix["shape"], block_ms=p_mix["block_ms"],
             ms_by_shape={x["shape"]: x["ms"] for x in p_recs},
             block_ms_by_shape={x["shape"]: x["block_ms"] for x in p_recs},
             bound_ms_by_shape={x["shape"]: x["bound_ms"] for x in p_recs}),
        dict(common, name="chain",
             source="src/repro_torch/map/csrc/chain.cu",
             replaces="src/repro/map/chain.py:101",
             launches=tot("chain"),
             max_abs_err=max(c["max_abs_err"] for c in chains),
             ms=chain_ill["ms"], plain_ms=chain_ill["plain_ms"],
             bound_ms=chain_ill["bound_ms"],
             bound_by=chain_ill["bound_by"], shape=chain_ill["shape"],
             ms_by_shape={c["shape"]: c["ms"] for c in chains if "ms" in c},
             bound_ms_by_shape={c["shape"]: c["bound_ms"] for c in chains
                                if "ms" in c},
             plain_ms_by_shape={c["shape"]: c["plain_ms"] for c in chains},
             live_slots=chain_ill["live_slots"],
             cost_per_run_ms=chain_cost),
    ]
    for k in kernels:
        assert k["launches"] > 0 and k["max_abs_err"] == 0, k
    # Every B1 and B2 launch of the main paths ran the warp body (bands
    # <= 100).
    for key, kind in (("banded_dp", "warp"), ("persistent", "warp")):
        got = paths.kinds[key]
        assert got[kind] == tot(key) and sum(got.values()) == tot(key), \
            (key, got)
    kernels[0]["launches_by_body"] = dict(paths.kinds["banded_dp"])
    loc, glob = f_shapes
    floc, fglob = f32_shapes
    d80, d80_lse, d16 = tc_narrow

    def lib_ms(rec):
        return rec["library_ms"] if isinstance(rec["library_ms"], float) \
            else None
    b5 = dict(common,
              replaces="src/repro/kernels/local_attention/local_attention.py"
                       ":136",
              tolerance="one bf16 ulp of the value (bf16); 2e-5 + 2e-5*|x| "
                        "(f32)")
    kernels.append(dict(
        b5, name="flash_tc",
        source="src/repro_torch/kernels/local_attention/csrc/flash_tc.cu",
        launches=tot("flash_tc"),
        max_abs_err=max(f_worst["tc/bfloat16"], loc["max_abs_err"],
                        glob["max_abs_err"],
                        *(r["max_abs_err"] for r in tc_narrow)),
        within_tolerance=all(r["within_tolerance"]
                             for r in (loc, glob, *tc_narrow)),
        ms=glob["ms"], plain_ms=glob["plain_ms"], bound_ms=glob["bound_ms"],
        bound_by=glob["bound_by"], library_ms=lib_ms(glob),
        library=glob["library"], shape=glob["shape"],
        tflop_per_s=glob["tflop_per_s"], fma_ms=glob["fma_ms"],
        local_ms=loc["ms"], local_fma_ms=loc["fma_ms"],
        local_plain_ms=loc["plain_ms"], local_bound_ms=loc["bound_ms"],
        local_library_ms=loc["library_ms"], local_library=loc["library"],
        d80_shape=d80["shape"], d80_ms=d80["ms"],
        d80_plain_ms=d80["plain_ms"], d80_bound_ms=d80["bound_ms"],
        d80_library_ms=lib_ms(d80), d80_library=d80["library"],
        d80_fma_ms=d80["fma_ms"], d80_with_lse_shape=d80_lse["shape"],
        d80_with_lse_ms=d80_lse["ms"],
        d80_with_lse_bound_ms=d80_lse["bound_ms"],
        d80_with_lse_library_ms=lib_ms(d80_lse),
        d80_with_lse_library=d80_lse["library"],
        d80_with_lse_lse_err=d80_lse["lse_err"], d16_ms=d16["ms"],
        d16_bound_ms=d16["bound_ms"], d16_library_ms=lib_ms(d16),
        ptxas=tc_ptxas or "not measured (library not rebuilt)",
        hgmma=hgmma, hgmma_by_d=hgmma_by_d))
    kernels.append(dict(
        b5, name="flash_tf32x3",
        source="src/repro_torch/kernels/local_attention/csrc/"
               "flash_tf32x3.cu",
        launches=tot("flash_tf32x3"),
        max_abs_err=max([v for key, v in f_worst.items()
                         if key.startswith("tf32x3/")]
                        + [r["max_abs_err"] for r in f32_shapes]),
        within_tolerance=all(r["within_tolerance"] for r in f32_shapes),
        ms=fglob["ms"], plain_ms=fglob["plain_ms"],
        bound_ms=fglob["bound_ms"], bound_by=fglob["bound_by"],
        split_bound_ms=fglob["split_bound_ms"],
        fma_bound_ms=fglob["fma_bound_ms"], library_ms=lib_ms(fglob),
        library=fglob["library"], shape=fglob["shape"],
        tflop_per_s=fglob["tflop_per_s"], fma_ms=fglob["fma_ms"],
        local_ms=floc["ms"], local_fma_ms=floc["fma_ms"],
        local_plain_ms=floc["plain_ms"], local_bound_ms=floc["bound_ms"],
        local_split_bound_ms=floc["split_bound_ms"],
        local_library_ms=floc["library_ms"], hmma=hmma))
    # The FMA kernel (csrc/local_attention.cu) is on no route any more: not
    # a kernel of the main paths, so not in this line; it is held against
    # plain above (matrix and shapes) and its times sit beside the
    # split-TF32 kernel's ("fma_*").
    fma_worst = max([v for key, v in f_worst.items() if key.startswith("fma/")]
                    + [r["fma_max_abs_err"]
                       for r in (*f32_shapes, loc, glob, d80, d16)])
    kernels[-1].update(fma_max_abs_err=fma_worst,
                       fma_launches=tot("flash_fma"),
                       fma_bf16_d80_ms=d80["fma_ms"],
                       fma_bf16_32k_ms=glob["fma_ms"],
                       fma_bf16_32k_local_ms=loc["fma_ms"])
    assert tot("flash_fma") == 0, "a main path launched the FMA kernel"
    qwen3_bwd, local_bwd, sl_bwd = bwd_shapes
    kernels.append(dict(
        b5, name="flash_tc_bwd",
        source="src/repro_torch/kernels/local_attention/csrc/"
               "flash_tc_bwd.cu",
        tolerance="dq, dk, dv each: max |err| <= 2^-6 x max |plain|, rel "
                  "L2 <= 2^-7",
        launches=tot("flash_tc_bwd"),
        max_abs_err=max(e["max_abs_err"] for r in bwd_shapes
                        for e in r["errs"].values()),
        worst_max_share=max(bwd_worst[x] for x in ("dq", "dk", "dv")),
        worst_rel_l2=bwd_worst["rel_l2"],
        dq_repeat_max_abs=max(bwd_worst["dq_repeat_max_abs"],
                              *(r["dq_repeat_max_abs"] for r in bwd_shapes)),
        within_tolerance=all(r["within_tolerance"] for r in bwd_shapes),
        ms=qwen3_bwd["ms"], plain_ms=qwen3_bwd["plain_ms"],
        bound_ms=qwen3_bwd["bound_ms"], bound_by=qwen3_bwd["bound_by"],
        library_ms=lib_ms(qwen3_bwd), library=qwen3_bwd["library"],
        shape=qwen3_bwd["shape"], tflop_per_s=qwen3_bwd["tflop_per_s"],
        local_ms=local_bwd["ms"], local_plain_ms=local_bwd["plain_ms"],
        local_bound_ms=local_bwd["bound_ms"],
        local_library_ms=local_bwd["library_ms"],
        local_library=local_bwd["library"],
        d80_shape=sl_bwd["shape"], d80_ms=sl_bwd["ms"],
        d80_plain_ms=sl_bwd["plain_ms"], d80_bound_ms=sl_bwd["bound_ms"],
        d80_library_ms=lib_ms(sl_bwd), d80_library=sl_bwd["library"],
        d80_tflop_per_s=sl_bwd["tflop_per_s"],
        d80_fwd_with_lse_ms=sl_bwd["fwd_with_lse_ms"],
        train_trace=lm_train["trace"].get("by_kernel", "not measured"),
        stablelm_train_trace=lm_train_sl["trace"].get("by_kernel",
                                                      "not measured")))
    f32_bwd, = split_shapes
    kernels.append(dict(
        b5, name="flash_tf32x3_bwd",
        source="src/repro_torch/kernels/local_attention/csrc/"
               "flash_tf32x3_bwd.cu",
        tolerance="f32: dq, dk, dv each max |err| <= 1e-4 x max |plain|, "
                  "rel L2 1e-4",
        launches=tot("flash_tf32x3_bwd"),
        mma_sync_launches=tot("flash_tf32x3_bwd_mma_sync"),
        design="wgmma on three bf16 pieces a f32 operand (D 16-128); "
               "mma.sync on tf32 hi + lo at D 256",
        max_abs_err=max(max(w["max_abs_err"] for w in split_worst.values()),
                        *(e["max_abs_err"] for r in split_shapes
                          for e in r["errs"].values())),
        worst=split_worst,
        dq_repeat_max_abs=max(
            *(w["dq_repeat_max_abs"] for w in split_worst.values()),
            *(r["dq_repeat_max_abs"] for r in split_shapes)),
        within_tolerance=all(r["within_tolerance"] for r in split_shapes),
        ms=f32_bwd["ms"], plain_ms=f32_bwd["plain_ms"],
        bound_ms=f32_bwd["bound_ms"], bound_by=f32_bwd["bound_by"],
        library_ms=lib_ms(f32_bwd), library=f32_bwd["library"],
        shape=f32_bwd["shape"], tflop_per_s=f32_bwd["tflop_per_s"],
        fwd_with_lse_ms=f32_bwd["fwd_with_lse_ms"],
        fwd_serving_ms=f32_bwd["fwd_serving_ms"],
        ptxas=split_ptxas or "not measured (library not rebuilt)",
        f32_grads_launches=lm_train["f32_grad_check"]["launches"]))
    for k in kernels[-4:]:
        assert k["launches"] > 0 and k["within_tolerance"], k
    rec_common = dict(common, tolerance=f"{REC_TOL} x max |plain| per f32 "
                      f"output; one bf16 ulp more for bf16")
    def rec_entry(name, src, replaces, recs, **extra):
        main_rec = recs[0]
        return dict(
            rec_common, name=name,
            source=f"src/repro_torch/models/csrc/{src}", replaces=replaces,
            launches=tot(name), shape=main_rec["shape"] + ": " + ", ".join(
                f"{k_}={main_rec[k_]}" for k_ in ("B", "T", "H", "D", "Dh",
                                                  "dtype", "chunk")
                if k_ in main_rec),
            ragged_shapes=[r["shape"] for r in recs[1:]], **extra)
    b6 = rec_checks["rglru_scan"]
    rg_prefill = lm_rec["recurrentgemma"]["prefill"]
    kernels.append(rec_entry(
        "rglru_scan", "rglru_scan.cu", "src/repro/models/rglru.py:51", b6,
        max_abs_err=max(r["max_abs_err"] for r in b6),
        within_tolerance=all(r["within_tolerance"] for r in b6),
        ms=b6[0]["ms"], plain_ms=b6[0]["plain_ms"],
        bound_ms=b6[0]["bound_ms"], bound_by=b6[0]["bound_by"],
        sfu_floor_ms=b6[0]["sfu_floor_ms"], tile=b6[0]["tile"],
        long_memory_ms=b6[3]["ms"],
        in_context=rec_checks["rglru_in_context"],
        launches_per_recurrentgemma_prefill=rg_prefill["launches"][
            "rglru_scan"],
        recurrentgemma_prefill_trace=rg_prefill["trace"].get(
            "by_kernel", "not measured")))
    # B7: one entry per pass kernel; the whole (three launches) beside the
    # first pass.
    b7 = rec_checks["mlstm_chunk"]
    main7 = b7[0]
    whole7 = {key: main7[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "fma_bound_ms",
        "scratch_bytes", "ptxas", "hgmma")}
    whole7.update(max_abs_err=max(r["max_abs_err"] for r in b7),
                  f64_witness_h=witness_summary(
                      rec_checks["mlstm_f64_witness"]))
    for i, key in enumerate(("mlstm_chunk_states", "mlstm_state_scan",
                             "mlstm_chunk_outputs")):
        pr = main7["passes"][key]
        kernels.append(rec_entry(
            key, "mlstm_chunk.cu", "src/repro/models/xlstm.py:117", b7,
            max_abs_err=max(r["passes"][key]["max_abs_err"] for r in b7),
            within_tolerance=all(r["passes"][key]["within_tolerance"]
                                 for r in b7),
            ms=pr["ms"], plain_ms=pr["plain_ms"], bound_ms=pr["bound_ms"],
            bound_by=pr["bound_by"], fma_bound_ms=pr["fma_bound_ms"],
            **({"b7_whole": whole7} if i == 0 else {})))
    b8 = rec_checks["slstm"]
    main8, dec8 = b8[0], b8[-1]
    kernels.append(rec_entry(
        "slstm", "slstm.cu", "src/repro/models/xlstm.py:220", b8,
        max_abs_err=max(r["max_abs_err"] for r in b8),
        within_tolerance=all(r["within_tolerance"] for r in b8),
        ms=main8["ms"], plain_ms=main8["plain_ms"],
        bound_ms=main8["bound_ms"], bound_by=main8["bound_by"],
        latency_floor_ms=probe["floor_us_per_step"] * main8["T"] / 1e3,
        latency_floor_us_per_step=probe["floor_us_per_step"],
        us_per_step=main8["us_per_step"], cluster=main8["cluster"],
        decode_ms=dec8["ms"], decode_bound_ms=dec8["bound_ms"],
        decode_bound_by=dec8["bound_by"]))
    for k in kernels[-5:]:
        assert k["launches"] > 0 and k["within_tolerance"], k
    # B7-bwd: one entry per pass kernel, the whole (three launches) beside
    # the first pass; B8-bwd. Their launches come from lm_train_xlstm.
    bwd_common = dict(common, tolerance=f"{BWD_REC_TOL} x max |plain| per "
                      f"gradient tensor (f32)")
    xl_trace = lm_train_xl["trace"].get("by_kernel", "not measured")

    def shape_of(rec, keys):
        return rec["shape"] + ": " + ", ".join(f"{k_}={rec[k_]}"
                                               for k_ in keys)
    b7b = rec_bwd["mlstm_chunk_bwd"]
    main7b = b7b[0]
    whole7b = {key: main7b[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "fma_bound_ms",
        "forward_ms", "scratch_bytes")}
    whole7b.update(max_abs_err=max(r["max_abs_err"] for r in b7b),
                   rows_on_floor_branch={r["shape"]: r["rows_on_floor_branch"]
                                         for r in b7b},
                   ptxas=rec_bwd["ptxas"]["mlstm_chunk_bwd"],
                   train_trace=xl_trace)
    for i, key in enumerate(B7_BWD_PASSES):
        pr = main7b["passes"][key]
        kernels.append(dict(
            bwd_common, name=key,
            source="src/repro_torch/models/csrc/mlstm_chunk_bwd.cu",
            replaces="src/repro/models/xlstm.py:168", launches=tot(key),
            max_abs_err=max(r["passes"][key]["max_abs_err"] for r in b7b),
            within_tolerance=all(r["passes"][key]["within_tolerance"]
                                 and r["within_tolerance"] for r in b7b),
            ms=pr["ms"], plain_ms=pr["plain_ms"], bound_ms=pr["bound_ms"],
            bound_by=pr["bound_by"], fma_bound_ms=pr["fma_bound_ms"],
            shape=shape_of(main7b, ("B", "H", "T", "D", "chunk")),
            ragged_shapes=[r["shape"] for r in b7b[1:]],
            **({"b7_bwd_whole": whole7b} if i == 0 else {})))
    b8b = rec_bwd["slstm_bwd"]
    main8b = b8b[0]
    kernels.append(dict(
        bwd_common, name="slstm_bwd",
        source="src/repro_torch/models/csrc/slstm_bwd.cu",
        replaces="src/repro/models/xlstm.py:233", launches=tot("slstm_bwd"),
        max_abs_err=max(r["max_abs_err"] for r in b8b),
        within_tolerance=all(r["within_tolerance"] for r in b8b),
        ms=main8b["ms"], plain_ms=main8b["plain_ms"],
        bound_ms=main8b["bound_ms"], bound_by=main8b["bound_by"],
        shape=shape_of(main8b, ("B", "T", "H", "Dh", "dtype")),
        ragged_shapes=[r["shape"] for r in b8b[1:]],
        **{key: main8b[key] for key in (
            "us_per_step", "exchange_floor_us_per_step",
            "us_per_step_over_floor", "kernel_ms", "kernel_us_per_step",
            "kernel_us_per_step_over_floor", "kernel_bound_ms", "dr_ms",
            "max_active_clusters", "clusters", "forward_ms",
            "forward_saved_ms", "cluster")},
        exchange_floor_cluster=probe["bwd_floor_cluster"],
        exchange_split_us=probe["bwd_split_us"],
        max_flip={key: b8b[-1][key] for key in (
            "lsf_wins_share", "branch_flips", "max_abs_err")},
        ptxas=rec_bwd["ptxas"]["slstm_bwd"], train_trace=xl_trace))
    b6b = rec_bwd["rglru_scan_bwd"]
    main6b = b6b[0]
    kernels.append(dict(
        common, name="rglru_scan_bwd",
        source="src/repro_torch/models/csrc/rglru_scan_bwd.cu",
        replaces="src/repro/models/rglru.py:51",
        tolerance=f"{REC_TOL} x max |plain| per gradient tensor; one bf16 "
                  f"ulp of the value more for bf16",
        launches=tot("rglru_scan_bwd"),
        max_abs_err=max(r["max_abs_err"] for r in b6b),
        within_tolerance=all(r["within_tolerance"] for r in b6b),
        ms=main6b["ms"], plain_ms=main6b["plain_ms"],
        bound_ms=main6b["bound_ms"], bound_by=main6b["bound_by"],
        library_ms=None, sfu_floor_ms=main6b["sfu_floor_ms"],
        forward_ms=main6b["forward_ms"],
        dlam_repeat_max_abs=max(r["dlam_repeat_max_abs"] for r in b6b),
        shape=shape_of(main6b, ("B", "T", "D", "dtype")),
        ragged_shapes=[r["shape"] for r in b6b[1:]],
        ptxas=rec_bwd["ptxas"]["rglru_scan_bwd"],
        train_trace=lm_train_rg["trace"].get("by_kernel", "not measured")))
    for k in kernels[-5:]:
        assert k["launches"] > 0 and k["within_tolerance"], k
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", {"seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
