"""`repro_torch.launch.dryrun` against the JAX package's `launch/dryrun.py`,
and the work counts behind it.

The reference module sets XLA_FLAGS to 512 host devices when it is
imported, which would change every later JAX test of the worker (or do
nothing once JAX is up), so it is only ever imported in a subprocess, as
is the XLA compile its byte counts are held against. Tolerance: none —
plans, byte counts, FLOPs and kernel calls are integers and must be
equal.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import build, work
from repro_torch.kernels.local_attention import local_attention as la
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import rglru, xlstm
from repro_torch.roofline import analyze_record
from repro_torch.train.train_step import make_prefill_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
META = torch.device("meta")

#: The reference's train / prefill / decode steps of a reduced qwen3 on 8
#: host devices: `memory_analysis()`, and the donated leaves' per-device
#: bytes, those XLA aliased to an output and those it did not (its
#: sharding propagation may hand an output another sharding than the
#: donated input's, and then the two cannot share a buffer).
_XLA_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, re
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch import specs as S
from repro.launch.mesh import make_debug_mesh
from repro.sharding import batch_specs, cache_specs, param_specs
from repro.train.train_step import (make_prefill_step, make_serve_step,
                                    make_train_step)

def named(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))

def cell(cfg, shape, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    inputs = S.input_specs(cfg, shape)
    ib = batch_specs(inputs, mesh)
    if shape.kind == "train":
        nm = S.microbatches_for(cfg, shape, sizes["data"])
        assert nm == 1, nm
        state = S.abstract_state(cfg)
        st = {"params": param_specs(state["params"], mesh),
              "opt": {"m": param_specs(state["opt"]["m"], mesh),
                      "v": param_specs(state["opt"]["v"], mesh),
                      "step": P()}}
        shard = (named(mesh, st), named(mesh, ib))
        f = jax.jit(make_train_step(cfg, num_microbatches=nm),
                    in_shardings=shard, donate_argnums=(0,))
        args, donated = (state, inputs), 0
    elif shape.kind == "prefill":
        params = S.abstract_params(cfg)
        shard = (named(mesh, param_specs(params, mesh)), named(mesh, ib))
        f = jax.jit(make_prefill_step(cfg), in_shardings=shard)
        args, donated = (params, inputs), None
    else:
        params = S.abstract_params(cfg)
        cache = S.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        masked = (cfg.n_kv_heads % sizes.get("model", 1) != 0
                  or shape.global_batch == 1)
        shard = (named(mesh, param_specs(params, mesh)), named(mesh, ib),
                 named(mesh, cache_specs(cache, mesh,
                                         batch=shape.global_batch)))
        f = jax.jit(make_serve_step(cfg, masked_cache_write=masked),
                    in_shardings=shard, donate_argnums=(2,))
        args, donated = (params, inputs, cache), 2
    with mesh:
        compiled = f.lower(*args).compile()
    ma = compiled.memory_analysis()
    header = compiled.as_text().split("\n", 1)[0]
    aliased = {int(p) for p in re.findall(r"\}: \((\d+), \{\}", header)}
    number, donated_bytes, unaliased = 0, 0, 0
    for i, (tree, specs) in enumerate(zip(args, shard)):
        for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(specs)):
            n = 1
            for d in sh.shard_shape(leaf.shape):
                n *= d
            nbytes = n * leaf.dtype.itemsize
            if i == donated:
                donated_bytes += nbytes
                unaliased += 0 if number in aliased else nbytes
            number += 1
    return {"argument_size_in_bytes": ma.argument_size_in_bytes,
            "alias_size_in_bytes": ma.alias_size_in_bytes,
            "donated_bytes": donated_bytes, "unaliased_bytes": unaliased}

cfg = get_config("qwen3-0.6b").reduced()
out = {}
for kind, mesh in (("train", (2, 4)), ("prefill", (2, 4)),
                   ("decode", (2, 4)), ("train", (2, 2, 2))):
    m = make_debug_mesh(*mesh[-2:], pod=mesh[0] if len(mesh) == 3 else None)
    out[f"{kind}/{'x'.join(map(str, mesh))}"] = cell(
        cfg, ShapeSpec(kind, 64, 8, kind), m)
print(json.dumps(out))
"""

XLA_CELLS = ("train/2x4", "prefill/2x4", "decode/2x4", "train/2x2x2")


def _reference(code: str, timeout: float) -> str:
    return subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          check=True).stdout


def test_plan_is_the_references_in_order(capsys):
    """`plan()` and `--list` give the reference's 88 cells in its order,
    `long_500k` included (the skip is decided when a cell runs)."""
    ref = [tuple(c) for c in json.loads(_reference(
        "import json; from repro.launch.dryrun import plan; "
        "print(json.dumps(plan()))", 120))]
    assert len(ref) == 88
    assert dryrun.plan() == ref
    dryrun.main(["--list"])
    assert capsys.readouterr().out.splitlines() == ["%s %s %s" % c
                                                    for c in ref]


@pytest.fixture(scope="module")
def xla_memory():
    return json.loads(_reference(_XLA_SCRIPT, 300))


@pytest.mark.parametrize("cell", XLA_CELLS)
def test_argument_and_alias_bytes_match_xla(xla_memory, cell):
    """Per-device argument bytes equal XLA's `memory_analysis()` exactly;
    the port's alias bytes are every donated leaf's shard bytes, which is
    XLA's alias size plus the donated leaves XLA left unaliased (none in
    prefill and decode, where the two are equal)."""
    kind, mesh_s = cell.split("/")
    shape = tuple(int(x) for x in mesh_s.split("x"))
    mesh = make_debug_mesh(*shape[-2:], pod=shape[0] if len(shape) == 3
                           else None, device="cpu")
    rec = dryrun.lm_record(get_config("qwen3-0.6b").reduced(),
                           ShapeSpec(kind, 64, 8, kind), mesh)
    ref = xla_memory[cell]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == ref["argument_size_in_bytes"]
    assert mem["alias_size_in_bytes"] == ref["donated_bytes"]
    assert ref["alias_size_in_bytes"] \
        == ref["donated_bytes"] - ref["unaliased_bytes"]
    if kind != "train":
        assert mem["alias_size_in_bytes"] == ref["alias_size_in_bytes"]


def _one_layer():
    return dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               n_layers=1)


def _prefill_record(cfg, B, T):
    mesh = make_debug_mesh(1, 1, device="cpu")
    return dryrun.lm_record(cfg, ShapeSpec("prefill", T, B, "prefill"), mesh)


def test_prefill_flops_by_hand():
    """A reduced qwen3 prefill: 2 x the blocks' product parameters x
    tokens, the tied readout's 2 d V at the last position of each row,
    and B5's 4 D a live pair and q head a layer; nothing else (norms,
    RoPE, the embedding's gather are elementwise or gathers)."""
    cfg = get_config("qwen3-0.6b").reduced()
    B, T = 2, 64
    d, H, Hkv, D, f, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    per_layer = 2 * d * H * D + 2 * d * Hkv * D + 3 * d * f
    want = (2 * per_layer * cfg.n_layers * B * T + 2 * d * V * B
            + 4 * D * work.flash_live_pairs(B, H, T, None) * cfg.n_layers)
    rec = _prefill_record(cfg, B, T)
    assert rec["flops_per_device"] == want
    assert rec["counts"]["kernels"]["flash_tc"]["calls"] == cfg.n_layers


def test_one_layer_prefill_bytes_by_hand():
    """The bytes of a one-layer qwen3 prefill (B 2, T 32, H = Hkv), written
    down op by op from the model's code: each op's tensor arguments and
    results, views and bare allocations free, a broadcast argument once;
    B5's q, k, v read and o written."""
    cfg = _one_layer()
    B, T = 2, 32
    d, H, D, f, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                     cfg.vocab_size)
    assert cfg.n_kv_heads == H
    n, hd, h = B * T, H * D, D // 2

    def mm(M, K, N):                     # bf16 (M, K) @ (K, N)
        return 2 * (M * K + K * N + M * N)

    def rms(N, R, S):
        # to f32, x * x, mean, + eps, rsqrt, x * r, scale to f32, * scale,
        # back to bf16 (N elements in R rows, S scales).
        return 6 * N + 12 * N + (4 * N + 4 * R) + 8 * R + 8 * R \
            + (8 * N + 4 * R) + 6 * S + (8 * N + 4 * S) + 6 * N

    def rope():
        # four products with cos / sin (B, 1, T, h), a sub, an add, the
        # stack of the halves (bf16).
        return 4 * (4 * n * H * h + 2 * n * h) + 2 * 6 * n * H * h \
            + 8 * n * H * h

    params = V * d + d + d + 4 * d * hd + 2 * D + d + 3 * d * f
    want = (
        6 * params                                  # the params to bf16
        + 12 * n                                    # tokens to int64
        + 2 * V * d + 8 * n + 2 * n * d             # the embedding gather
        + 4 * T + 4 * h + 8 * h + 8 * h + 4 + 8 * h  # positions, inv freqs
        + 4 * T + 4 * n                             # positions to f32
        + (4 * n + 4 * h + 4 * n * h)               # angles
        + 2 * (8 * n * h + 6 * n * h)               # cos, sin in bf16
        + rms(n * d, n, d)                          # ln1
        + 3 * mm(n, d, hd)                          # q, k, v
        + 2 * rms(n * hd, n * H, D)                 # q_norm, k_norm
        + 2 * rope()                                # RoPE on q and k
        + 4 * n * hd                                # v made contiguous
        + 8 * n * hd                                # B5: q, k, v, o
        + 4 * n * hd + mm(n, hd, d)                 # o's layout, wo
        + 6 * n * d                                 # residual
        + rms(n * d, n, d)                          # ln2
        + 2 * mm(n, d, f) + 4 * n * f + 6 * n * f   # gate, up, silu, *
        + mm(n, f, d) + 6 * n * d                   # down, residual
        + rms(n * d, n, d)                          # final norm
        + 2 * (B * d + d * V + B * V)               # last row's readout
        + 6 * B * V)                                # logits to f32
    rec = _prefill_record(cfg, B, T)
    assert rec["bytes_accessed_per_device"] == want


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _counted(fn):
    with dryrun.StepCounter() as counter:
        out = fn()
    return out, counter.kernels


def _calls(kernels):
    return {k: v["calls"] for k, v in kernels.items()}


def test_attention_sites_take_the_kernel_route_on_meta():
    """B5 (bf16 and f32) and its backwards on meta tensors: the kernel
    route's outputs, its lse and scratch shapes, one reported call each
    with the kernel table's work, nothing launched or counted as a
    launch."""
    B, Hq, Hkv, T, D = 2, 4, 2, 256, 64
    for dtype, fwd, bwd in ((torch.bfloat16, "flash_tc", "flash_tc_bwd"),
                            (torch.float32, "flash_tf32x3",
                             "flash_tf32x3_bwd")):
        q = _meta(B, Hq, T, D, dtype=dtype).requires_grad_()
        k = _meta(B, Hkv, T, D, dtype=dtype).requires_grad_()
        v = _meta(B, Hkv, T, D, dtype=dtype).requires_grad_()
        before = (la.flash_attention_tc_cuda.launches,
                  la.flash_attention_tf32x3_cuda.launches)

        def run():
            out = la.flash_attention_cuda(q, k, v, window=100)
            return out, torch.autograd.grad(out.float().sum(), (q, k, v))
        (out, grads), kernels = _counted(run)
        assert out.shape == q.shape and out.dtype == dtype and out.is_meta
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
        assert _calls(kernels) == {fwd: 1, bwd: 1}
        itemsize = 2 if dtype == torch.bfloat16 else 4
        want = work.flash(B, Hq, Hkv, T, D, 100, itemsize)
        assert kernels[fwd]["ops"] == want.ops
        assert kernels[fwd]["bytes"] == want.nbytes
        assert kernels[bwd]["ops"] == work.flash_bwd(
            B, Hq, Hkv, T, D, 100, itemsize).ops
        assert (la.flash_attention_tc_cuda.launches,
                la.flash_attention_tf32x3_cuda.launches) == before
    with torch.no_grad():
        qb = _meta(B, Hq, T, D, dtype=torch.bfloat16)
        kb = _meta(B, Hkv, T, D, dtype=torch.bfloat16)
        out, lse = la._tc_forward(qb, kb, kb, None, True)
        assert lse.shape == (B, Hq, T) and lse.dtype == torch.float32
        with pytest.raises(ValueError, match="no route"):
            la.flash_attention_fma_cuda(qb, kb, kb)


def test_recurrent_sites_take_the_kernel_route_on_meta():
    """B6, B7 and B8 and their backwards on meta tensors, through the
    autograd Functions: the kernel route's outputs and scratch (B6's
    look-back scratch, B7's work / scal and dot_r, B8's per-step record),
    one reported call a kernel."""
    B, T, D = 2, 200, 300
    wa, wx, x = (_meta(B, T, D, dtype=torch.bfloat16).requires_grad_()
                 for _ in range(3))
    lam = _meta(D).requires_grad_()

    def b6():
        y, h = rglru.rglru_scan(wa, wx, x, lam)
        return y, torch.autograd.grad(y.float().sum(), (wa, wx, x, lam))
    (y, grads), kernels = _counted(b6)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert [g.shape for g in grads] == [x.shape] * 3 + [lam.shape]
    assert _calls(kernels) == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    _, _, scratch = rglru._forward_cuda(wa.detach(), wx.detach(), x.detach(),
                                        lam.detach(), None)
    assert scratch.shape == (rglru.scratch_bytes(B, T, D),)

    H, T7, D7, L = 2, 128, 32, 64
    q, k, v = (_meta(B, T7, H, D7).transpose(1, 2).requires_grad_()
               for _ in range(3))
    it, ft = (_meta(B, H, T7).requires_grad_() for _ in range(2))
    state = {"C": _meta(B, H, D7, D7), "n": _meta(B, H, D7),
             "m": _meta(B, H)}

    def b7():
        h, st = xlstm.mlstm_chunk_scan(q, k, v, it, ft, state, L)
        return h, st, torch.autograd.grad(h.sum(), (q, k, v, it, ft))
    (h, st, grads), kernels = _counted(b7)
    assert h.shape == (B, T7, H * D7) and st["C"].shape == (B, H, D7, D7)
    assert _calls(kernels) == {key: 1 for key in (
        "mlstm_chunk_states", "mlstm_state_scan", "mlstm_chunk_outputs",
        "mlstm_bwd_outputs", "mlstm_bwd_scan", "mlstm_bwd_inputs")}
    with torch.no_grad():
        work_, scal = xlstm.mlstm_chunk_states_cuda(k, v, it, ft, L)
        assert (tuple(work_.shape), tuple(scal.shape)) \
            == xlstm.mlstm_work_shapes(B, H, T7, D7, L)
        _, dot = xlstm.mlstm_chunk_outputs_cuda(q, k, v, it, ft, work_,
                                                scal, L, with_dot=True)
        assert dot.shape == (B, H, T7)

    H8, Dh = 2, 16
    wx8 = {g: _meta(B, T, H8 * Dh).requires_grad_() for g in "zifo"}
    r8 = {g: _meta(H8, Dh, Dh).requires_grad_() for g in "zifo"}
    st8 = {key: _meta(B, H8, Dh) for key in ("h", "c", "n", "m")}

    def b8():
        h, _ = xlstm.slstm_scan(wx8, r8, st8)
        return h, torch.autograd.grad(h.sum(), [*wx8.values(),
                                                *r8.values()])
    (h, grads), kernels = _counted(b8)
    assert h.shape == (B, T, H8 * Dh) and len(grads) == 8
    assert _calls(kernels) == {"slstm": 1, "slstm_bwd": 1}
    with torch.no_grad():
        _, _, saved = xlstm.slstm_scan_cuda(wx8, r8, st8, with_saved=True)
    assert saved.shape == (B, T, xlstm.SLSTM_SAVED, H8 * Dh)
    assert kernels["slstm_bwd"]["ops"] == work.slstm_bwd(
        B, T, H8, Dh, 4, xlstm.SLSTM_SAVED, False).ops


def test_a_cpu_tensor_still_raises_at_a_cuda_wrapper():
    """The meta route changes nothing for CPU tensors: each kernel
    wrapper handed one raises (the plain versions are the CPU's route)."""
    q = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        la.flash_attention_tc_cuda(q, q, q)
    x = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        rglru.rglru_scan_cuda(x, x, x, torch.zeros(16))
    k = torch.zeros(1, 2, 64, 16)
    g = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        xlstm.mlstm_chunk_states_cuda(k, k, g, g, 64)
    wx = {g_: torch.zeros(1, 4, 32) for g_ in "zifo"}
    r = {g_: torch.zeros(2, 16, 16) for g_ in "zifo"}
    st = {key: torch.zeros(1, 2, 16) for key in ("h", "c", "n", "m")}
    with pytest.raises(ValueError, match="CUDA"):
        xlstm.slstm_scan_cuda(wx, r, st)
    assert build.WORK is None


def test_counter_counts_an_op_once_and_restores_the_hook():
    """The counter's rule on a hand-sized program: a product's FLOPs and
    bytes, an elementwise op's bytes, a view and a bare allocation free,
    CPU-only ops ignored; the live-bytes peak; `build.WORK` set inside
    and put back."""
    a, b = _meta(4, 8), _meta(8, 16)
    with dryrun.StepCounter([a, b]) as c:
        assert build.WORK is c
        y = a @ b                                    # mm: 2 * 4 * 8 * 16
        z = (y + 1.0).view(64)                       # add; a view
        torch.empty(10, device=META)
        torch.zeros(3) + 1                           # CPU only
        del y
    assert build.WORK is None
    assert c.flops == 2 * 4 * 8 * 16
    assert c.aten_bytes == 4 * (32 + 128 + 64) + 4 * (64 + 64)
    assert c.peak == 4 * (64 + 64 + 10) and z.numel() == 64


def _production(arch):
    return [c for c in dryrun.plan([arch]) if c[0] == arch]


@pytest.mark.parametrize("cell", _production("qwen3-0.6b")
                         + _production("xlstm-125m"),
                         ids=lambda c: "/".join(c))
def test_production_cells_trace_ok(tmp_path, cell):
    """Every production cell of qwen3-0.6b and xlstm-125m traces ok (or is
    skipped as the reference skips it) on meta, within 120 s, and its
    record passes through `analyze_record`."""
    arch, shape, mesh = cell
    rec = dryrun.run_cell(arch, shape, mesh, skip_existing=False,
                          results_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["compile_seconds"] < 120
    if shape == "long_500k" and not get_config(arch).subquadratic:
        assert rec["skipped"]
        return
    out = analyze_record(rec)
    assert out["chips"] == (512 if mesh == "multipod" else 256)
    assert out["flops_per_device"] > 0 and out["bytes_per_device"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    kinds = set(rec["counts"]["kernels"])
    want = {"qwen3-0.6b": {"flash_tc"}, "xlstm-125m": {
        "mlstm_chunk_states", "mlstm_state_scan", "mlstm_chunk_outputs",
        "slstm"}}[arch]
    if SHAPES[shape].kind != "decode":
        assert want <= kinds
    if SHAPES[shape].kind == "train":
        assert {k + "_bwd" for k in ("flash_tc", "slstm")} & kinds \
            or "mlstm_bwd_inputs" in kinds


def test_alignment_cell_counts_b1_per_shard():
    """An alignment cell: 64 pairs a (pod, data) shard, B1's work on one
    shard at n = m = L, no collective."""
    rec = dryrun.alignment_record(dryrun.production_mesh("multipod"),
                                  "long_2k")
    assert rec["global_batch"] == 64 * 32
    w = work.wavefront(64 * 4096, rec["band"], 64, 2048, 2048, 4096, False)
    assert rec["flops_per_device"] == w.total_ops
    assert rec["bytes_accessed_per_device"] == w.nbytes
    assert rec["collectives"]["total_bytes"] == 0
    assert analyze_record(dict(rec, arch="rapidx-align", shape="long_2k",
                               mesh="multipod", mesh_shape=[2, 16, 16],
                               status="ok"))["chips"] == 512


def test_tracing_leaves_the_abstract_trees_abstract():
    """Tracing leaves the abstract trees abstract: nothing is allocated
    and the parameters stay on meta."""
    cfg = _one_layer()
    params = S.abstract_params(cfg)
    inputs = S.input_specs(cfg, ShapeSpec("prefill", 32, 2, "prefill"))
    with dryrun.StepCounter():
        logits = make_prefill_step(cfg)(params, inputs)
    assert logits.is_meta and logits.shape == (2, 1, cfg.vocab_size)
    assert all(t.is_meta for t in dryrun._leaves(params))
