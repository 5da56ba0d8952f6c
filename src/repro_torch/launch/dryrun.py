"""Multi-pod dry run: trace one step of every (arch x shape x mesh) cell
on the meta device — the port of the JAX package's `launch/dryrun.py`.

The reference lowers and compiles each cell's step on 512 XLA host
devices and reads the compiled program's memory and cost analyses and its
collectives. Eager PyTorch has no compile step; in its place, per cell
this driver:
  1. builds the abstract inputs, state, parameters or cache on the
     "meta" device (`launch.specs`: shapes and dtypes, nothing allocated)
     and resolves their specs from `sharding.rules` against an abstract
     mesh of the reference's shape (CPU entries, nothing placed);
  2. runs the port's own step on them (`make_train_step`,
     `make_prefill_step`, `make_serve_step`) under a `StepCounter`: every
     aten op of the step is seen once, its product FLOPs counted by
     `torch.utils.flop_counter`'s formulas and its bytes from its tensors;
     every kernel site takes the kernel's route (`build.kernel_side`) and
     reports its call's work by the kernel table's formula
     (`kernels.work`), launching nothing; the live bytes the step
     allocates are followed to their peak;
  3. records memory, FLOPs, bytes and the collective inventory the specs
     imply (`roofline.hlo_collectives.collective_bytes_from_specs`) in the
     reference's keys, with a `basis` naming where each figure comes from,
     into build/dryrun/<cell>.json.
No card is needed, as the reference needs no TPU: the same trace runs on
any host. The alignment cells count B1's work per shard by its formula
(`kernels.work.wavefront`); the port's sharded engine issues no
collective.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all 88
  ... --arch qwen3-0.6b --shape train_4k --mesh single          # one cell
  ... --list                                                    # the plan
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.rapidx import CONFIG as RAPIDX
from repro_torch.core.distributed import alignment_input_specs
from repro_torch.kernels import build, work
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import DeviceMesh, make_debug_mesh
from repro_torch.models.model import tree_leaves_with_path
from repro_torch.roofline.hlo_collectives import (
    collective_bytes_from_specs, no_collectives)
from repro_torch.sharding import (P, batch_specs, cache_specs,
                                  param_specs)
from repro_torch.train.train_step import (make_prefill_step, make_serve_step,
                                          make_train_step)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")

ALIGN_SHAPES = ("short_100", "short_250", "long_2k", "long_10k")
ALIGN_LENGTHS = {"short_100": 100, "short_250": 256, "long_2k": 2048,
                 "long_10k": 10240}

#: Aten ops that move no data: allocations whose contents nobody reads
#: and aliases the schema does not mark as views.
_NO_DATA = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
            torch.ops.aten.empty_like, torch.ops.aten.new_empty,
            torch.ops.aten.new_empty_strided, torch.ops.aten._unsafe_view,
            torch.ops.aten.lift_fresh}

#: Ops whose CUDA kernel returns an empty tensor where the CPU kernel (and
#: so the meta one) returns a full buffer: op -> index of that result. On
#: meta it is made empty too, so the trace counts what the card moves.
_EMPTY_ON_CUDA = {torch.ops.aten.log_sigmoid_forward: 1}

BASIS = {
    "flops_per_device": "the traced step's product FLOPs "
                        "(torch.utils.flop_counter's formulas over its "
                        "aten ops) plus its kernels' operations "
                        "(kernels.work, the kernel table's formulas), over "
                        "the cell's chip count; elementwise FLOPs are in "
                        "the bytes, not here",
    "bytes_accessed_per_device": "every aten op's tensor arguments' and "
                                 "results' bytes (the elements their "
                                 "strides span; views and bare "
                                 "allocations excluded) plus the kernels' "
                                 "bytes (kernels.work), over the chip "
                                 "count",
    "memory.argument_size_in_bytes": "each argument leaf's bytes over the "
                                     "mesh axes its spec shards it on",
    "memory.output_size_in_bytes": "each output leaf's shard bytes: a leaf "
                                   "updated in place keeps its argument's "
                                   "spec, the rest shard dim 0 over the "
                                   "batch axes where it divides",
    "memory.alias_size_in_bytes": "the donated arguments' shard bytes (the "
                                  "state in train, the cache in decode), "
                                  "as the reference donates them",
    "memory.temp_size_in_bytes": "the trace's peak of live bytes it "
                                 "allocated (freed storages followed by "
                                 "weakref) over pod x data: activations "
                                 "split over the batch and replicated over "
                                 "'model', an upper bound wherever tensor "
                                 "parallelism would split them",
    "collectives": "counted from the specs by "
                   "roofline.hlo_collectives.collective_bytes_from_specs; "
                   "the port runs no sharded language-model step",
    "compile_seconds": "the cell's seconds on the host: its abstract "
                       "trees, specs and the trace",
}


def _tensors(x) -> list:
    """The tensors of an op's arguments or results (nested tuples, lists
    and dicts)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


#: Tags a tensor's entry in a `_key` image.
_TENSOR = object()


def _key(x):
    """A hashable image of an op's arguments or results: a tensor by its
    shape, strides and dtype, containers by their items."""
    if isinstance(x, torch.Tensor):
        return (_TENSOR, tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_key(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _key(v)) for k, v in x.items()))
    return x


def _make(k):
    """Fresh meta results from their `_key` image."""
    if isinstance(k, tuple) and k and k[0] is _TENSOR:
        return torch.empty_strided(k[1], k[2], dtype=k[3], device="meta")
    if isinstance(k, tuple) and k and k[0] in (tuple, list):
        return k[0](_make(v) for v in k[1])
    return k


def _extent(t) -> int:
    """Elements a tensor's strides span (0 for an empty tensor)."""
    if t.numel() == 0:
        return 0
    return 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))


def _nbytes(t) -> int:
    """The bytes a tensor argument or result occupies: its elements, or
    the fewer its strides span (a broadcast dim of stride 0 reads its
    storage once)."""
    return min(t.numel(), _extent(t)) * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts the work of what runs under it, on any device but the CPU:
    per aten op its product FLOPs (`torch.utils.flop_counter`'s formulas)
    and the bytes of its tensor arguments and results (views and bare
    allocations excluded); per kernel call (`build.WORK`, which every
    kernel wrapper reports to) its operations by peak class and bytes
    (`kernels.work`); and the peak of the live bytes the run allocated,
    beyond the storages of `arguments`, each storage followed to its free
    by a weakref. The same counts come of a run on CUDA tensors, whose
    kernels launch, and of a trace on meta tensors, whose do not."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0
        self.aten_bytes = 0
        self.aten_calls = 0
        self.by_op: dict = {}
        self.kernels: dict = {}
        self.live = 0
        self.peak = 0
        self._seen = {t.untyped_storage()._cdata for t in arguments
                      if isinstance(t, torch.Tensor)}
        self._prior = None
        self._made: dict = {}

    def __enter__(self):
        self._prior, build.WORK = build.WORK, self
        return super().__enter__()

    def __exit__(self, *exc):
        build.WORK = self._prior
        return super().__exit__(*exc)

    def kernel(self, name: str, w: work.Work) -> None:
        """One kernel call's work (`build.WORK.kernel`)."""
        rec = self.kernels.setdefault(name, {"calls": 0, "ops": {},
                                             "bytes": 0})
        rec["calls"] += 1
        rec["bytes"] += w.nbytes
        for peak, n in w.ops.items():
            rec["ops"][peak] = rec["ops"].get(peak, 0) + n

    def _free(self, key, nbytes):
        self._seen.discard(key)
        self.live -= nbytes

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        nbytes = st.nbytes()
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nbytes)

    def _run(self, func, args, kwargs, ins):
        """`func`'s result. A functional op whose tensors are all meta
        has its result made from the shapes, strides and dtypes its first
        call on the same arguments gave (the meta kernels are Python, and
        a step repeats its ops); every other op runs."""
        if not all(t.is_meta for t in ins) or func.is_view \
                or func._schema.is_mutable:
            return func(*args, **kwargs)
        key = (func, _key(args), _key(kwargs))
        made = self._made.get(key)
        if made is not None:
            return _make(made)
        out = func(*args, **kwargs)
        inputs = {t.untyped_storage()._cdata for t in ins}
        if all(t.is_meta and t.storage_offset() == 0
               and t.untyped_storage()._cdata not in inputs
               and t.untyped_storage().nbytes()
               == _extent(t) * t.element_size() for t in _tensors(out)):
            self._made[key] = _key(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = self._run(func, args, kwargs, ins)
        packet = func._overloadpacket
        empty = _EMPTY_ON_CUDA.get(packet)
        if empty is not None and out[empty].is_meta:
            out = tuple(torch.empty(0, dtype=t.dtype, device=t.device)
                        if i == empty else t for i, t in enumerate(out))
        outs = _tensors(out)
        if all(t.device.type == "cpu" for t in ins + outs):
            return out
        for t in outs:
            self._track(t)
        if packet in _NO_DATA:
            return out
        formula = flop_registry.get(packet)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        nbytes = 0 if func.is_view else sum(_nbytes(t) for t in ins + outs)
        self.flops += flops
        self.aten_bytes += nbytes
        self.aten_calls += 1
        rec = self.by_op.setdefault(str(packet), [0, 0, 0])
        rec[0] += 1
        rec[1] += nbytes
        rec[2] += flops
        return out

    def kernel_ops(self) -> int:
        return sum(sum(k["ops"].values()) for k in self.kernels.values())

    def kernel_bytes(self) -> int:
        return sum(k["bytes"] for k in self.kernels.values())

    def summary(self) -> dict:
        return {"product_flops": self.flops, "aten_bytes": self.aten_bytes,
                "aten_calls": self.aten_calls,
                "kernel_ops": self.kernel_ops(),
                "kernel_bytes": self.kernel_bytes(),
                "kernels": self.kernels, "peak_temp_bytes": self.peak}


def production_mesh(mesh_name: str) -> DeviceMesh:
    """The reference's production meshes as abstract meshes of CPU entries
    (nothing is placed on them): "single" (16, 16) on ("data", "model"),
    "multipod" (2, 16, 16) on ("pod", "data", "model")."""
    if mesh_name == "multipod":
        return make_debug_mesh(data=16, model=16, pod=2, device="cpu")
    return make_debug_mesh(data=16, model=16, device="cpu")


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def _shard_bytes(leaf, spec, sizes) -> int:
    split = 1
    for part in spec:
        for axis in (part if isinstance(part, tuple) else (part,)):
            if axis is not None:
                split *= sizes[axis]
    return leaf.numel() * leaf.element_size() // split


def _tree_bytes(tree, specs, sizes) -> int:
    spec_of = dict(tree_leaves_with_path(specs))
    return sum(_shard_bytes(leaf, spec_of[path], sizes)
               for path, leaf in tree_leaves_with_path(tree))


def _output_bytes(out, args, arg_specs, mesh) -> int:
    """Each output leaf's shard bytes: an argument updated in place keeps
    its spec; any other leaf shards dim 0 over the batch axes where it
    divides (`batch_specs`)."""
    sizes = mesh.shape
    spec_of = {}
    for tree, specs in zip(args, arg_specs):
        by_path = dict(tree_leaves_with_path(specs))
        for path, leaf in tree_leaves_with_path(tree):
            spec_of[leaf.untyped_storage()._cdata] = by_path[path]
    total = 0
    for leaf in _tensors(out):
        spec = spec_of.get(leaf.untyped_storage()._cdata)
        if spec is None:
            spec = batch_specs({"x": leaf}, mesh)["x"]
        total += _shard_bytes(leaf, spec, sizes)
    return total


def lm_record(cfg, shape: ShapeSpec, mesh: DeviceMesh) -> dict:
    """One language-model cell: the reference's `_run_lm_cell` on the
    port's step, traced on meta tensors."""
    sizes = mesh.shape
    chips = math.prod(sizes.values())
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    inputs = S.input_specs(cfg, shape)
    if shape.kind == "train":
        # Microbatches sized by the "data" axis only; inputs pre-split
        # (nm, B/nm, ...) with the per-microbatch batch on "data"
        # (the reference's rule: its train step replicates over "pod").
        nm = S.microbatches_for(cfg, shape, sizes["data"])
        state = S.abstract_state(cfg)
        pspecs = param_specs(state["params"], mesh)
        st_specs = {"params": pspecs, "opt": {
            "m": param_specs(state["opt"]["m"], mesh),
            "v": param_specs(state["opt"]["v"], mesh), "step": P()}}
        if nm > 1:
            inputs = {k: torch.empty((nm, t.shape[0] // nm, *t.shape[1:]),
                                     dtype=t.dtype, device="meta")
                      for k, t in inputs.items()}
            in_specs = {k: P(None, "data", *([None] * (t.dim() - 2)))
                        for k, t in inputs.items()}
        else:
            in_specs = batch_specs(inputs, mesh)
        step = make_train_step(cfg, num_microbatches=nm)
        args, arg_specs, donated = (state, inputs), (st_specs, in_specs), 0
        params = state["params"]
        act_tokens = shape.global_batch // nm * shape.seq_len \
            // sizes["data"]
        extra = {"microbatches": nm, "step_kind": "train"}
    elif shape.kind == "prefill":
        params = S.abstract_params(cfg)
        pspecs = param_specs(params, mesh)
        step = make_prefill_step(cfg)
        args, arg_specs, donated = ((params, inputs),
                                    (pspecs, batch_specs(inputs, mesh)),
                                    None)
        nm = 1
        act_tokens = shape.global_batch * shape.seq_len // dp
        extra = {"step_kind": "prefill"}
    else:
        params = S.abstract_params(cfg)
        pspecs = param_specs(params, mesh)
        cache = S.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        c_specs = cache_specs(cache, mesh, batch=shape.global_batch)
        # Masked (shard-friendly) cache writes wherever the cache's
        # sequence dim carries a sharding, by the reference's rule.
        masked = (cfg.n_kv_heads % sizes.get("model", 1) != 0
                  or shape.global_batch == 1)
        step = make_serve_step(cfg, masked_cache_write=masked)
        args = (params, inputs, cache)
        arg_specs = (pspecs, batch_specs(inputs, mesh), c_specs)
        donated = 2
        nm = 1
        act_tokens = max(shape.global_batch // dp, 1)
        extra = {"step_kind": "decode", "masked_cache_write": masked}

    with StepCounter([t for a in args for t in _leaves(a)]) as counter:
        out = step(*args)
    arg_bytes = sum(_tree_bytes(a, s, sizes)
                    for a, s in zip(args, arg_specs))
    alias = 0 if donated is None else _tree_bytes(args[donated],
                                                  arg_specs[donated], sizes)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": _output_bytes(out, args, arg_specs,
                                                 mesh),
           "temp_size_in_bytes": counter.peak // dp,
           "alias_size_in_bytes": alias,
           "generated_code_size_in_bytes": 0}
    mem["total_per_device"] = (mem["argument_size_in_bytes"]
                               + mem["output_size_in_bytes"]
                               + mem["temp_size_in_bytes"]
                               - mem["alias_size_in_bytes"])
    coll = collective_bytes_from_specs(
        params, pspecs, sizes, step_kind=shape.kind, microbatches=nm,
        act_tokens=act_tokens, d_model=cfg.d_model)
    return {"flops_per_device": (counter.flops + counter.kernel_ops())
            / chips,
            "bytes_accessed_per_device":
                (counter.aten_bytes + counter.kernel_bytes()) / chips,
            "memory": mem, "collectives": coll,
            "counts": counter.summary(), "basis": BASIS, **extra}


def alignment_record(mesh: DeviceMesh, shape_name: str) -> dict:
    """The paper's own workload: a global batch of 64 pairs a (pod, data)
    shard, each shard's block aligned alone (`make_aligner` /
    `enqueue_dispatch` split the batch so), its B1 work by the kernel
    table's formula at full length (n = m = L, every pair live for the
    whole sweep of 2 L steps); no traceback planes; no collective."""
    sizes = mesh.shape
    length = ALIGN_LENGTHS[shape_name]
    band = RAPIDX.band_for(length)
    shards = sizes.get("pod", 1) * sizes.get("data", 1)
    global_batch = 64 * shards
    q, r, n, m = alignment_input_specs(global_batch, length, length)
    N = global_batch // shards
    T = 2 * length
    w = work.wavefront(N * T, band, N, length, length, T, False)
    per_shard_args = sum(t.numel() * t.element_size()
                         for t in (q, r, n, m)) // shards
    mem = {"argument_size_in_bytes": per_shard_args,
           "output_size_in_bytes": 6 * 4 * N,
           "temp_size_in_bytes": 0, "alias_size_in_bytes": 0,
           "generated_code_size_in_bytes": 0}
    mem["total_per_device"] = mem["argument_size_in_bytes"] \
        + mem["output_size_in_bytes"]
    return {"flops_per_device": w.total_ops,
            "bytes_accessed_per_device": w.nbytes,
            "memory": mem, "collectives": no_collectives(),
            "basis": {"flops_per_device": "B1's int32 operations on one "
                      "shard's block (kernels.work.wavefront, n = m = L)",
                      "bytes_accessed_per_device": "B1's bytes on one "
                      "shard's block (kernels.work.wavefront)",
                      "memory": "one shard's inputs (q, r int8; n, m "
                      "int32) and its (6, N) int32 stats plane",
                      "collectives": "none: each shard aligns its block "
                      "alone (core.distributed)"},
            "step_kind": "align", "band": band, "length": length,
            "global_batch": global_batch}


def run_cell(arch: str, shape_name: str, mesh_name: str,
             skip_existing: bool = True, results_dir: str = RESULTS_DIR):
    """Trace one cell; returns the record, also written to
    `results_dir`/<arch>__<shape>__<mesh>.json."""
    os.makedirs(results_dir, exist_ok=True)
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    out_path = os.path.join(results_dir, cell_id + ".json")
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    mesh = production_mesh(mesh_name)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "mesh_shape": list(mesh.devices.shape), "status": "error"}
    t0 = time.time()
    try:
        if arch == "rapidx-align":
            record.update(alignment_record(mesh, shape_name))
        else:
            cfg = get_config(arch)
            if shape_name == "long_500k" and not cfg.subquadratic:
                record["skipped"] = ("pure full-attention arch; long_500k "
                                     "needs bounded decode state "
                                     "(DESIGN.md)")
            else:
                record.update(lm_record(cfg, SHAPES[shape_name], mesh))
        record["status"] = "ok"
    except Exception as e:  # record the failure for triage
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["compile_seconds"] = round(time.time() - t0, 1)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def plan(archs=None, shapes=None, meshes=("single", "multipod")):
    """The reference's cells in its order: every arch (sorted) then
    "rapidx-align", each over its shapes, each over `meshes`."""
    archs = archs or (list_archs() + ["rapidx-align"])
    cells = []
    for arch in archs:
        if arch == "rapidx-align":
            arch_shapes = [s for s in (shapes or ALIGN_SHAPES)
                           if s in ALIGN_SHAPES]
        else:
            arch_shapes = [s for s in (shapes or list(SHAPES))
                           if s in SHAPES]
        for sh in arch_shapes:
            for mesh in meshes:
                cells.append((arch, sh, mesh))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append")
    ap.add_argument("--shape", action="append")
    ap.add_argument("--mesh", action="append",
                    choices=["single", "multipod"])
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    cells = plan(args.arch, args.shape,
                 tuple(args.mesh) if args.mesh else ("single", "multipod"))
    if args.list:
        for c in cells:
            print("%s %s %s" % c)
        return

    n_ok = n_skip = n_err = 0
    for arch, sh, mesh in cells:
        rec = run_cell(arch, sh, mesh, skip_existing=not args.force)
        if rec.get("skipped"):
            tag, n_skip = "SKIP", n_skip + 1
        elif rec["status"] == "ok":
            tag, n_ok = "OK", n_ok + 1
        else:
            tag, n_err = "ERR", n_err + 1
        mem = rec.get("memory", {}).get("total_per_device", 0) / 1e9
        print(f"[{tag}] {arch:20s} {sh:12s} {mesh:8s} "
              f"mem/dev={mem:6.2f}GB flops/dev={rec.get('flops_per_device', 0):.3g} "
              f"({rec.get('compile_seconds', 0)}s)"
              + (f"  !! {rec.get('error', '')[:120]}" if tag == "ERR" else ""),
              flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
