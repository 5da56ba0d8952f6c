"""Collective-op byte volumes by kind, per device: the port of the JAX
package's `roofline/hlo_collectives.py`.

The reference parses every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute out of a compiled program's HLO. Eager
PyTorch has no compiled program, so the port has two sources:

  * `collective_bytes_by_kind(trace)` reads what a run did: the
    `c10d::*` operator events of a `torch.profiler` Chrome trace recorded
    with ``record_shapes=True`` (the process-group ops every collective
    goes through), their bytes from the recorded shapes and dtypes, and
    beside them the NCCL device kernels by kind;
  * `collective_bytes_from_specs(...)` counts what a sharded step over a
    mesh would issue, from the sharding rules' specs, for the dry run
    (`launch.dryrun`): the port runs no sharded language-model step, so
    there is nothing to read.

Both return the reference's dict, ``{kind: {"count", "bytes"},
"total_bytes"}``, bytes being each op's output tensor bytes (the
reference's convention: the volume crossing links up to the ring
factors). This module starts no process group and imports no collective
library: it reads traces and specs.
"""

from __future__ import annotations

import json
import math

from repro_torch.models.model import tree_leaves_with_path

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: c10d operator -> (kind, index of the argument that holds the output,
#: whether that output is the recorded argument times the world size).
_C10D_OPS = {
    "c10d::allreduce_": ("all-reduce", 0, False),
    "c10d::allgather_": ("all-gather", 1, True),
    "c10d::_allgather_base_": ("all-gather", 0, False),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0, False),
    "c10d::reduce_scatter_": ("reduce-scatter", 0, False),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0, False),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, False),
    "c10d::alltoall_": ("all-to-all", 0, False),
    "c10d::alltoall_base_": ("all-to-all", 0, False),
    "c10d::send": ("collective-permute", 0, False),
    "c10d::recv_": ("collective-permute", 0, False),
}

#: The profiler's names of element types -> bytes.
_TYPE_BYTES = {
    "double": 8, "float": 4, "c10::BFloat16": 2, "c10::Half": 2,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1, "long int": 8,
    "int": 4, "short int": 2, "signed char": 1, "unsigned char": 1,
    "bool": 1, "c10::complex<float>": 8, "c10::complex<double>": 16,
}

#: Parts of an NCCL kernel's name -> kind (all-to-all runs as send/recv).
_NCCL_KINDS = (("AllReduce", "all-reduce"), ("AllGather", "all-gather"),
               ("ReduceScatter", "reduce-scatter"),
               ("AllToAll", "all-to-all"), ("SendRecv", "collective-permute"),
               ("Send", "collective-permute"), ("Recv", "collective-permute"),
               ("Broadcast", "broadcast"), ("Reduce", "reduce"))


def no_collectives() -> dict:
    """The inventory of a program that issues none."""
    out = {k: {"count": 0, "bytes": 0} for k in KINDS}
    out["total_bytes"] = 0
    return out


def _total(out: dict) -> dict:
    out["total_bytes"] = sum(out[k]["bytes"] for k in KINDS)
    return out


def _list_dtype(event, dims, annotations, used):
    """The element type of a tensor-list argument, which the profiler
    records by shape only: taken from the first unused backend annotation
    (``gloo:*`` / ``nccl:*``, recorded with the tensors the backend was
    handed) that starts at or after `event` and was handed a tensor of the
    list's first shape."""
    for i, ann in enumerate(annotations):
        if i in used or ann["ts"] < event["ts"]:
            continue
        a = ann.get("args", {})
        if a.get("Input Dims", [None])[:1] == [dims]:
            used.add(i)
            return a.get("Input type", [None])[0]
    raise ValueError(f"{event['name']} at {event['ts']}: no backend "
                     f"annotation gives the dtype of its tensor list")


def collective_bytes_by_kind(trace) -> dict:
    """{kind: {"count", "bytes"}, "total_bytes", "nccl_kernels": {kind:
    count}} of a `torch.profiler` Chrome trace (the exported JSON text, or
    its dict) recorded with ``record_shapes=True``.

    Each ``c10d::*`` collective counts once, its bytes the output tensors'
    from the recorded shapes and element types (an all-gather into a list
    records only its input: times the world size of the trace's
    ``distributedInfo``). The NCCL device kernels are counted by the kind
    their name gives, beside (not in) the totals."""
    if isinstance(trace, (str, bytes)):
        trace = json.loads(trace)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    world = trace.get("distributedInfo", {}).get("world_size", 1)
    annotations = sorted(
        (e for e in events if e.get("cat") == "user_annotation"
         and e.get("name", "").startswith(("gloo:", "nccl:"))),
        key=lambda e: e["ts"])
    used: set = set()
    out = no_collectives()
    nccl: dict = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        name = e.get("name", "")
        if e.get("cat") == "kernel" and name.startswith(("ncclKernel",
                                                         "ncclDevKernel")):
            kind = next((k for part, k in _NCCL_KINDS if part in name),
                        "other")
            nccl[kind] = nccl.get(kind, 0) + 1
            continue
        if name not in _C10D_OPS:
            continue
        kind, arg, times_world = _C10D_OPS[name]
        a = e.get("args", {})
        dims, typ = a["Input Dims"][arg], a["Input type"][arg]
        shapes = dims if typ == "TensorList" else [dims]
        if typ == "TensorList":
            typ = _list_dtype(e, shapes[0], annotations, used) \
                if shapes else "float"
        nbytes = sum(math.prod(s) for s in shapes) * _TYPE_BYTES[typ]
        out[kind]["count"] += 1
        out[kind]["bytes"] += nbytes * (world if times_world else 1)
    out = _total(out)
    out["nccl_kernels"] = nccl
    return out


def _axes(spec) -> set:
    """The mesh axis names a `PartitionSpec` shards over."""
    names = set()
    for part in spec:
        if isinstance(part, tuple):
            names.update(part)
        elif part is not None:
            names.add(part)
    return names


def _row_parallel(path) -> bool:
    """Whether a leaf's product reduces over the "model" axis when that
    axis shards it (the rules' row-parallel weights and the vocabulary
    table, whose lookup is a product over the vocabulary): one all-reduce
    of its output activations per pass."""
    name = path[-1] if path else ""
    parent = path[-2] if len(path) >= 2 else ""
    return (name == "w" and parent in ("wo", "down", "rout")) \
        or name in ("down", "table")


def collective_bytes_from_specs(params, specs, mesh_shape: dict, *,
                                step_kind: str, microbatches: int = 1,
                                act_tokens: int, d_model: int,
                                compute_itemsize: int = 2) -> dict:
    """The collectives one device would issue in one step of the
    language model `params` (a tree of tensors, real or meta) sharded by
    `specs` (`sharding.param_specs` of it) over a mesh of `mesh_shape`
    ({axis: size}), in the reference's dict.

    The rule (FSDP on "data", tensor parallelism on "model", data
    parallelism over "pod" x "data"):
      * all-gather — each leaf the spec shards over "data" (data > 1) is
        gathered over "data" once per pass of each microbatch (train: a
        forward and a backward pass, `microbatches` times; prefill and
        decode: one pass), its output the leaf less its "model" split, in
        `compute_itemsize` bytes (the compute dtype of a floating leaf);
      * gradients (train) — each leaf sharded over "data" has its summed
        gradient reduce-scattered over "data" once a step (output: its
        shard) and, with pod > 1, that shard all-reduced over "pod"; every
        other leaf, with pod x data > 1, all-reduced over the data axes
        (output: the leaf less its "model" split); in the parameter's
        dtype;
      * activations — each leaf whose product reduces over "model" when
        "model" shards it (row-parallel weights: attention's and the
        MLPs' output projections, the MoE experts' down projection; the
        vocabulary table's lookup), with model > 1, costs one all-reduce
        of (`act_tokens`, `d_model`) activations in `compute_itemsize`
        bytes per pass of each microbatch and each layer it serves (the
        leading period dim of a stacked leaf); `act_tokens` is the tokens
        one device holds in one microbatch.
    Not counted: the replays of a recomputed forward, the cross entropy's
    per-token reductions over a vocabulary split, and any collective of
    a cache sharded along its sequence."""
    data = mesh_shape.get("data", 1)
    model = mesh_shape.get("model", 1)
    pod = mesh_shape.get("pod", 1)
    train = step_kind == "train"
    passes = 2 * microbatches if train else 1
    out = no_collectives()

    def add(kind, count, nbytes):
        out[kind]["count"] += count
        out[kind]["bytes"] += count * nbytes

    spec_of = dict(tree_leaves_with_path(specs))
    for path, leaf in tree_leaves_with_path(params):
        axes = _axes(spec_of[path])
        numel = leaf.numel()
        split = math.prod(mesh_shape[a] for a in axes)
        used = numel // (model if "model" in axes else 1)
        itemsize = compute_itemsize if leaf.is_floating_point() \
            else leaf.element_size()
        on_data = "data" in axes and data > 1
        if on_data:
            add("all-gather", passes, used * itemsize)
        if train:
            grad = leaf.element_size()
            if on_data:
                add("reduce-scatter", 1, numel // split * grad)
                if pod > 1:
                    add("all-reduce", 1, numel // split * grad)
            elif pod * data > 1:
                add("all-reduce", 1, used * grad)
        if model > 1 and "model" in axes and _row_parallel(path):
            layers = leaf.shape[0] if "periods" in path else 1
            add("all-reduce", passes * layers,
                act_tokens * d_model * compute_itemsize)
    return _total(out)
