"""Sharding rules: FSDP("data") x TP("model") with divisibility fallback.
The port of the JAX package's `sharding/rules.py`, rule for rule.

Policy (DESIGN.md §5):
  * Every 2-D weight is tensor-parallel on "model" along its
    megatron-natural dim (column-parallel for up/gate/q/k/v projections
    and embeddings' vocab dim; row-parallel for down/wo) and
    FSDP-sharded on "data" along the other dim.
  * A dim is sharded on an axis ONLY if its size divides the axis size —
    otherwise that dim falls back to replication on that axis.
  * Period-stacked parameters get a leading unsharded n_periods dim.
  * The "pod" axis never shards parameters (pure DP across pods); the
    batch shards over ("pod", "data").

Every function is a pure function of (tree, mesh): it reads the leaves'
shapes (real or "meta" tensors) and the port's `DeviceMesh` axis sizes,
and returns a tree of `PartitionSpec`s matching its input tree. Nothing
is placed here (`runtime.elastic.reshard` places).
"""

from __future__ import annotations

from repro_torch.models.model import tree_map_with_path


class PartitionSpec(tuple):
    """One spec entry per tensor dim: None (replicated), an axis name, or
    a tuple of axis names. Normalised as JAX's: a list becomes a tuple,
    an empty tuple None, a one-name tuple the bare name."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (list, tuple)):
                p = tuple(p)
                return None if not p else (p[0] if len(p) == 1 else p)
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec

# Parameter names whose 2-D weight is row-parallel (input dim on "model").
_ROW_PARALLEL = {"wo", "down", "rout"}
# Embedding-like tables: vocab dim on "model", feature dim on "data".
_VOCAB_TABLES = {"table"}


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _leaf_spec(path_names, shape, data: int, model: int):
    """PartitionSpec for one parameter leaf (unstacked shape)."""
    name = path_names[-1] if path_names else ""
    nd = len(shape)
    if nd <= 1:
        return P()  # norms, biases, scalars: replicate
    parent = path_names[-2] if len(path_names) >= 2 else ""

    def m(dim):  # "model" if divisible
        return "model" if _div(shape[dim], model) else None

    def d(dim):  # "data" (FSDP) if divisible
        return "data" if _div(shape[dim], data) else None

    if name in _VOCAB_TABLES:            # (vocab, d)
        return P(m(0), d(1))
    if name == "w" and parent in _ROW_PARALLEL:
        specs = [None] * nd
        specs[-2], specs[-1] = m(nd - 2), d(nd - 1)
        return P(*specs)
    if name == "w" or name in ("gate", "up", "down"):
        # moe stacked experts come through as bare names (E, d, f)/(E, f, d)
        specs = [None] * nd
        if name == "down" and nd == 3:   # (E, f, d) row-parallel
            specs[1], specs[2] = m(1), d(2)
        elif nd == 3:                     # (E, d, f) column-parallel
            specs[1], specs[2] = d(1), m(2)
        else:                             # (d_in, d_out) column-parallel
            specs[-2], specs[-1] = d(nd - 2), m(nd - 1)
        return P(*specs)
    if nd == 3 and name.startswith("r"):
        # sLSTM per-head recurrent (H, Dh, Dh): shard heads if divisible
        return P(m(0), None, None)
    # Generic 2-D fallback: column-parallel.
    specs = [None] * nd
    specs[-2], specs[-1] = d(nd - 2), m(nd - 1)
    return P(*specs)


def param_specs(params, mesh):
    """PartitionSpecs for a model/optimizer param tree."""
    sizes = mesh.shape
    data = sizes.get("data", 1)
    model = sizes.get("model", 1)

    def spec(names, leaf):
        stacked = "periods" in names
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        base = _leaf_spec(names, shape, data, model)
        return P(None, *base) if stacked else base

    return tree_map_with_path(spec, params)


def train_state_specs(params, opt_state, mesh):
    pspecs = param_specs(params, mesh)
    return {
        "m": pspecs,
        "v": pspecs,
        "step": P(),
    }


def batch_specs(batch_tree, mesh, *, batch_axes=None):
    """Shard dim 0 (global batch) of every input over the DP axes."""
    if batch_axes is None:
        batch_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    sizes = mesh.shape
    total = 1
    for a in batch_axes:
        total *= sizes[a]

    def spec(_, leaf):
        if leaf.ndim == 0:
            return P()
        if leaf.shape[0] % total == 0:
            return P(batch_axes, *([None] * (leaf.ndim - 1)))
        return P(*([None] * leaf.ndim))

    return tree_map_with_path(spec, batch_tree)


def cache_specs(cache_tree, mesh, *, batch: int):
    """KV/recurrent cache sharding for decode.

    batch >= data-axis size: shard batch over "data" (+"pod").
    batch == 1 (long-context): shard the *sequence* dim of KV caches over
    "data" instead — sequence parallelism for the 500k cache.
    """
    sizes = mesh.shape
    data = sizes.get("data", 1)
    model = sizes.get("model", 1)
    dp_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    dp_total = 1
    for a in dp_axes:
        dp_total *= sizes[a]

    def spec(names, leaf):
        stacked = "periods" in names
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        nd = len(shape)
        if nd == 0:
            base = P()
        elif nd == 4 and names and names[-1] in ("k", "v", "0", "1"):
            # KV cache (B, Hkv, S, D). Always consume the "model" axis:
            # via kv heads when divisible, else via the sequence dim —
            # otherwise 32k x batch caches exceed per-device memory.
            h_spec = "model" if _div(shape[1], model) else None
            s_spec = None if h_spec else (
                "model" if _div(shape[2], model) else None)
            if shape[0] % dp_total == 0:
                base = P(dp_axes, h_spec, s_spec, None)
            else:
                # batch==1 long-context: sequence-parallel over "data"
                # (and "model" if heads don't shard).
                base = P(None, h_spec,
                         ("data",) + ((s_spec,) if s_spec else ())
                         if _div(shape[2], data) else s_spec,
                         None)
        else:
            # Recurrent states / conv states: batch over data if divisible.
            first = dp_axes if shape[0] % dp_total == 0 else None
            base = P(first, *([None] * (nd - 1)))
        return P(None, *base) if stacked else base

    return tree_map_with_path(spec, cache_tree)
