"""Elastic scaling: remesh planning + state placement. The port of the
JAX package's `runtime/elastic.py`.

When hosts die (or stragglers are evicted) the job restarts on a smaller
device set; when capacity returns it scales back up. Because checkpoints
are stored whole (checkpoint.py) and the sharding rules are pure
functions of (tree, mesh), resharding is: plan a new mesh -> recompute
specs -> place. The data pipeline is stateless per (seed, step), so the
resumed job replays the exact global batch sequence regardless of the
new DP width.

One deliberate difference: the port runs every parameter whole on one
card (its only multi-device training step, `train.compressed`,
replicates), and has no tensor-parallel forward to hand a shard to. So
`reshard` places a leaf only where its spec splits it over no more than
one device, and raises `NotImplementedError` where it would split it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.launch.mesh import DeviceMesh, make_debug_mesh
from repro_torch.models.model import (tree_leaves_with_path,
                                      tree_map_with_path)
from repro_torch.sharding.rules import param_specs


def plan_mesh(num_devices: int, *, model_parallel: int = 16,
              pods: int = 1, axis_names=("data", "model"), device="cuda"):
    """Largest (data, model) mesh fitting num_devices, honouring TP size,
    over the first visible cards (`make_debug_mesh`; ``device="cpu"``:
    CPU entries, for tests).

    Keeps "model" fixed (TP degree is a property of the checkpointed
    layout's efficiency, not correctness) and shrinks/grows "data".
    """
    per_pod = num_devices // pods
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError(f"{num_devices} devices cannot host "
                         f"model_parallel={model_parallel}")
    names = (("pod",) + tuple(axis_names)) if pods > 1 else tuple(axis_names)
    mesh = make_debug_mesh(data=data, model=model_parallel,
                           pod=pods if pods > 1 else None, device=device)
    return DeviceMesh(mesh.devices, names)


def _ways(spec, sizes) -> int:
    """Devices a spec splits a leaf over: the product of its axes' sizes."""
    n = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n *= sizes[axis]
    return n


def reshard(tree, new_mesh: DeviceMesh):
    """Re-place a (restored) tree onto a new mesh per the rules: each leaf
    whole onto the mesh's device where its spec splits it over no more
    than one device; `NotImplementedError`, naming the leaf, where it
    would split it (or where the mesh spans several cards)."""
    specs = param_specs(tree, new_mesh)
    sizes = new_mesh.shape
    devices = set(np.asarray(new_mesh.devices).reshape(-1).tolist())
    flat_specs = dict(tree_leaves_with_path(specs))

    def place(path, leaf):
        ways = _ways(flat_specs[path], sizes)
        if ways > 1 or len(devices) > 1:
            raise NotImplementedError(
                f"reshard: leaf {'/'.join(path)} of shape "
                f"{tuple(leaf.shape)} would lie on {ways} x "
                f"{len(devices)} devices of mesh {sizes} (spec "
                f"{flat_specs[path]}); the port keeps every parameter "
                "whole on one card and has no tensor-parallel forward")
        return leaf.to(next(iter(devices)))

    return tree_map_with_path(place, tree)
