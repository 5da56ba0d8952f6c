"""Cross-pod data parallelism with an int8-compressed gradient sum, as the
JAX package's `train/compressed.py`.

The reference shard_maps its step over the "pod" axis: each pod computes
full gradients on its shard of the batch (its model replica), quantises
them with error feedback, psums the int8 payload across pods and applies
AdamW to the dequantised mean. This package runs no collectives
(`core/distributed.py`), so the step is written out on the port's
`launch.mesh.DeviceMesh`: every batch shard (over the mesh's "pod" and
"data" axes, row-major) is a replica on its own device with a copy of
the params; a pod's gradient is the mean of its data shards'; the pod
reduction sums the int8 payloads as int32, and averages the scales, on
the first pod's device; AdamW runs there, on the state. The state is the
one tree the caller holds (params, opt, err on the first pod's device);
as with the reference's replicated out-spec, the error buffer it keeps
is the first pod's.
"""

from __future__ import annotations

import torch

from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.grad_compress import (decompress_int8,
                                             error_feedback_update)
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train.train_step import value_and_grad


def make_compressed_train_step(cfg, mesh, *, peak_lr=3e-4, warmup_steps=100,
                               total_steps=10_000,
                               compute_dtype=torch.bfloat16):
    """Returns step(state_tree, batch) -> (state_tree, metrics) for a
    `DeviceMesh` (a "pod" axis of size 1 when it has none).
    state_tree: {"params", "opt", "err"}; the batch's leading dimension
    divides by the number of (pod, data) shards."""
    sizes = mesh.shape
    n_pods = sizes.get("pod", 1)
    batch_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    devices = mesh.shard_devices(batch_axes) if batch_axes \
        else (mesh.devices.reshape(-1)[0],)
    n_data = len(devices) // n_pods

    def pod_grads(params, batch, pod):
        """The pod's (loss, grads): the mean over its data shards, each on
        its own device from its own rows of the batch; on the first pod's
        device."""
        home = devices[0]
        B = next(iter(batch.values())).shape[0]
        rows = B // len(devices)
        loss, grads = 0.0, None
        for d in range(n_data):
            shard = pod * n_data + d
            dev = devices[shard]
            p = params if dev == home else tree_map(
                lambda t: t.detach().to(dev), params)
            mb = {k: v[shard * rows:(shard + 1) * rows].to(dev)
                  for k, v in batch.items()}
            l_d, g_d = value_and_grad(p, cfg, mb, compute_dtype)
            g_d = tree_map(lambda g: g.to(home), g_d)
            loss = loss + l_d.to(home)
            grads = g_d if grads is None else tree_map(torch.add, grads, g_d)
        return loss / n_data, tree_map(lambda g: g / n_data, grads)

    def step(state, batch):
        params, opt, err = state["params"], state["opt"], state["err"]
        per_pod = [pod_grads(params, batch, pod) for pod in range(n_pods)]
        pod_leaves = [tree_leaves(grads) for _, grads in per_pod]
        reduced, new_err = [], []
        for i, (p, e) in enumerate(zip(tree_leaves(params),
                                       tree_leaves(err))):
            payloads = [error_feedback_update(g[i], e) for g in pod_leaves]
            q_sum = torch.stack([q.to(torch.int32)
                                 for q, _, _ in payloads]).sum(0)
            scale_mean = torch.stack([s for _, s, _ in payloads]).mean()
            g_hat = decompress_int8(q_sum, scale_mean) / n_pods
            reduced.append(g_hat.to(p.dtype))
            new_err.append(payloads[0][2])
        it_g, it_e = iter(reduced), iter(new_err)
        grads = tree_map(lambda _: next(it_g), params)
        err = tree_map(lambda _: next(it_e), params)
        lr = cosine_schedule(opt["step"], peak_lr=peak_lr,
                             warmup_steps=warmup_steps,
                             total_steps=total_steps)
        params, opt, om = adamw_update(params, grads, opt, lr=lr)
        loss = torch.stack([lo for lo, _ in per_pod]).mean()
        return ({"params": params, "opt": opt, "err": err},
                {"loss": loss, "lr": lr, **om})

    return step
