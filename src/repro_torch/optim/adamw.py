"""AdamW with global-norm clipping, as the JAX package's `optim/adamw.py`.

Optimiser state mirrors the params tree (nested dicts of tensors): first
and second moments plus a 0-d int32 step. The update math is f32; the
moments may be kept in bf16 (`moments_dtype`), rounded after each update
as in the reference.

One deliberate difference: `adamw_update` writes the parameters, the
moments and the step IN PLACE under `torch.no_grad()`, as `torch.optim`
does (the reference returns new arrays), and returns the same trees.
"""

from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    """The tensors of a nested-dict tree, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and of the like-shaped trees `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params, moments_dtype=None):
    """moments_dtype=torch.bfloat16 halves optimiser memory; the update
    math stays f32."""
    def zeros(p):
        return torch.zeros_like(p, dtype=moments_dtype or p.dtype,
                                requires_grad=False)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(params, grads, state, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """One AdamW step. `lr` may be a scalar or a 0-d tensor (schedule
    applied by the caller). Updates `params`, `state["m"]`, `state["v"]`
    and `state["step"]` in place.

    Returns (params, state, metrics) — the same trees, updated.
    """
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"]
        step.add_(1)
        stepf = step.float()
        b1c = 1.0 - b1 ** stepf
        b2c = 1.0 - b2 ** stepf
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g = g.float()
            m.copy_(m.float().mul(b1).add_(g, alpha=1 - b1))
            v.copy_(v.float().mul(b2).add_(torch.square(g), alpha=1 - b2))
            upd = (m.float() / b1c).div_((v.float() / b2c).sqrt_().add_(eps))
            upd.add_(p.float(), alpha=weight_decay)
            p.copy_(p.float() - lr * upd)
    return params, state, {"grad_norm": gnorm}
