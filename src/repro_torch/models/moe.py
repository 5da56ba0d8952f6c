"""Mixture-of-Experts layer: top-k routing with per-expert capacity gather.

The port of the JAX package's `models/moe.py`. Token-choice top-k routing
combined with per-expert top-C token selection (capacity): each expert
gathers its top-C tokens by routing weight, the stacked expert MLPs run as
three batched products on (E, C, d), and the results are summed back per
token weighted by the routing probability. Tokens beyond capacity are
dropped (capacity-factor semantics), so a one-token decode step and a
prefill of the same tokens may route differently.

No kernel: gathers, three `torch.bmm`s (the reference leaves its einsums
to XLA) and a sum.

Two rules are kept exactly as the reference's:
  * top-k ties go to the lower index (`jax.lax.top_k`'s order).
    `torch.topk` does not promise that, so `_top_k` takes the first k of a
    stable descending sort.
  * the per-token sum runs over the token's kept experts in ascending
    expert order, as the reference's scatter-add adds its (E, C) rows;
    the port gathers each token's (at most k) expert outputs and adds
    them in that order, so the result does not depend on atomic order
    and two calls agree bit for bit.

Covers both MoE architectures of the registry:
  * mixtral-8x22b: 8 experts, top-2, renormalised gates.
  * qwen2-moe-a2.7b: 60 routed experts top-4 (not renormalised) + a
    sigmoid-gated shared expert (one 4x-width MLP).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def moe_init(gen, cfg, dtype=torch.float32, *, lead=(), device=None):
    """cfg needs: d_model, moe_num_experts, moe_d_ff, moe_shared_d_ff."""
    E, d, f = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff
    scale = 1.0 / (d ** 0.5)
    kw = dict(dtype=dtype, lead=lead, device=device)
    p = {
        "router": layers.dense_init(gen, d, E, **kw),
        "gate": layers._trunc_normal(gen, (*lead, E, d, f), dtype, scale,
                                     device),
        "up": layers._trunc_normal(gen, (*lead, E, d, f), dtype, scale,
                                   device),
        "down": layers._trunc_normal(gen, (*lead, E, f, d), dtype,
                                     1.0 / f ** 0.5, device),
    }
    if cfg.moe_shared_d_ff:
        p["shared"] = layers.mlp_init(gen, d, cfg.moe_shared_d_ff,
                                      kind="swiglu", **kw)
        p["shared_gate"] = layers.dense_init(gen, d, 1, **kw)
    return p


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index — `jax.lax.top_k`'s order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, n_tokens: int, capacity_factor: float = 1.25) -> int:
    """Tokens each expert keeps: the reference's float expression,
    evaluated left to right and truncated."""
    C = max(1, int(capacity_factor * n_tokens * cfg.moe_top_k
                   / cfg.moe_num_experts))
    return min(C, n_tokens)


def route(p, cfg, xf, *, capacity_factor: float = 1.25):
    """Routing of N tokens xf (N, d): returns a dict of
      top_p, top_i (N, k): each token's chosen experts (probability
        order), renormalised where the config says so;
      w (N, E) f32: the routing weight of each (token, expert), 0 where
        the expert was not chosen;
      combine, idx (E, C): each expert's kept tokens and their weights.
    """
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    N = xf.shape[0]
    logits = layers.dense_apply(p["router"], xf).float()        # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, k)                             # (N, k)
    if cfg.moe_renormalize:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    # The chosen experts of a token are distinct: one write per entry.
    w = torch.zeros((N, E), dtype=torch.float32, device=xf.device)
    w.scatter_(1, top_i, top_p)
    C = capacity(cfg, N, capacity_factor)
    combine, idx = _top_k(w.T, C)                               # (E, C)
    return {"top_p": top_p, "top_i": top_i, "w": w, "combine": combine,
            "idx": idx, "probs": probs}


def _combine_by_token(out, idx, top_i):
    """y[n] = sum over token n's kept (expert, slot) rows of out (E, C, d),
    in ascending expert order. Returns (N, d) f32."""
    E, C, d = out.shape
    N = top_i.shape[0]
    # slot[e, n]: the slot expert e keeps token n in, or -1 (dropped).
    slot = torch.full((E, N), -1, dtype=torch.long, device=out.device)
    slot.scatter_(1, idx, torch.arange(C, device=out.device)
                  .expand(E, C).contiguous())
    experts = top_i.sort(dim=-1).values                         # (N, k)
    tokens = torch.arange(N, device=out.device)[:, None]
    s = slot[experts, tokens]                                   # (N, k)
    rows = out.reshape(E * C, d)[(experts * C + s.clamp(min=0)).reshape(-1)]
    rows = rows.reshape(N, -1, d) * (s >= 0)[..., None]
    y = rows[:, 0]
    for j in range(1, rows.shape[1]):
        y = y + rows[:, j]
    return y


def moe_apply(p, cfg, x, *, capacity_factor: float = 1.25,
              token_chunk: int = 8192):
    """x: (B, T, d) -> (B, T, d).

    More than `token_chunk` tokens, when they split into whole chunks,
    run chunk by chunk, with the capacity per chunk (the reference scans
    the chunks)."""
    B, T, d = x.shape
    N = B * T
    if N > token_chunk and N % token_chunk == 0:
        xb = x.reshape(N // token_chunk, 1, token_chunk, d)
        out = [moe_apply(p, cfg, xc, capacity_factor=capacity_factor,
                         token_chunk=N + 1) for xc in xb]
        return torch.stack(out).reshape(B, T, d)

    E = cfg.moe_num_experts
    xf = x.reshape(N, d)
    r = route(p, cfg, xf, capacity_factor=capacity_factor)
    combine, idx = r["combine"], r["idx"]
    C = idx.shape[1]
    xg = xf[idx.reshape(-1)].reshape(E, C, d)

    # Expert FFNs in the activation dtype; the f32 combine and sum keep
    # the accumulation exact.
    h = torch.bmm(xg, p["gate"].to(xg.dtype))
    u = torch.bmm(xg, p["up"].to(xg.dtype))
    h = F.silu(h) * u
    out = torch.bmm(h, p["down"].to(xg.dtype))
    out = out.float() * combine[..., None]                      # (E, C, d)
    y = _combine_by_token(out, idx, r["top_i"])

    if "shared" in p:
        g = torch.sigmoid(layers.dense_apply(p["shared_gate"], xf).float())
        y = y + g * layers.mlp_apply(p["shared"], xf).float()

    return y.reshape(B, T, d).to(x.dtype)


def load_balancing_loss(p, cfg, x):
    """Auxiliary load-balance loss (Switch-style): E * sum_e f_e * P_e."""
    d = x.shape[-1]
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    xf = x.reshape(-1, d)
    logits = layers.dense_apply(p["router"], xf).float()
    probs = torch.softmax(logits, dim=-1)
    _, top_i = _top_k(probs, k)
    frac = F.one_hot(top_i, E).float().sum(1).mean(0)           # f_e
    imp = probs.mean(0)                                         # P_e
    return E * torch.sum(frac * imp)
