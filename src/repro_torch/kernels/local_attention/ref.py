"""Plain masked causal / sliding-window attention (O(T^2)), the oracle of
the banded flash attention kernel."""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, window: int | None = None):
    """Args as flash_attention: q (B,Hq,T,D), k/v (B,Hkv,T,D). f32 math."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    if group != 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    W = window if window is not None else T
    mask = (kpos <= qpos) & (kpos > qpos - W)
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
