"""Layer blocks: one (init, apply, cache_init, decode) quadruple per kind.

Kinds ported (ArchConfig.pattern entries):
  attn     — pre-norm GQA attention + gated MLP (global causal)
  local    — the same with sliding-window (banded) attention
The reference's other kinds raise `NotImplementedError` naming their
ROADMAP item: moe, moe_swa (A11a, MoE kinds); rglru, mlstm, slstm (A11b,
recurrent kinds).

All blocks share the interface:
  block_init(gen, cfg, kind, dtype, lead=()) -> params
  block_apply(params, cfg, kind, x, positions) -> y            (prefill)
  block_cache_init(cfg, kind, batch, max_len, dtype) -> cache
  block_decode(params, cfg, kind, x, cache) -> (y, cache)      (1 token)
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers

_ATTN_KINDS = ("attn", "local")
_NOT_PORTED = {
    "moe": "A11a (MoE kinds)", "moe_swa": "A11a (MoE kinds)",
    "rglru": "A11b (recurrent kinds)", "mlstm": "A11b (recurrent kinds)",
    "slstm": "A11b (recurrent kinds)",
}


def _check_kind(kind: str) -> None:
    if kind in _ATTN_KINDS:
        return
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP "
            f"{_NOT_PORTED[kind]})")
    raise ValueError(f"unknown block kind {kind!r}")


def block_init(gen, cfg, kind: str, dtype=torch.float32, *, lead=()):
    _check_kind(kind)
    d = cfg.d_model
    dev = gen.device
    p = {"ln1": layers.rmsnorm_init(d, dtype, device=dev, lead=lead),
         "attn": attention.attention_init(gen, cfg, dtype, lead=lead),
         "ln2": layers.rmsnorm_init(d, dtype, device=dev, lead=lead)}
    if cfg.d_ff:
        p["mlp"] = layers.mlp_init(gen, d, cfg.d_ff, kind=cfg.mlp_kind,
                                   dtype=dtype, lead=lead)
    return p


def _window(cfg, kind):
    return cfg.window if kind in ("local", "moe_swa") else None


def _ffn_apply(p, cfg, x):
    if "mlp" in p:
        return layers.mlp_apply(p["mlp"], x, kind=cfg.mlp_kind)
    return torch.zeros_like(x)


def block_apply(p, cfg, kind: str, x, positions, rope=None):
    _check_kind(kind)
    h = layers.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
    y = attention.attention_apply(
        p["attn"], cfg, h, positions, window=_window(cfg, kind),
        impl=cfg.attn_impl, q_chunk=cfg.attn_chunk, k_chunk=cfg.attn_chunk,
        rope=rope)
    x = x + y
    h2 = layers.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
    return x + _ffn_apply(p, cfg, h2)


def block_cache_init(cfg, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, device="cpu", lead=()):
    _check_kind(kind)
    return attention.init_kv_cache(batch, cfg, max_len,
                                   window=_window(cfg, kind), dtype=dtype,
                                   device=device, lead=lead)


def block_decode(p, cfg, kind: str, x, cache, *, masked_write=False):
    """x: (B, 1, d). Returns (y, cache), the cache updated in place."""
    _check_kind(kind)
    h = layers.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
    y, cache = attention.attention_decode(p["attn"], cfg, h, cache,
                                          window=_window(cfg, kind),
                                          masked_write=masked_write)
    x = x + y
    h2 = layers.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
    return x + _ffn_apply(p, cfg, h2), cache
