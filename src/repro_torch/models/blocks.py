"""Layer blocks: one (init, apply, cache_init, decode) quadruple per kind.

Kinds (ArchConfig.pattern entries), as in the JAX package's
`models/blocks.py`:
  attn     — pre-norm GQA attention + gated MLP (global causal)
  local    — the same with sliding-window (banded) attention
  moe      — attention + mixture-of-experts FFN
  moe_swa  — windowed attention + MoE (mixtral)
  rglru    — Griffin recurrent block (conv + RG-LRU, gated) + MLP
  mlstm    — xLSTM matrix-memory block (conv front, no FFN)
  slstm    — xLSTM scalar block (no FFN)
Any other kind raises `ValueError`.

All blocks share the interface:
  block_init(gen, cfg, kind, dtype, lead=()) -> params
  block_apply(params, cfg, kind, x, positions) -> y            (prefill)
  block_cache_init(cfg, kind, batch, max_len, dtype) -> cache
  block_decode(params, cfg, kind, x, cache) -> (y, cache)      (1 token)

Decode updates the cache IN PLACE — the KV ring through its views, every
recurrent state tensor by `copy_` — so the period stacks of
`models/model.py` see the new state through their views.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention, layers, moe, rglru, xlstm

CONV_WIDTH = 4

KINDS = ("attn", "local", "moe", "moe_swa", "rglru", "mlstm", "slstm")
_ATTN_KINDS = ("attn", "local", "moe", "moe_swa")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def _ffn_init(gen, cfg, kind, dtype, lead, device):
    if kind in ("moe", "moe_swa"):
        return {"moe": moe.moe_init(gen, cfg, dtype, lead=lead,
                                    device=device)}
    if cfg.d_ff:
        return {"mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                       kind=cfg.mlp_kind, dtype=dtype,
                                       lead=lead, device=device)}
    return {}


def _ffn_apply(p, cfg, x):
    if "moe" in p:
        return moe.moe_apply(p["moe"], cfg, x)
    if "mlp" in p:
        return layers.mlp_apply(p["mlp"], x, kind=cfg.mlp_kind)
    return torch.zeros_like(x)


def block_init(gen, cfg, kind: str, dtype=torch.float32, *, lead=(),
               device=None):
    _check_kind(kind)
    d = cfg.d_model
    dev = layers.init_device(gen, device)
    kw = dict(lead=lead, device=dev)

    def dense(i, o):
        return layers.dense_init(gen, i, o, dtype=dtype, **kw)
    p = {"ln1": layers.rmsnorm_init(d, dtype, **kw)}
    if kind in _ATTN_KINDS:
        p["attn"] = attention.attention_init(gen, cfg, dtype, **kw)
        p["ln2"] = layers.rmsnorm_init(d, dtype, **kw)
        p.update(_ffn_init(gen, cfg, kind, dtype, lead, dev))
    elif kind == "rglru":
        p["rx"] = dense(d, d)
        p["rgate"] = dense(d, d)
        p["conv"] = layers.conv1d_init(gen, d, CONV_WIDTH, dtype, **kw)
        p["rglru"] = rglru.rglru_init(gen, d, dtype, **kw)
        p["rout"] = dense(d, d)
        p["ln2"] = layers.rmsnorm_init(d, dtype, **kw)
        p.update(_ffn_init(gen, cfg, kind, dtype, lead, dev))
    elif kind == "mlstm":
        p["conv"] = layers.conv1d_init(gen, d, CONV_WIDTH, dtype, **kw)
        p["mlstm"] = xlstm.mlstm_init(gen, d, cfg.n_heads, cfg.head_dim,
                                      dtype, **kw)
    else:   # slstm
        p["slstm"] = xlstm.slstm_init(gen, d, cfg.n_heads, dtype, **kw)
    return p


def _window(cfg, kind):
    return cfg.window if kind in ("local", "moe_swa") else None


def block_apply(p, cfg, kind: str, x, positions, rope=None):
    _check_kind(kind)
    h = layers.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
    if kind in _ATTN_KINDS:
        y = attention.attention_apply(
            p["attn"], cfg, h, positions, window=_window(cfg, kind),
            impl=cfg.attn_impl, q_chunk=cfg.attn_chunk,
            k_chunk=cfg.attn_chunk, rope=rope)
        x = x + y
        h2 = layers.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        return x + _ffn_apply(p, cfg, h2)
    if kind == "rglru":
        a, _ = layers.conv1d_apply(p["conv"], layers.dense_apply(p["rx"], h))
        a, _ = rglru.rglru_apply(p["rglru"], a)
        g = F.gelu(layers.dense_apply(p["rgate"], h), approximate="tanh")
        x = x + layers.dense_apply(p["rout"], a * g)
        h2 = layers.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        return x + _ffn_apply(p, cfg, h2)
    if kind == "mlstm":
        a, _ = layers.conv1d_apply(p["conv"], h)
        a = F.silu(a)
        y, _ = xlstm.mlstm_chunkwise(p["mlstm"], a, cfg.n_heads, cfg.head_dim,
                                     chunk=min(cfg.mlstm_chunk, x.shape[1]))
        return x + y
    y, _ = xlstm.slstm_apply(p["slstm"], h, cfg.n_heads)
    return x + y


def block_cache_init(cfg, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, device="cpu", lead=()):
    """The reference's cache of each kind, with its dtypes: KV caches in
    `dtype`; recurrent state f32 (sLSTM's n starts at ones); conv context
    in `dtype`."""
    _check_kind(kind)
    d = cfg.d_model
    if kind in _ATTN_KINDS:
        return attention.init_kv_cache(batch, cfg, max_len,
                                       window=_window(cfg, kind), dtype=dtype,
                                       device=device, lead=lead)

    def conv():
        return torch.zeros((*lead, batch, CONV_WIDTH - 1, d), dtype=dtype,
                           device=device)
    if kind == "rglru":
        return {"h": torch.zeros((*lead, batch, d), dtype=torch.float32,
                                 device=device),
                "conv": conv()}
    if kind == "mlstm":
        st = xlstm.mlstm_state_init(batch, cfg.n_heads, cfg.head_dim,
                                    device=device, lead=lead)
        st["conv"] = conv()
        return st
    return xlstm.slstm_state_init(batch, cfg.n_heads, d // cfg.n_heads,
                                  device=device, lead=lead)


def _write(cache, new):
    """Copy each new state tensor into the cache's own (casting to its
    dtype), so the views of a period stack see it."""
    for key, val in new.items():
        cache[key].copy_(val)
    return cache


def block_decode(p, cfg, kind: str, x, cache, *, masked_write=False):
    """x: (B, 1, d). Returns (y, cache), the cache updated in place."""
    _check_kind(kind)
    h = layers.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
    if kind in _ATTN_KINDS:
        y, cache = attention.attention_decode(p["attn"], cfg, h, cache,
                                              window=_window(cfg, kind),
                                              masked_write=masked_write)
        x = x + y
        h2 = layers.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        return x + _ffn_apply(p, cfg, h2), cache
    if kind == "rglru":
        a = layers.dense_apply(p["rx"], h)
        a, conv_state = layers.conv1d_apply(p["conv"], a,
                                            state=cache["conv"])
        a, h_state = rglru.rglru_step(p["rglru"], a, cache["h"])
        g = F.gelu(layers.dense_apply(p["rgate"], h), approximate="tanh")
        x = x + layers.dense_apply(p["rout"], a * g)
        h2 = layers.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        x = x + _ffn_apply(p, cfg, h2)
        return x, _write(cache, {"h": h_state, "conv": conv_state})
    if kind == "mlstm":
        a, conv_state = layers.conv1d_apply(p["conv"], h,
                                            state=cache["conv"])
        a = F.silu(a)
        state = {key: cache[key] for key in ("C", "n", "m")}
        y, state = xlstm.mlstm_recurrent(p["mlstm"], a, cfg.n_heads,
                                         cfg.head_dim, state=state)
        state["conv"] = conv_state
        return x + y, _write(cache, state)
    y, state = xlstm.slstm_apply(p["slstm"], h, cfg.n_heads, state=cache)
    return x + y, _write(cache, state)
