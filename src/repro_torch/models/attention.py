"""GQA attention with three execution paths and KV caches.

Paths, as in the JAX package's `models/attention.py`:
  * "naive"   — masked einsum attention, O(T^2) memory. Tests only.
  * "chunked" — flash attention as tensor code: a loop over query chunks
    with an inner loop over KV chunks, online softmax, chunks wholly
    outside the causal window skipped.
  * "pallas"  — the banded flash attention of `kernels/local_attention`.

On CUDA tensors "chunked" launches the hand-written kernel B5
(`kernels/local_attention/csrc/`: `flash_tc.cu` for bf16,
`flash_tf32x3.cu` for f32, at every built head size) at any sequence
length, straight through
`flash_attention_cuda`, which raises for a (dtype, head size) no kernel
is built for. Under autograd both CUDA paths ("chunked" and "pallas")
reach B5's `FlashAttention` (the route's forward with its log-sum-exp,
then B5-bwd, `csrc/flash_tc_bwd.cu`, for bf16, or the f32 backward,
`csrc/flash_tf32x3_bwd.cu`, for f32). "pallas"
keeps the reference wrapper's block rule (`ops.flash_attention`: T must
divide the blocks clipped to T) on every device. On CPU tensors each impl
keeps its reference meaning, and "pallas" takes the kernels' plain
version. "meta" tensors (the dry run's) take the CUDA tensors' route and
launch nothing.

Caches: a full cache (B, Hkv, S_max, D) for global layers, a ring buffer
(B, Hkv, W, D) for windowed layers; keys are stored after RoPE, so ring
eviction is safe. `attention_decode` writes the new entry INTO the cache
tensors and advances `length` in place (the reference returns new
arrays): a stacked period cache is updated through its views, and no
step copies a cache.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.local_attention.local_attention import \
    flash_attention_cuda
from repro_torch.kernels.local_attention.ops import flash_attention
from repro_torch.models import layers

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Hkv, S, D) — S = max_len (full) or W (ring)
    v: torch.Tensor
    length: torch.Tensor  # () int32 — tokens written so far
    # A cache is a ring buffer iff its layer is windowed, which callers
    # know from the block kind (`window` arg).


def attention_init(gen, cfg, dtype=torch.float32, *, lead=(), device=None):
    """cfg needs: d_model, n_heads, n_kv_heads, head_dim, qkv_bias, qk_norm."""
    D = cfg.head_dim
    kw = dict(dtype=dtype, lead=lead, device=device)
    p = {
        "wq": layers.dense_init(gen, cfg.d_model, cfg.n_heads * D,
                                bias=cfg.qkv_bias, **kw),
        "wk": layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * D,
                                bias=cfg.qkv_bias, **kw),
        "wv": layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * D,
                                bias=cfg.qkv_bias, **kw),
        "wo": layers.dense_init(gen, cfg.n_heads * D, cfg.d_model, **kw),
    }
    if cfg.qk_norm:
        dev = layers.init_device(gen, device)
        p["q_norm"] = layers.rmsnorm_init(D, dtype, device=dev, lead=lead)
        p["k_norm"] = layers.rmsnorm_init(D, dtype, device=dev, lead=lead)
    return p


def _project_qkv(p, cfg, x, positions, rope=None):
    B, T, _ = x.shape
    D = cfg.head_dim
    q = layers.dense_apply(p["wq"], x).reshape(B, T, cfg.n_heads, D)
    k = layers.dense_apply(p["wk"], x).reshape(B, T, cfg.n_kv_heads, D)
    v = layers.dense_apply(p["wv"], x).reshape(B, T, cfg.n_kv_heads, D)
    if cfg.qk_norm:
        # The default eps, not cfg.norm_eps — the reference's rule.
        q = layers.rmsnorm_apply(p["q_norm"], q)
        k = layers.rmsnorm_apply(p["k_norm"], k)
    # (B, H, T, D)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if rope is None:
        rope = layers.rope_tables(positions[:, None, :], D, cfg.rope_theta,
                                  dtype=x.dtype)
    q = layers.apply_rope(q, tables=rope)
    k = layers.apply_rope(k, tables=rope)
    return q, k, v


def _naive_attention(q, k, v, window):
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, T, D)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg.float(), k.float()) \
        / math.sqrt(D)
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    W = window if window is not None else T
    mask = (kpos <= qpos) & (kpos > qpos - W)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    return out.reshape(B, Hq, T, D).to(q.dtype)


def _chunked_attention(q, k, v, window, q_chunk=512, k_chunk=512):
    """Flash attention as tensor code, with causal/window chunk skipping.

    q is scaled in the compute dtype before the products (the reference
    does so too); scores and the (m, l, acc) state are f32."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    q_chunk = min(q_chunk, T)
    k_chunk = min(k_chunk, T)
    nq, nk = T // q_chunk, T // k_chunk
    W = window if window is not None else T
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    # The scale is rounded to q's dtype first, as a weak-typed constant is.
    qg = q.reshape(B, Hkv, G, nq, q_chunk, D) \
        * torch.tensor(scale, dtype=q.dtype, device=dev)
    kg = k.reshape(B, Hkv, nk, k_chunk, D)
    vg = v.reshape(B, Hkv, nk, k_chunk, D)
    outs = []
    for qi in range(nq):
        qc = qg[:, :, :, qi]                      # (B, Hkv, G, Cq, D)
        m = torch.full(qc.shape[:-1] + (1,), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, device=dev)
        lo_q = qi * q_chunk
        hi_q = lo_q + q_chunk - 1
        for ki in range(nk):
            lo_k = ki * k_chunk
            hi_k = lo_k + k_chunk - 1
            if not (lo_k <= hi_q and hi_k >= lo_q - W + 1):
                continue
            kc = kg[:, :, ki]
            vc = vg[:, :, ki]
            s = torch.einsum("bkgqd,bkcd->bkgqc", qc.float(), kc.float())
            qpos = lo_q + torch.arange(q_chunk, device=dev)[:, None]
            kpos = lo_k + torch.arange(k_chunk, device=dev)[None, :]
            msk = (kpos <= qpos) & (kpos > qpos - W)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            pr = torch.where(msk, torch.exp(s - m_new), 0.0)
            l = l * alpha + pr.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bkgqc,bkcd->bkgqd", pr.to(qc.dtype).float(), vc.float())
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        outs.append(acc / l)
    out = torch.stack(outs, dim=3)                # (B, Hkv, G, nq, Cq, D)
    return out.reshape(B, Hq, T, D).to(q.dtype)


def attention_apply(p, cfg, x, positions, *, window=None, impl="chunked",
                    q_chunk=512, k_chunk=512, rope=None):
    """Training / prefill self-attention. x: (B, T, d_model)."""
    B, T, _ = x.shape
    if impl not in ("naive", "chunked", "pallas"):
        raise ValueError(impl)
    q, k, v = _project_qkv(p, cfg, x, positions, rope=rope)
    if impl == "pallas":
        out = flash_attention(q, k, v, window=window)
    elif impl == "chunked" and build.kernel_side(q):
        out = flash_attention_cuda(q, k, v, window=window)
    elif impl == "naive" or T <= q_chunk:
        out = _naive_attention(q, k, v, window)
    else:
        out = _chunked_attention(q, k, v, window, q_chunk, k_chunk)
    out = out.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.head_dim)
    return layers.dense_apply(p["wo"], out)


# ---------------------------------------------------------------------------
# Decode path with KV caches
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cfg, max_len: int, *, window=None,
                  dtype=torch.bfloat16, device="cpu", lead=()) -> KVCache:
    S = min(window, max_len) if window is not None else max_len
    shape = (*lead, batch, cfg.n_kv_heads, S, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros(lead, dtype=torch.int32,
                                      device=device))


def attention_decode(p, cfg, x, cache: KVCache, *, window=None,
                     masked_write: bool = False):
    """One-token decode. x: (B, 1, d_model); returns (y, cache), the cache
    updated in place.

    masked_write=True writes the new entry with an elementwise select over
    an iota == slot mask (the reference's shard-friendly write) instead of
    an indexed copy; both leave the same cache. The position stays on the
    device: no step waits for the host.
    """
    B = x.shape[0]
    D = cfg.head_dim
    pos = cache.length                    # () int32, the new token's place
    positions = pos.reshape(1, 1).expand(B, 1)
    q, k, v = _project_qkv(p, cfg, x, positions)     # (B, H, 1, D)

    S = cache.k.shape[2]
    ring = window is not None
    slot = torch.remainder(pos, S) if ring else torch.clamp(pos, max=S - 1)
    slots = torch.arange(S, device=x.device)
    if masked_write:
        sel = (slots == slot)[None, None, :, None]
        cache.k.copy_(torch.where(sel, k.to(cache.k.dtype), cache.k))
        cache.v.copy_(torch.where(sel, v.to(cache.v.dtype), cache.v))
    else:
        idx = slot.reshape(1).long()
        cache.k.index_copy_(2, idx, k.to(cache.k.dtype))
        cache.v.index_copy_(2, idx, v.to(cache.v.dtype))

    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    G = Hq // Hkv
    # q rounded to the cache's dtype, products and sums in f32 (the
    # reference's preferred_element_type), then divided by sqrt(D).
    qg = q.reshape(B, Hkv, G, 1, D).to(cache.k.dtype).float()
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, cache.k.float()) / math.sqrt(D)
    # Live slots: ring — slots < min(pos + 1, S) hold exactly positions
    # pos-W+1..pos; full — slots <= pos.
    live = slots < torch.clamp(pos + 1, max=S)
    s = torch.where(live[None, None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bkcd->bkgqd", pr.to(cache.k.dtype).float(),
                       cache.v.float())
    out = out.reshape(B, Hq, 1, D).transpose(1, 2)
    out = out.reshape(B, 1, Hq * D).to(x.dtype)
    y = layers.dense_apply(p["wo"], out)
    cache.length.add_(1)
    return y, cache
