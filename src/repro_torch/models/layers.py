"""Building blocks of the language models (no nn.Module): params are
nested dicts of tensors.

Every module is an (init, apply) pair, as in the JAX package's
`models/layers.py`, whose weight layouts this file keeps — a dense weight
is ``(in, out)`` — so carrying parameters across is a copy, not a
transpose. An init takes a `torch.Generator` in place of a JAX key and
makes its tensors directly in `dtype` on `device` (by default the
generator's: a "meta" tree draws from a CPU generator and allocates
nothing). `lead`
prepends dimensions (the period stack of `models/model.py`): one draw
fills the whole stack, so no per-period copy is ever stacked.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_device(gen, device=None) -> torch.device:
    """Where an init makes its tensors: `device`, or the generator's."""
    return gen.device if device is None else torch.device(device)


def _trunc_normal(gen, shape, dtype, scale=1.0, device=None):
    t = torch.empty(shape, dtype=dtype, device=init_device(gen, device))
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    if scale != 1.0:
        t.mul_(scale)
    return t


def dense_init(gen, in_dim: int, out_dim: int, *, bias: bool = False,
               dtype=torch.float32, scale: float | None = None, lead=(),
               device=None):
    scale = scale if scale is not None else 1.0 / (in_dim ** 0.5)
    p = {"w": _trunc_normal(gen, (*lead, in_dim, out_dim), dtype, scale,
                            device)}
    if bias:
        p["b"] = torch.zeros((*lead, out_dim), dtype=dtype,
                             device=init_device(gen, device))
    return p


def dense_apply(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(dim: int, dtype=torch.float32, *, device="cpu", lead=()):
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, *, eps: float = 1e-6):
    """f32 math, multiplied by `scale` (not 1 + scale), cast back to x's
    dtype — the reference's rule."""
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def embed_init(gen, vocab: int, dim: int, dtype=torch.float32, *,
               device=None):
    return {"table": _trunc_normal(gen, (vocab, dim), dtype, device=device)}


def embed_apply(p, tokens, compute_dtype=torch.float32):
    """Token embedding lookup by gather.

    The reference multiplies a one-hot matrix by the table for vocabularies
    of 8,192 and more (a local product on a vocab-sharded table). Each sum
    there has exactly one non-zero product, so the gather gives the same
    values; the parity tests hold the two equal."""
    return p["table"][tokens.long()].to(compute_dtype)


def embed_attend(p, x):
    """Tied readout: logits = x @ table^T, in x's dtype."""
    return x @ p["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0, device="cpu"):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def rope_tables(positions, head_dim: int, theta: float = 10000.0,
                dtype=torch.float32):
    """(cos, sin) once per forward, shared by every layer."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x, positions=None, theta: float = 10000.0, *, tables=None):
    """x: (..., T, D). Rotates INTERLEAVED pairs (x[..., 0::2],
    x[..., 1::2]), in x's dtype."""
    D = x.shape[-1]
    if tables is None:
        tables = rope_tables(positions, D, theta, dtype=x.dtype)
    cos, sin = (t.to(x.dtype) for t in tables)
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


# ---------------------------------------------------------------------------
# Gated MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, *, kind: str = "swiglu",
             dtype=torch.float32, lead=(), device=None):
    kw = dict(dtype=dtype, lead=lead, device=device)
    if kind in ("swiglu", "geglu"):
        return {"gate": dense_init(gen, d_model, d_ff, **kw),
                "up": dense_init(gen, d_model, d_ff, **kw),
                "down": dense_init(gen, d_ff, d_model, **kw)}
    if kind == "gelu":
        return {"up": dense_init(gen, d_model, d_ff, **kw),
                "down": dense_init(gen, d_ff, d_model, **kw)}
    raise ValueError(kind)


def mlp_apply(p, x, *, kind: str = "swiglu"):
    """GELU is the tanh approximation, as the reference's
    ``approximate=True``."""
    if kind == "swiglu":
        h = F.silu(dense_apply(p["gate"], x)) * dense_apply(p["up"], x)
    elif kind == "geglu":
        h = F.gelu(dense_apply(p["gate"], x), approximate="tanh") \
            * dense_apply(p["up"], x)
    elif kind == "gelu":
        h = F.gelu(dense_apply(p["up"], x), approximate="tanh")
    else:
        raise ValueError(kind)
    return dense_apply(p["down"], h)


# ---------------------------------------------------------------------------
# Depthwise causal temporal convolution
# ---------------------------------------------------------------------------

def conv1d_init(gen, dim: int, width: int = 4, dtype=torch.float32, *,
                lead=(), device=None):
    """Depthwise causal temporal conv (Griffin / mLSTM front conv)."""
    return {"w": _trunc_normal(gen, (*lead, width, dim), dtype,
                               1.0 / width ** 0.5, device),
            "b": torch.zeros((*lead, dim), dtype=dtype,
                             device=init_device(gen, device))}


def conv1d_apply(p, x, state=None):
    """x: (B, T, D). Causal depthwise conv. With `state` ((B, width-1, D)
    trailing context) it runs in streaming / decode mode. Returns (y,
    new_state): the last width-1 inputs, for the next call."""
    w = p["w"].to(x.dtype)
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((*x.shape[:-2], width - 1, x.shape[-1]))
        xp = torch.cat([pad, x], dim=-2)
        new_state = xp[..., -(width - 1):, :] if width > 1 else None
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=-2)
        new_state = xp[..., -(width - 1):, :]
    # y[t] = sum_k w[k] * xp[t + k], summed in k order as the reference.
    T = x.shape[-2]
    y = w[0] * xp[..., 0:T, :]
    for k in range(1, width):
        y = y + w[k] * xp[..., k:k + T, :]
    return y + p["b"].to(x.dtype), new_state
