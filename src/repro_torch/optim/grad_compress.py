"""int8 gradient compression with error feedback (cross-pod DP trick), as
the JAX package's `optim/grad_compress.py`.

Quantising the cross-pod gradient sum to int8 cuts that traffic 4x
against f32; error feedback keeps the quantisation residual locally and
adds it back next step. Usage in `train.compressed`:

    q, scale, err = error_feedback_update(g, err)
    q_sum = sum over pods of q as int32
    g_hat = decompress_int8(q_sum, mean scale) / n_pods
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_map


def compress_int8(g):
    """Per-tensor symmetric int8 quantisation. Returns (q, scale); round
    half to even, as the reference's `jnp.round`."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def error_feedback_update(g, err):
    """Returns (quantised-with-feedback payload q, scale, new_err)."""
    target = g.float() + err
    q, scale = compress_int8(target)
    new_err = target - decompress_int8(q, scale)
    return q, scale, new_err


def init_error_buffer(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
