"""Public wrapper of the banded flash attention.

The choice is made by where the tensors live and by nothing else: CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
Both are differentiable where a backward exists: on the CPU through
`FlashAttention` (the plain forward with its log-sum-exp and the plain
backward), on CUDA through `FlashAttention` behind either forward route
(B5-bwd for bf16 at every head size, the split-TF32 backward for f32).
"""

from __future__ import annotations

from repro_torch.kernels.local_attention.local_attention import (
    FlashAttention, check_inputs, flash_attention_cuda)


def flash_attention(q, k, v, *, window=None, block_q=128, block_k=128):
    """Banded flash attention: q (B, Hq, T, D), k/v (B, Hkv, T, D) with
    Hq % Hkv == 0 (q head h reads kv head h // (Hq/Hkv)); `window` W is
    the sliding-window width (None: full causal). T must divide the
    blocks clipped to T, as in the reference. Returns (B, Hq, T, D) in
    q's dtype. `block_q`/`block_k` tile the plain version; the kernel
    tiles by its own sizes."""
    check_inputs(q, k, v, window=window, block_q=block_q, block_k=block_k)
    if q.device.type == "cpu":
        return FlashAttention.apply(q, k, v, window, block_q, block_k)
    return flash_attention_cuda(q, k, v, window=window)
