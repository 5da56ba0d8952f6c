"""Parity of the port's banded flash attention (`repro_torch.kernels.
local_attention`) with the JAX package's: the plain version of the B5
kernel against the Pallas kernel in interpret mode and both oracles.
Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_attention import attention_ref as jax_ref
from repro.kernels.local_attention import flash_attention as jax_flash
from repro_torch.kernels.local_attention import attention_ref, flash_attention
from repro_torch.kernels.local_attention.local_attention import (
    flash_attention_cuda, flash_attention_plain)

# The cases of tests/test_kernels.py (ATT_CASES), the dtype as a name.
ATT_CASES = [
    # (B, Hq, Hkv, T, D, window, bq, bk, dtype)
    (2, 4, 2, 256, 64, None, 64, 64, "float32"),
    (1, 4, 4, 256, 64, 64, 64, 64, "float32"),
    (2, 8, 2, 512, 32, 100, 128, 128, "float32"),
    (1, 2, 1, 128, 128, 32, 64, 32, "float32"),
    (1, 2, 2, 256, 64, 17, 32, 64, "float32"),
    (1, 1, 1, 512, 64, 512, 128, 128, "float32"),
    (2, 4, 2, 256, 64, 64, 64, 64, "bfloat16"),
]
# The reference test's tolerances: f32 2e-5, bf16 2e-2 (atol and rtol).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, B, Hq, Hkv, T, D, dtype):
    """(jax arrays, torch tensors) of the same values: f32 normals from
    numpy, rounded to `dtype` by each package (both round to nearest
    even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, T, D), (B, Hkv, T, D), (B, Hkv, T, D))]
    return ([jnp.asarray(a, JAX_DT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", ATT_CASES,
                         ids=[f"c{i}" for i in range(len(ATT_CASES))])
def test_flash_plain_matches_jax_kernel_and_refs(case):
    B, Hq, Hkv, T, D, W, bq, bk, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(B * T + (W or 0), B, Hq, Hkv, T, D,
                                      dtype)
    before = flash_attention_plain.calls
    out = flash_attention(q, k, v, window=W, block_q=bq, block_k=bk)
    assert flash_attention_plain.calls == before + 1   # CPU -> plain
    assert out.dtype == TORCH_DT[dtype] and out.shape == q.shape
    ref = attention_ref(q, k, v, window=W)
    j_out = jax_flash(jq, jk, jv, window=W, block_q=bq, block_k=bk)
    j_ref = jax_ref(jq, jk, jv, window=W)
    tol = TOL[dtype]
    for got, want in ((out, j_out), (ref, j_ref), (out, ref)):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_flash_window_geq_t_equals_full():
    _, (q, k, v) = _inputs(0, 1, 2, 2, 128, 32, "float32")
    full = flash_attention(q, k, v, window=None, block_q=64, block_k=64)
    for W in (128, 4096):
        wide = flash_attention(q, k, v, window=W, block_q=64, block_k=64)
        np.testing.assert_allclose(full.numpy(), wide.numpy(), atol=1e-6)


def test_flash_plain_blocks_agree():
    """The plain pass's result does not depend on its tiling beyond f32
    rounding (the kernel tiles by its own sizes)."""
    _, (q, k, v) = _inputs(3, 1, 4, 2, 256, 64, "float32")
    for W in (None, 40):
        a = flash_attention(q, k, v, window=W, block_q=128, block_k=128)
        b = flash_attention(q, k, v, window=W, block_q=32, block_k=64)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("bad", ["heads", "block", "kv_shape", "rank"])
def test_flash_wrapper_raises_on_bad_shapes(bad):
    q = torch.zeros(1, 4, 128, 64)
    k = torch.zeros(1, 2, 128, 64)
    v = torch.zeros(1, 2, 128, 64)
    kw = {}
    if bad == "heads":
        k = v = torch.zeros(1, 3, 128, 64)
    elif bad == "block":
        kw = dict(block_q=48)
    elif bad == "kv_shape":
        v = torch.zeros(1, 2, 64, 64)
    else:
        q = torch.zeros(4, 128, 64)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v)


def test_flash_kernel_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head size"):
        x = torch.zeros(1, 2, 64, 32)
        flash_attention_cuda(x, x, x)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q)       # a CPU tensor: no fallback
    assert flash_attention_cuda.launches == before
