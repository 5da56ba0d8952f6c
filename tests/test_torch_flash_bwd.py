"""The backward of the banded flash attention (B5-bwd's plain version and
the autograd Function around it) on the CPU.

`flash_attention_bwd_plain` recomputes P from the forward's log-sum-exp,
block by block of keys, as the kernel `csrc/flash_tc_bwd.cu` does. It is
held against:
  * `torch.autograd` through the naive masked attention in f64, to 1e-10
    (the same function, a few hundred f64 operations apart);
  * `jax.grad` of the JAX package's `_chunked_attention` at f32: each of
    dq, dk, dv within 1e-5 x max |reference| (f32 sums in other orders,
    and the reference scales q before the product where the plain
    version scales the product);
(W = 1 is in the f64 cases only: there each row's one-key softmax has no
gradient, so the reference's dq is exactly 0 while P (dP - delta) leaves
f32 rounding; W = 2 stands in for it against JAX),
and the plain forward's lse is held against the reference's definition
(logsumexp of the masked scaled scores, in f64 numpy) to 1e-5 x
(1 + |lse|).
`FlashAttention` passes `torch.autograd.gradcheck` in f64. The cases span
W in {None, 0, 1, 7, 40 (< a 64-row tile), > T}, GQA groups {1, 2, 8},
ragged T and D in {16, 64, 128}."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _chunked_attention as jax_chunked
from repro_torch.kernels.local_attention import flash_attention
from repro_torch.kernels.local_attention import local_attention as la

WINDOWS = [None, 0, 1, 7, 40, 500]
GROUPS = [1, 2, 8]
HEAD_DIMS = [16, 64, 128]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Hq, Hkv, T, D, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, T, D)).astype(dtype)
            for h in (Hq, Hkv, Hkv, Hq)]


def _naive(q, k, v, W):
    """Masked softmax attention with masked probabilities 0 (a row with no
    live key gives 0, as the flash pass does)."""
    B, Hq, T, D = q.shape
    G = Hq // k.shape[1]
    kk, vv = (x.repeat_interleave(G, dim=1) for x in (k, v))
    s = q @ kk.transpose(-1, -2) / math.sqrt(D)
    pos = torch.arange(T)
    W = T if W is None else W
    live = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    p = torch.softmax(torch.where(live, s, -1e30), dim=-1)
    return torch.where(live, p, 0.0) @ vv


def _plain_grads(q, k, v, dout, W, block_k=32):
    T = q.shape[2]
    out, lse = la.flash_attention_plain(q, k, v, window=W, block_q=T,
                                        block_k=T, return_lse=True)
    return la.flash_attention_bwd_plain(q, k, v, out, lse, dout, window=W,
                                        block_k=block_k)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("W", WINDOWS)
def test_bwd_plain_matches_autograd_of_naive_in_f64(W, group, D):
    T = {16: 77, 64: 100, 128: 45}[D]
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(
        3 + group + D, 1, 2 * group, 2, T, D))
    got = _plain_grads(q, k, v, dout, W)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(_naive(qg, kg, vg, W), (qg, kg, vg), dout)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10,
                                   rtol=1e-10, err_msg=f"d{name}")


_jax_vjp = jax.jit(
    lambda q, k, v, dout, window, chunk: jax.vjp(
        lambda a, b, c: jax_chunked(a, b, c, window, chunk, chunk),
        q, k, v)[1](dout),
    static_argnums=(4, 5))


@pytest.mark.parametrize("W,group,D,T,chunk", [
    (None, 1, 16, 64, 16), (7, 2, 16, 48, 16), (40, 8, 64, 96, 32),
    (2, 2, 128, 64, 32), (500, 1, 64, 80, 80), (0, 2, 16, 32, 16),
    (None, 8, 128, 72, 72), (40, 1, 128, 128, 64)])
def test_bwd_plain_matches_jax_grad_of_chunked_attention(W, group, D, T,
                                                          chunk):
    q, k, v, dout = _inputs(11 + D + T, 2, 2 * group, 2, T, D, np.float32)
    want = _jax_vjp(*(jnp.asarray(a) for a in (q, k, v, dout)), W, chunk)
    got = _plain_grads(*(torch.from_numpy(a) for a in (q, k, v, dout)), W)
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-5 * max(np.abs(b).max(), 1e-30), (name, err)


@pytest.mark.parametrize("W,group,T", [(None, 1, 50), (1, 2, 33), (40, 8, 97),
                                        (500, 2, 64), (7, 1, 130)])
def test_plain_lse_matches_the_reference_definition(W, group, T):
    D = 16
    q, k, v, _ = _inputs(5 + T, 1, 2 * group, 2, T, D, np.float32)
    _, lse = la.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), window=W, block_q=T,
        block_k=T, return_lse=True)
    kk = np.repeat(k, group, axis=1).astype(np.float64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64) / math.sqrt(D), kk)
    pos = np.arange(T)
    Wt = T if W is None else W
    live = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - Wt)
    s = np.where(live, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_lse_is_inf_where_no_key_is_live():
    q, k, v, dout = (torch.from_numpy(a)
                     for a in _inputs(1, 1, 2, 1, 20, 16, np.float32))
    out, lse = la.flash_attention_plain(q, k, v, window=0, block_q=20,
                                        block_k=20, return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert bool(torch.isposinf(lse).all())
    for g in la.flash_attention_bwd_plain(q, k, v, out, lse, dout, window=0):
        assert torch.equal(g, torch.zeros_like(g))


@pytest.mark.parametrize("W,group,D,T", [(None, 1, 4, 12), (5, 2, 4, 11),
                                          (3, 4, 4, 10), (0, 2, 4, 8)])
def test_function_passes_gradcheck_in_f64(W, group, D, T):
    rng = np.random.default_rng(7 + T)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, h, T, D)))
               .requires_grad_() for h in (2 * group, 2, 2))
    assert torch.autograd.gradcheck(
        lambda a, b, c: la.FlashAttention.apply(a, b, c, W, T, T),
        (q, k, v))


def test_ops_flash_attention_is_differentiable_on_the_cpu():
    """ops.flash_attention on CPU tensors: the Function, the plain forward
    with its lse and the plain backward, one call of each."""
    q, k, v, dout = (torch.from_numpy(a)
                     for a in _inputs(2, 1, 4, 2, 64, 16, np.float32))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    fwd, bwd = la.flash_attention_plain.calls, la.flash_attention_bwd_plain.calls
    out = flash_attention(qg, kg, vg, window=9, block_q=32, block_k=32)
    assert out.grad_fn is not None
    out.backward(dout)
    assert (la.flash_attention_plain.calls - fwd,
            la.flash_attention_bwd_plain.calls - bwd) == (1, 1)
    ref = _plain_grads(q, k, v, dout, 9)
    for g, r in zip((qg.grad, kg.grad, vg.grad), ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6,
                                   rtol=1e-6)
