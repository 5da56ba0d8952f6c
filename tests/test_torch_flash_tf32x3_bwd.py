"""The split-TF32 route of the banded flash attention under autograd, on
the CPU.

* `flash_attention_bwd_plain` (the plain version of both backward kernels)
  against `jax.grad` of the JAX package's `_chunked_attention` at the head
  sizes the split-TF32 route takes beyond `test_torch_flash_bwd.py`'s
  (D 80, stablelm-3b's; D 256), in f32: each of dq, dk, dv within 1e-5 x
  max |reference| (f32 sums in other orders, and the reference scales q
  before the product where the plain version scales the product).
* The wrappers with their entry points replaced by recorders and the
  inputs made to say they live on a card (`torch_parity.fake_cuda`): where
  autograd would record it, `flash_attention_cuda` goes through
  `FlashAttention`, whose forward reaches, for f32,
  `flash_attention_tf32x3_launch` and, for bf16 at D 16 and 80 (the head
  sizes the split-TF32 route took in bf16 until the wgmma kernel was
  built for them), `flash_attention_tc_launch`, each with a non-null lse
  (B, Hq, T) f32, and whose backward reaches, for f32,
  `flash_attention_bwd_tf32x3_launch` with q, k, v, the forward's output
  and lse, dO, the three gradients and a delta scratch, and for bf16
  B5-bwd's `flash_attention_bwd_tc_launch` with the same and B5-bwd's
  scratch (the padded per-row vectors, an f32 dQ accumulator); no plain
  version runs. Without autograd the split forward's lse pointer is null.
  The split-TF32 backward's wrapper refuses bf16."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _chunked_attention as jax_chunked
from repro_torch.kernels.local_attention import local_attention as la
from torch_parity import fake_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Hq, Hkv, T, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, T, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv, Hq)]


_jax_vjp = jax.jit(
    lambda q, k, v, dout, window, chunk: jax.vjp(
        lambda a, b, c: jax_chunked(a, b, c, window, chunk, chunk),
        q, k, v)[1](dout),
    static_argnums=(4, 5))


@pytest.mark.parametrize("W,group,D,T,chunk", [
    (None, 1, 80, 64, 16), (7, 2, 80, 48, 16), (40, 8, 80, 96, 32),
    (2, 2, 80, 64, 32), (500, 1, 80, 80, 80), (None, 2, 256, 48, 16),
    (40, 1, 256, 64, 32)])
def test_bwd_plain_matches_jax_grad_at_the_split_routes_head_sizes(
        W, group, D, T, chunk):
    q, k, v, dout = _inputs(17 + D + T, 2, 2 * group, 2, T, D)
    want = _jax_vjp(*(jnp.asarray(a) for a in (q, k, v, dout)), W, chunk)
    out, lse = la.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), window=W, block_q=T,
        block_k=T, return_lse=True)
    got = la.flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), out, lse,
        torch.from_numpy(dout), window=W)
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-5 * max(np.abs(b).max(), 1e-30), (name, err)


@pytest.fixture
def entry_points(monkeypatch):
    """The kernel entry points replaced by recorders of (name, the
    pointer arguments as the tensors passed, the int arguments)."""
    calls = []

    def recorder(name, n_ptr):
        def record(*args):
            calls.append((name, args[:n_ptr], args[n_ptr:-1]))
            return 0
        return record

    def lib(lib_name, fn, n_int, n_ptr=4):
        return recorder(fn, n_ptr)

    # `_call` hands the C function data_ptr()s; keep the tensors instead.
    def call(fn, ptrs, ints, what):
        assert fn(*ptrs, *ints, 7) == 0

    monkeypatch.setattr(la, "_lib", lib)
    monkeypatch.setattr(la, "_call", call)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    return calls


@pytest.mark.parametrize("dtype,D", [(torch.float32, 16),
                                     (torch.float32, 80),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 80)])
def test_route_under_autograd_reaches_both_entry_points(entry_points, dtype,
                                                        D):
    B, Hq, Hkv, T, W = 2, 4, 2, 24, 9
    q = fake_cuda(torch.zeros(B, Hq, T, D, dtype=dtype).requires_grad_())
    k, v = (fake_cuda(torch.zeros(B, Hkv, T, D, dtype=dtype))
            for _ in range(2))
    bf16 = dtype == torch.bfloat16
    route = "tc" if bf16 else "tf32x3"
    assert la.kernel_route(dtype, D) == route
    assert la.bwd_route(dtype, D) == route
    fwd = la.flash_attention_tc_cuda if bf16 \
        else la.flash_attention_tf32x3_cuda
    bwd = la.flash_attention_bwd_tc_cuda if bf16 \
        else la.flash_attention_bwd_tf32x3_cuda
    plain = (la.flash_attention_plain.calls,
             la.flash_attention_bwd_plain.calls)
    launches = (fwd.launches, bwd.launches)
    out = la.flash_attention_cuda(q, k, v, window=W)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (name, ptrs, ints), = entry_points
    assert name == f"flash_attention_{route}_launch"
    lse = ptrs[4]
    assert lse is not None and lse.shape == (B, Hq, T) \
        and lse.dtype == torch.float32
    assert ints == (B, Hq, Hkv, T, D, W)
    out.backward(torch.ones_like(out))
    name, ptrs, ints = entry_points[1]
    assert len(entry_points) == 2
    assert ptrs[4] is lse and ptrs[3].shape == q.shape
    assert [p.shape for p in ptrs[6:9]] == [q.shape, k.shape, v.shape]
    if bf16:
        assert name == "flash_attention_bwd_tc_launch" and len(ptrs) == 11
        t_pad = -(-T // la.BWD_ROW_PAD) * la.BWD_ROW_PAD
        assert ptrs[9].shape == (2, B * Hq, t_pad)
        assert ptrs[10].shape == q.shape and ptrs[10].dtype == torch.float32
    else:
        assert name == "flash_attention_bwd_tf32x3_launch" and len(ptrs) == 10
        assert ptrs[9].shape == (B, Hq, T)
    assert ptrs[9].dtype == torch.float32
    assert ints == (B, Hq, Hkv, T, D, W)
    assert (la.flash_attention_plain.calls,
            la.flash_attention_bwd_plain.calls) == plain
    assert (fwd.launches - launches[0],
            bwd.launches - launches[1]) == (1, 1)


def test_serving_launch_passes_no_lse(entry_points):
    q = fake_cuda(torch.zeros(1, 2, 16, 80))
    with torch.no_grad():
        la.flash_attention_tf32x3_cuda(q, q, q, window=None)
    (name, ptrs, ints), = entry_points
    assert name == "flash_attention_tf32x3_launch" and ptrs[4] is None
    assert ints == (1, 2, 2, 16, 80, 16)


@pytest.mark.parametrize("D", [16, 80])
def test_split_backward_refuses_bf16(entry_points, D):
    """bf16's backward is B5-bwd: the split-TF32 backward's wrapper raises
    on bf16 and launches nothing."""
    q = fake_cuda(torch.zeros(1, 2, 16, D, dtype=torch.bfloat16))
    lse = fake_cuda(torch.zeros(1, 2, 16))
    before = la.flash_attention_bwd_tf32x3_cuda.launches
    with pytest.raises(ValueError, match="one dtype in"):
        la.flash_attention_bwd_tf32x3_cuda(q, q, q, q, lse, q)
    assert entry_points == []
    assert la.flash_attention_bwd_tf32x3_cuda.launches == before
