"""Where `attention_apply` sends each impl, at a sequence length that is
not a multiple of the kernel's 128-row blocks (T = 200, a prompt the
reference serves through `_naive_attention`).

On CUDA tensors "chunked" goes straight to `flash_attention_cuda` (both
kernels take any T), with no block check; a (dtype, head size) no kernel
is built for raises there, as every CUDA wrapper of the port does;
"pallas" keeps the reference wrapper's block rule. The CUDA side is posed by a CPU tensor that says it lives on a card
(as tests/test_torch_wavefront_warp.py does), with the kernel entry point
replaced by a recorder. On the CPU, "chunked" equals the JAX package's
`attention_apply` within the f32 tolerance of tests/test_torch_lm.py
(atol = rtol = 1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import attention as jattn
from repro_torch.kernels.local_attention import local_attention as la
from repro_torch.kernels.local_attention import ops as la_ops
from repro_torch.models import attention as tattn
from repro_torch.models.interop import params_from_jax

TOL = 1e-4
T = 200


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on a card."""

    @property
    def is_cuda(self):
        return True


def _setup(head_dim=None, seed=5):
    cfg = jcfg.get_config("gemma3-27b").reduced()
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    p = jattn.attention_init(jax.random.PRNGKey(seed), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((1, T, cfg.d_model)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)[None]
    return cfg, p, tp, x, pos


@pytest.fixture
def recorder(monkeypatch):
    """Replaces the kernel entry point and the block check by recorders;
    the kernel's stand-in returns q's values (the shape it would)."""
    calls = []

    def fake_kernel(q, k, v, *, window=None):
        calls.append(("kernel", tuple(q.shape), window))
        return q.as_subclass(torch.Tensor).clone()

    real_check = la.check_inputs

    def spy_check(*a, **kw):
        calls.append(("check_inputs",))
        return real_check(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_cuda", fake_kernel)
    monkeypatch.setattr(la, "check_inputs", spy_check)
    monkeypatch.setattr(la_ops, "check_inputs", spy_check)
    return calls


@pytest.mark.parametrize("window", [None, 64])
def test_chunked_on_cuda_reaches_the_kernel_without_the_block_check(
        recorder, window):
    cfg, _, tp, x, pos = _setup(head_dim=128)
    assert T % 128
    xc = torch.from_numpy(x).as_subclass(_FakeCuda)
    out = tattn.attention_apply(tp, cfg, xc, torch.from_numpy(pos),
                                window=window, impl="chunked")
    assert out.shape == (1, T, cfg.d_model)
    assert recorder == [("kernel", (1, cfg.n_heads, T, 128), window)]


def test_chunked_on_cuda_at_an_unbuilt_head_size_raises():
    """No route to PyTorch attention on the card: the kernel's route
    refuses a head size it was not built for, before any launch."""
    cfg, _, tp, x, pos = _setup(head_dim=48)
    assert 48 not in la.KERNEL_HEAD_DIMS
    xc = torch.from_numpy(x).as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match="D=48 not built"):
        tattn.attention_apply(tp, cfg, xc, torch.from_numpy(pos),
                              impl="chunked", q_chunk=512)


def test_pallas_keeps_the_block_rule_as_the_reference_does():
    cfg, p, tp, x, pos = _setup()
    with pytest.raises(ValueError, match="must divide block sizes"):
        jattn.attention_apply(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                              impl="pallas")
    for xt in (torch.from_numpy(x),
               torch.from_numpy(x).as_subclass(_FakeCuda)):
        with pytest.raises(ValueError, match="must divide block sizes"):
            tattn.attention_apply(tp, cfg, xt, torch.from_numpy(pos),
                                  impl="pallas")


@pytest.mark.parametrize("window,q_chunk", [(None, 512), (16, 512),
                                            (None, 100)])
def test_chunked_on_cpu_matches_jax_at_t200(window, q_chunk):
    """T <= q_chunk takes naive attention in both packages; q_chunk = 100
    takes the chunked loop (two query chunks)."""
    cfg, p, tp, x, pos = _setup(seed=9)
    a = jattn.attention_apply(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                              window=window, impl="chunked", q_chunk=q_chunk,
                              k_chunk=q_chunk)
    b = tattn.attention_apply(tp, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), window=window,
                              impl="chunked", q_chunk=q_chunk,
                              k_chunk=q_chunk)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=TOL)
