"""Parity of the port's optimiser (`repro_torch.optim`) with the JAX
package's: schedules, AdamW with global-norm clipping, int8 gradient
compression with error feedback. Both sides get the same params and
gradients, made with numpy from a seed; the port's update runs in place.

Tolerance: f32 results within 1e-6 relative (the same f32 operations;
PyTorch may fuse a multiply-add where XLA rounds twice), bf16 moments
within one bf16 ulp; the step counter and int8 payloads exactly. Also the
JAX package's own tests of tests/test_runtime.py (int8 round trip, error
feedback convergence, cosine shape), ported."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedules as jsched
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import schedules as tsched
from repro_torch.optim import (adamw_init, adamw_update, compress_int8,
                               cosine_schedule, decompress_int8,
                               error_feedback_update)

REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _tree(seed, scale=1.0):
    """A small params-like tree (nested dicts, 1-d to 3-d leaves), keys in
    sorted order so that both packages list the leaves alike."""
    rng = np.random.default_rng(seed)
    return {"embed": {"table": scale * rng.standard_normal((11, 8))},
            "final_norm": {"scale": scale * rng.standard_normal(8)},
            "periods": {"pos0": {"b": scale * rng.standard_normal((3, 5)),
                                 "w": scale * rng.standard_normal((3, 8, 5))}}}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    return fn(np.asarray(tree, np.float32))


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 50), (100, 10_000)])
def test_schedules_match_the_reference(warmup, total):
    for step in (0, 1, warmup - 1, warmup, warmup + 3, total // 2, total,
                 total + 7):
        _close(tsched.linear_warmup(torch.tensor(step, dtype=torch.int32),
                                    warmup, 3e-4),
               jsched.linear_warmup(jnp.int32(step), warmup, 3e-4))
        _close(cosine_schedule(torch.tensor(step, dtype=torch.int32),
                               peak_lr=3e-4, warmup_steps=warmup,
                               total_steps=total),
               jsched.cosine_schedule(jnp.int32(step), peak_lr=3e-4,
                                      warmup_steps=warmup,
                                      total_steps=total))


@pytest.mark.parametrize("max_norm,scale", [(1.0, 1.0), (1.0, 0.01),
                                            (5.0, 3.0)])
def test_global_norm_and_clipping_match_the_reference(max_norm, scale):
    g = _tree(3, scale)
    jg, tg = _as(g, jnp.asarray), _as(g, torch.from_numpy)
    _close(tadamw.global_norm(tg), jadamw.global_norm(jg))
    (tc, tn), (jc, jn) = (tadamw.clip_by_global_norm(tg, max_norm),
                          jadamw.clip_by_global_norm(jg, max_norm))
    _close(tn, jn)
    for a, b in zip(tadamw.tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


@pytest.mark.parametrize("moments", [None, "bfloat16"])
def test_adamw_steps_match_the_reference(moments):
    """Three AdamW steps from the same params on the same gradients, the
    cosine schedule's lr: new params, m, v and step."""
    p0 = _tree(0)
    jp = _as(p0, jnp.asarray)
    tp = _as(p0, torch.from_numpy)
    jstate = jadamw.adamw_init(jp, getattr(jnp, moments) if moments else None)
    tstate = adamw_init(tp, getattr(torch, moments) if moments else None)
    for i in range(3):
        g = _tree(10 + i, scale=0.5 + i)
        jlr = jsched.cosine_schedule(jstate["step"], peak_lr=1e-2,
                                     warmup_steps=2, total_steps=10)
        tlr = cosine_schedule(tstate["step"], peak_lr=1e-2, warmup_steps=2,
                              total_steps=10)
        jp, jstate, jm = jadamw.adamw_update(jp, _as(g, jnp.asarray), jstate,
                                             lr=jlr)
        tp_out, tstate_out, tm = adamw_update(tp, _as(g, torch.from_numpy),
                                              tstate, lr=tlr)
        assert tp_out is tp and tstate_out is tstate       # in place
        _close(tm["grad_norm"], jm["grad_norm"])
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        for a, b in zip(tadamw.tree_leaves(tp), jax.tree.leaves(jp)):
            _close(a, b)
        for key in ("m", "v"):
            for a, b in zip(tadamw.tree_leaves(tstate[key]),
                            jax.tree.leaves(jstate[key])):
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
                # bf16 moments: the same f32 value rounded once (one ulp).
                _close(a, np.asarray(b, np.float32),
                       rel=2 ** -8 if moments else REL)


def test_compress_int8_matches_the_reference():
    rng = np.random.default_rng(4)
    for g in (rng.standard_normal(257).astype(np.float32),
              np.array([-3.0, 0.0, 1.5, 3.0], np.float32),
              np.linspace(-2.5, 2.5, 255, dtype=np.float32),
              np.zeros(5, np.float32)):
        tq, ts = compress_int8(torch.from_numpy(g))
        jq, js = jgc.compress_int8(jnp.asarray(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        _close(ts, js)
        _close(decompress_int8(tq, ts), jgc.decompress_int8(jq, js))
    err = np.zeros(257, np.float32)
    g = rng.standard_normal(257).astype(np.float32)
    tq, ts, terr = error_feedback_update(torch.from_numpy(g),
                                         torch.from_numpy(err))
    jq, js, jerr = jgc.error_feedback_update(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _close(terr, jerr)
    buf = tgc.init_error_buffer({"a": torch.ones(3, dtype=torch.bfloat16)})
    assert buf["a"].dtype == torch.float32 and not buf["a"].any()


# The JAX package's tests/test_runtime.py cases, ported.

def test_grad_compression_error_feedback_converges():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    err = torch.zeros_like(g_true)
    acc_hat = torch.zeros_like(g_true)
    for _ in range(50):
        q, scale, err = error_feedback_update(g_true, err)
        acc_hat = acc_hat + decompress_int8(q, scale)
    rel = float((acc_hat / 50 - g_true).norm() / g_true.norm())
    assert rel < 1e-2


def test_int8_roundtrip_bounds():
    x = torch.tensor([-3.0, 0.0, 1.5, 3.0])
    q, s = compress_int8(x)
    back = decompress_int8(q, s)
    assert float((back - x).abs().max()) <= float(s) / 2 + 1e-6


def test_cosine_schedule_shape():
    lrs = [float(cosine_schedule(s, peak_lr=1.0, warmup_steps=10,
                                 total_steps=100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0      # warmup
    assert abs(lrs[10] - 1.0) < 0.05   # peak
    assert lrs[-1] < 0.2               # decay
    assert min(lrs) >= 0.0
