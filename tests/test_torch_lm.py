"""Parity of the port's language-model serving path (`repro_torch.models`,
`repro_torch.train`) with the JAX package's, on reduced configs of the
dense architectures. Parameters are made by the reference and carried
across with `params_from_jax`; every other input is made with numpy from
a seed and handed to both packages.

Tolerances: f32 paths agree to 1e-4 (atol and rtol) — the same function
computed in another order, a few hundred f32 operations deep, on values
of order 1-10; the embedding lookup and the cast helper are exact. bf16
paths compare in relative L2 per position (see the test)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data.tokens import TokenPipeline as JaxTokens
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train import train_step as jtrain
from repro_torch import configs as tcfg
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.interop import params_from_jax
from repro_torch.train import train_step as ttrain

TOL = 1e-4

# The reference's functions, compiled once per config (eager JAX
# dispatches op by op and would dominate these tests' time).
_j_apply = jax.jit(jmodel.model_apply, static_argnums=1)
_j_decode = jax.jit(jmodel.model_decode, static_argnums=1)
_j_attn_decode = jax.jit(jattn.attention_decode, static_argnums=1,
                         static_argnames=("window", "masked_write"))
DENSE = ["gemma3-27b", "qwen2.5-14b", "qwen3-0.6b", "stablelm-3b",
         "musicgen-medium", "paligemma-3b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_params(cfg, seed):
    p = jmodel.init_params(cfg, jax.random.PRNGKey(seed))
    return p, params_from_jax(jax.tree.map(np.asarray, p))


def _batch(cfg, rng, B, T):
    """The same batch for both packages: (jax dict, torch dict)."""
    if cfg.input_mode == "embeds":
        arrs = {"embeds": _rand(rng, B, T, cfg.d_model)}
    elif cfg.input_mode == "patch_prefix":
        arrs = {"patch_embeds": _rand(rng, B, cfg.num_prefix, cfg.d_model),
                "tokens": rng.integers(0, cfg.vocab_size,
                                       (B, T - cfg.num_prefix)).astype(
                                           np.int32)}
    else:
        arrs = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(
            np.int32)}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


# ---------------------------------------------------------------------------
# configs, data
# ---------------------------------------------------------------------------

def test_registry_is_the_references():
    assert tcfg.list_archs() == jcfg.list_archs()
    for name in jcfg.list_archs():
        a, b = jcfg.get_config(name), tcfg.get_config(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        assert dataclasses.asdict(a.reduced()) == \
            dataclasses.asdict(b.reduced()), name
        assert a.param_count() == b.param_count(), name
    assert {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}


def test_token_pipeline_is_the_references():
    for step in (0, 3):
        a = JaxTokens(257, 3, 40, seed=5).batch(step)["tokens"]
        b = TokenPipeline(257, 3, 40, seed=5).batch(step)["tokens"]
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 3, 5, 64), _rand(rng, 64)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    a = jlayers.rmsnorm_apply({"scale": jnp.asarray(s)},
                              jnp.asarray(x, jd), eps=1e-5)
    b = tlayers.rmsnorm_apply({"scale": torch.from_numpy(s)},
                              torch.from_numpy(x).to(td), eps=1e-5)
    assert b.dtype == td
    # f32 math in both; bf16 outputs round the same f32 values.
    _close(b, a, TOL if dtype == "float32" else 1e-2)


def test_dense_rope_and_mlps():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 6, 32)
    w, bias = _rand(rng, 32, 48), _rand(rng, 48)
    _close(tlayers.dense_apply({"w": torch.from_numpy(w),
                                "b": torch.from_numpy(bias)},
                               torch.from_numpy(x)),
           jlayers.dense_apply({"w": w, "b": bias}, jnp.asarray(x)))
    pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0)
    jt = jlayers.rope_tables(jnp.asarray(pos), 32, 1e6)
    tt = tlayers.rope_tables(torch.from_numpy(pos), 32, 1e6)
    _close(tt[0], jt[0])
    _close(tt[1], jt[1])
    xh = _rand(rng, 2, 3, 6, 32)
    _close(tlayers.apply_rope(torch.from_numpy(xh),
                              torch.from_numpy(pos)[:, None, :], 1e6),
           jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos)[:, None, :],
                              1e6))
    for kind in ("swiglu", "geglu", "gelu"):
        p = jlayers.mlp_init(jax.random.PRNGKey(2), 32, 64, kind=kind)
        _close(tlayers.mlp_apply(params_from_jax(jax.tree.map(np.asarray, p)),
                                 torch.from_numpy(x), kind=kind),
               jlayers.mlp_apply(p, jnp.asarray(x), kind=kind))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_gather_equals_onehot(dtype):
    """The reference multiplies a one-hot matrix by the table at vocab
    >= 8,192; the port gathers. Exactly one non-zero product per sum, so
    the two are equal, bit for bit."""
    rng = np.random.default_rng(2)
    table = _rand(rng, 8192, 16)
    toks = rng.integers(0, 8192, (3, 50)).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    a = jlayers.embed_apply({"table": jnp.asarray(table)}, jnp.asarray(toks),
                            jd, method="onehot", chunk=64)
    b = tlayers.embed_apply({"table": torch.from_numpy(table)},
                            torch.from_numpy(toks), td)
    np.testing.assert_array_equal(_np(b), _np(a))
    _close(tlayers.embed_attend({"table": torch.from_numpy(table)},
                                b.float()),
           jlayers.embed_attend({"table": jnp.asarray(table)},
                                a.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(seed, B=2, Hq=4, Hkv=2, T=128, D=16):
    rng = np.random.default_rng(seed)
    return [_rand(rng, B, h, T, D) for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("window", [None, 64, 17])
def test_naive_and_chunked_attention(window):
    arrs = _qkv(3)
    jq, jk, jv = map(jnp.asarray, arrs)
    q, k, v = map(torch.from_numpy, arrs)
    _close(tattn._naive_attention(q, k, v, window),
           jattn._naive_attention(jq, jk, jv, window))
    _close(tattn._chunked_attention(q, k, v, window, 32, 32),
           jattn._chunked_attention(jq, jk, jv, window, 32, 32))
    _close(tattn._chunked_attention(q, k, v, window, 32, 32),
           tattn._naive_attention(q, k, v, window))


def test_chunked_attention_bf16_scales_q_in_bf16():
    """The reference scales q in the compute dtype before the products;
    the port rounds the same way, so bf16 outputs agree to bf16 output
    rounding (one ulp: 2^-8 relative)."""
    arrs = _qkv(4)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    a = jattn._chunked_attention(jq, jk, jv, 17, 32, 32)
    b = tattn._chunked_attention(q, k, v, 17, 32, 32)
    np.testing.assert_allclose(_np(b), _np(a), atol=2 ** -8, rtol=2 ** -8)


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_attention_apply(impl):
    cfg = dataclasses.replace(jcfg.get_config("gemma3-27b").reduced(),
                              attn_impl=impl)
    p = jattn.attention_init(jax.random.PRNGKey(5), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 64, cfg.d_model)
    pos = np.arange(64, dtype=np.int32)[None].repeat(2, 0)
    for window in (None, 16):
        a = jattn.attention_apply(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                                  window=window, impl=impl, q_chunk=32,
                                  k_chunk=32)
        b = tattn.attention_apply(tp, cfg, torch.from_numpy(x),
                                  torch.from_numpy(pos), window=window,
                                  impl=impl, q_chunk=32, k_chunk=32)
        _close(b, a)


@pytest.mark.parametrize("window,masked",
                         [(None, False), (None, True), (8, False), (8, True)])
def test_attention_decode_ring_and_full(window, masked):
    """20 steps from empty caches of max_len 20: the full cache fills, the
    ring of width 8 wraps twice. Outputs and the caches themselves agree."""
    cfg = jcfg.get_config("qwen2.5-14b").reduced()
    p = jattn.attention_init(jax.random.PRNGKey(7), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    jc = jattn.init_kv_cache(2, cfg, 20, window=window, dtype=jnp.float32)
    tc = tattn.init_kv_cache(2, cfg, 20, window=window, dtype=torch.float32)
    rng = np.random.default_rng(8)
    for _ in range(20):
        x = _rand(rng, 2, 1, cfg.d_model)
        ya, jc = _j_attn_decode(p, cfg, jnp.asarray(x), jc,
                                        window=window, masked_write=masked)
        yb, tc = tattn.attention_decode(tp, cfg, torch.from_numpy(x), tc,
                                        window=window, masked_write=masked)
        _close(yb, ya)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert int(tc.length) == int(jc.length) == 20
    # The reference's cache carried across continues the same decode.
    tc = params_from_jax(jax.tree.map(np.asarray, jc))
    assert isinstance(tc, tattn.KVCache) and tc.length.dtype == torch.int32
    x = _rand(rng, 2, 1, cfg.d_model)
    ya, _ = _j_attn_decode(p, cfg, jnp.asarray(x), jc, window=window,
                           masked_write=masked)
    yb, _ = tattn.attention_decode(tp, cfg, torch.from_numpy(x), tc,
                                   window=window, masked_write=masked)
    _close(yb, ya)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_init_params_has_the_references_tree(arch):
    cfg = tcfg.get_config(arch).reduced()
    jp = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.PRNGKey(0)))
    tp = tmodel.init_params(cfg, 0, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = tmodel.tree_map(lambda a: tuple(a.shape), tp)
    assert jshapes == tshapes
    bf = tmodel.init_params(cfg, 0, torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.bfloat16
               for t in _leaves(bf)), "made directly in the working dtype"


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", DENSE)
def test_model_apply_and_decode_match_jax(arch):
    cfg = jcfg.get_config(arch).reduced()
    jp, tp = _jax_params(cfg, 9)
    rng = np.random.default_rng(10)
    jb, tb = _batch(cfg, rng, 2, 64)
    _close(tmodel.model_apply(tp, cfg, tb), _j_apply(jp, cfg, jb))

    jc = jmodel.init_cache(cfg, 2, 24, dtype=jnp.float32)
    tc = tmodel.init_cache(cfg, 2, 24, torch.float32, device="cpu")
    for t in range(24):
        if cfg.input_mode == "embeds":
            x = _rand(rng, 2, 1, cfg.d_model)
            jb, tb = {"embeds": jnp.asarray(x)}, {"embeds": torch.from_numpy(x)}
        else:
            x = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
            jb, tb = {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x)}
        ja, jc = _j_decode(jp, cfg, jb, jc)
        tb_, tc = tmodel.model_decode(tp, cfg, tb, tc)
        _close(tb_, ja)


@pytest.mark.parametrize("arch", ["gemma3-27b", "qwen3-0.6b"])
def test_decode_matches_forward_teacher_forcing(arch):
    """The port's own check (as tests/test_archs_smoke.py's): per-token
    decode reproduces the prefill logits; T = 64 > window 16, so every
    local layer's ring buffer wraps."""
    cfg = tcfg.get_config(arch).reduced()
    params = tmodel.init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    ref = tmodel.model_apply(params, cfg, {"tokens": toks})
    cache = tmodel.init_cache(cfg, 2, 64, torch.float32, device="cpu")
    outs = []
    for t in range(64):
        lg, cache = tmodel.model_decode(params, cfg,
                                        {"tokens": toks[:, t:t + 1]}, cache)
        outs.append(lg)
    _close(torch.cat(outs, dim=1), ref, 2e-3)   # the reference test's bound


def test_prefill_and_serve_steps_match_jax_f32():
    cfg = jcfg.get_config("gemma3-27b").reduced()
    jp, tp = _jax_params(cfg, 12)
    rng = np.random.default_rng(13)
    jb, tb = _batch(cfg, rng, 2, 64)
    for last_only in (True, False):
        a = jax.jit(jtrain.make_prefill_step(
            cfg, compute_dtype=jnp.float32, last_only=last_only))(jp, jb)
        b = ttrain.make_prefill_step(cfg, compute_dtype=torch.float32,
                                     last_only=last_only)(tp, tb)
        assert b.shape == a.shape and b.dtype == torch.float32
        _close(b, a)
    jserve = jax.jit(jtrain.make_serve_step(cfg, compute_dtype=jnp.float32,
                                            masked_cache_write=True))
    tserve = ttrain.make_serve_step(cfg, compute_dtype=torch.float32,
                                    masked_cache_write=True)
    jc = jmodel.init_cache(cfg, 2, 20, dtype=jnp.float32)
    tc = tmodel.init_cache(cfg, 2, 20, torch.float32, device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    for t in range(20):
        a, jc = jserve(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
        b, tc = tserve(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, tc)
        _close(b, a)


def _rel_l2(got, want):
    """Relative L2 error per position: ||got - want|| / ||want|| over the
    vocab axis."""
    g, w = _np(got), _np(want)
    return np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)


def test_prefill_and_serve_steps_match_jax_bf16():
    """bf16 compute in both packages. The frameworks round at different
    places (XLA fuses and keeps f32 inside a fusion, PyTorch rounds after
    each op), so logits agree to bf16 precision, not bit for bit: relative
    L2 per position <= 2^-4 (the bf16 unit roundoff 2^-9 times 32, for the
    roundings of two layers and the head)."""
    cfg = jcfg.get_config("gemma3-27b").reduced()
    jp, tp = _jax_params(cfg, 14)
    rng = np.random.default_rng(15)
    jb, tb = _batch(cfg, rng, 2, 64)
    a = jax.jit(jtrain.make_prefill_step(cfg, last_only=False))(jp, jb)
    b = ttrain.make_prefill_step(cfg, last_only=False)(tp, tb)
    assert _rel_l2(b, a).max() <= 2 ** -4
    jc = jmodel.init_cache(cfg, 2, 8)
    tc = tmodel.init_cache(cfg, 2, 8, device="cpu")
    jserve = jax.jit(jtrain.make_serve_step(cfg))
    tserve = ttrain.make_serve_step(cfg)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    for t in range(8):
        a, jc = jserve(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
        b, tc = tserve(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, tc)
        assert _rel_l2(b, a).max() <= 2 ** -4


def test_cast_params_keeps_tensors_of_the_right_dtype():
    cfg = tcfg.get_config("qwen3-0.6b").reduced()
    bf = tmodel.init_params(cfg, 0, torch.bfloat16, device="cpu")
    same = ttrain._cast_params(bf, torch.bfloat16)
    assert all(a is b for a, b in zip(_leaves(bf), _leaves(same)))
    f32 = ttrain._cast_params(bf, torch.float32)
    assert all(t.dtype == torch.float32 for t in _leaves(f32))


@pytest.mark.parametrize("arch,item", [
    ("mixtral-8x22b", "A11a"), ("qwen2-moe-a2.7b", "A11a"),
    ("recurrentgemma-9b", "A11b"), ("xlstm-125m", "A11b")])
def test_unported_kinds_raise(arch, item):
    """The MoE (ROADMAP A11a) and recurrent (A11b) kinds build now: their
    architectures' params and caches have the reference's trees; only a
    kind no architecture names raises, `ValueError` as in the
    reference."""
    cfg = tcfg.get_config(arch).reduced()
    kinds = {"A11a": ("moe", "moe_swa"), "A11b": ("rglru", "mlstm", "slstm")}
    assert set(cfg.pattern) & set(kinds[item])
    tp = tmodel.init_params(cfg, 0, device="cpu")
    jp = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.PRNGKey(0)))
    assert tmodel.tree_map(lambda a: tuple(a.shape), tp) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    tc = tmodel.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    jc = jax.eval_shape(lambda: jmodel.init_cache(cfg, 1, 8, jnp.float32))
    assert tmodel.tree_map(lambda a: tuple(a.shape), tc) == \
        jax.tree.map(lambda a: tuple(a.shape), jc)
    with pytest.raises(ValueError, match="unknown block kind"):
        tblocks.block_cache_init(cfg, "conv", 1, 8)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="unknown block kind"):
        tblocks.block_init(gen, cfg, "conv")


@pytest.mark.parametrize("arch", tcfg.list_archs())
def test_every_registry_arch_builds_and_serves(arch):
    """Every architecture of the registry builds its params and caches on
    the CPU and runs a prefill and two decode steps to finite logits."""
    cfg = tcfg.get_config(arch).reduced()
    params = tmodel.init_params(cfg, 1, device="cpu")
    rng = np.random.default_rng(16)
    _, tb = _batch(cfg, rng, 2, 16)
    logits = tmodel.model_apply(params, cfg, tb)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    cache = tmodel.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    for _ in range(2):
        if cfg.input_mode == "embeds":
            step = {"embeds": torch.from_numpy(_rand(rng, 2, 1, cfg.d_model))}
        else:
            step = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, 1)).astype(np.int32))}
        lg, cache = tmodel.model_decode(params, cfg, step, cache)
        assert lg.shape == (2, 1, cfg.vocab_size)
        assert bool(torch.isfinite(lg).all())
