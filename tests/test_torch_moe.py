"""Parity of the port's MoE layer and MoE architectures
(`repro_torch.models.moe`, the `moe` / `moe_swa` block kinds) with the
JAX package's, on reduced configs of mixtral-8x22b and qwen2-moe-a2.7b.
Parameters are made by the reference and carried across with
`params_from_jax`; every other input is made with numpy from a seed.

Tolerances: f32 values agree to 1e-4 (atol and rtol), `test_torch_lm.py`'s
TOL. Routing indices (each token's top-k experts, each expert's top-C
tokens) are equal; where a reference value sits within 1e-6 of the next
one at the k-th / C-th place (an f32 flip would be possible there) the test
fails and names it, unless the two are exactly equal, which the tie rule
decides (the lower index first)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tcfg
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.interop import params_from_jax

TOL = 1e-4
MOE = ["mixtral-8x22b", "qwen2-moe-a2.7b"]

_j_moe = jax.jit(jmoe.moe_apply, static_argnums=1,
                 static_argnames=("capacity_factor", "token_chunk"))
_j_apply = jax.jit(jmodel.model_apply, static_argnums=1)
_j_decode = jax.jit(jmodel.model_decode, static_argnums=1)
_j_block_apply = jax.jit(jblocks.block_apply, static_argnums=(1, 2))
_j_block_decode = jax.jit(jblocks.block_decode, static_argnums=(1, 2))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _layer(cfg, seed):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), cfg)
    return p, _carry(p)


def _jax_routing(p, cfg, xf, capacity_factor=1.25):
    """The reference's routing values, step for step as `moe_apply`
    forms them (it does not return them)."""
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    N = xf.shape[0]
    logits = jlayers.dense_apply(p["router"], xf).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_i = jax.lax.top_k(probs, k)
    if cfg.moe_renormalize:
        top_p = top_p / jnp.clip(top_p.sum(-1, keepdims=True), 1e-9)
    w = (jax.nn.one_hot(top_i, E, dtype=jnp.float32)
         * top_p[..., None]).sum(axis=1)
    C = min(max(1, int(capacity_factor * N * k / E)), N)
    _, idx = jax.lax.top_k(w.T, C)
    return (np.asarray(probs), np.asarray(top_i), np.asarray(w),
            np.asarray(idx))


def _assert_margin(values, k, what):
    """At the k-th place of each row, the reference's value is either
    exactly tied with the next (the tie rule decides) or apart from it by
    more than f32 noise."""
    s = -np.sort(-values, axis=-1)
    if k >= s.shape[-1]:
        return
    gap = s[..., k - 1] - s[..., k]
    bad = (gap != 0) & (gap <= 1e-6)
    assert not bad.any(), f"{what}: a float flip is possible at rows " \
        f"{np.nonzero(bad)[0].tolist()}"


def _check_routing(jp, tp, cfg, x, capacity_factor=1.25):
    xf = x.reshape(-1, cfg.d_model)
    probs, top_i, w, idx = _jax_routing(jp, cfg, jnp.asarray(xf),
                                        capacity_factor)
    r = tmoe.route(tp, cfg, torch.from_numpy(xf),
                   capacity_factor=capacity_factor)
    _assert_margin(probs, cfg.moe_top_k, "top-k of the router")
    _assert_margin(w.T, idx.shape[1], "capacity top-C")
    np.testing.assert_array_equal(r["top_i"].numpy(), top_i)
    np.testing.assert_array_equal(r["idx"].numpy(), idx)
    _close(r["w"], w)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("B,T", [(2, 16), (1, 5), (3, 1)])
def test_moe_apply_matches_jax(arch, B, T):
    """Prefill-sized and decode-sized token counts (3 x 1: capacity 1, so
    each expert serves one row)."""
    cfg = jcfg.get_config(arch).reduced()
    jp, tp = _layer(cfg, 1)
    x = np.random.default_rng(2).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    _check_routing(jp, tp, cfg, x)
    _close(tmoe.moe_apply(tp, cfg, torch.from_numpy(x)),
           _j_moe(jp, cfg, jnp.asarray(x)))


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_has_the_references_tree(arch):
    cfg = tcfg.get_config(arch).reduced()
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jmoe.moe_init(jax.random.PRNGKey(0), cfg)))
    gen = torch.Generator().manual_seed(0)
    tshapes = tmodel.tree_map(lambda a: tuple(a.shape),
                              tmoe.moe_init(gen, cfg))
    assert jshapes == tshapes
    stacked = tmoe.moe_init(gen, cfg, torch.bfloat16, lead=(3,))
    assert stacked["gate"].shape == (3, *tshapes["gate"])
    assert stacked["router"]["w"].dtype == torch.bfloat16


def test_top_k_ties_go_to_the_lower_index():
    """`jax.lax.top_k` keeps the lower index first on ties; the port's
    `_top_k` does too (`torch.topk` need not)."""
    w = np.array([[0, .5, 0, .5, 0, .2, 0]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(w), 4)
    _, got = tmoe._top_k(torch.from_numpy(w), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[1, 3, 5, 0]]


@pytest.mark.parametrize("renorm", [True, False])
def test_tied_routing_through_moe_apply(renorm):
    """Ties at both top-k places. 7 experts, top 4; router columns 1 and 3
    are one column, and 0, 2, 4, 6 another, so every token's probabilities
    tie; rows 0 and 1 (and 2 and 5) are the same token, so the experts'
    routing weights tie between rows at the capacity place (capacity
    factor 0.25 gives C = 1 at 6 tokens: each expert serves one row, and
    the lower row wins; 1.25 gives C = 4)."""
    cfg = dataclasses.replace(jcfg.get_config("qwen2-moe-a2.7b").reduced(),
                              moe_num_experts=7, moe_top_k=4,
                              moe_renormalize=renorm)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), cfg)
    rw = np.asarray(jp["router"]["w"]).copy()
    rw[:, 3] = rw[:, 1]
    rw[:, 2] = rw[:, 4] = rw[:, 6] = rw[:, 0]
    jp["router"]["w"] = jnp.asarray(rw)
    tp = _carry(jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 6, cfg.d_model)).astype(np.float32)
    x[0, 1] = x[0, 0]
    x[0, 5] = x[0, 2]
    assert tmoe.capacity(cfg, 6, 0.25) == 1 and tmoe.capacity(cfg, 6) == 4
    _check_routing(jp, tp, cfg, x, capacity_factor=0.25)
    _check_routing(jp, tp, cfg, x)
    for cf in (0.25, 1.25):
        _close(tmoe.moe_apply(tp, cfg, torch.from_numpy(x),
                              capacity_factor=cf),
               _j_moe(jp, cfg, jnp.asarray(x), capacity_factor=cf))


@pytest.mark.parametrize("N,k,E", [(6, 4, 60), (11, 4, 60), (12, 4, 60),
                                   (64, 2, 8), (8192, 4, 60), (3, 2, 8)])
def test_capacity_is_the_references_expression(N, k, E):
    cfg = dataclasses.replace(tcfg.get_config("qwen2-moe-a2.7b"),
                              moe_top_k=k, moe_num_experts=E)
    assert tmoe.capacity(cfg, N) == min(max(1, int(1.25 * N * k / E)), N)
    if E == 60 and N <= 11:
        assert tmoe.capacity(cfg, N) == 1


def test_token_chunking_is_exact_when_capacity_does_not_bind():
    """As the reference's test: 64 tokens in chunks of 16 equal one pass
    when no token is dropped; and the chunked pass equals the reference's
    chunked pass (capacity per chunk)."""
    cfg = jcfg.get_config("mixtral-8x22b").reduced()
    jp, tp = _layer(cfg, 6)
    x = np.random.default_rng(7).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    full = tmoe.moe_apply(tp, cfg, tx, capacity_factor=8.0,
                          token_chunk=10_000)
    chunked = tmoe.moe_apply(tp, cfg, tx, capacity_factor=8.0,
                             token_chunk=16)
    _close(chunked, full, 2e-5)
    for cf in (8.0, 1.25):
        _close(tmoe.moe_apply(tp, cfg, tx, capacity_factor=cf,
                              token_chunk=16),
               _j_moe(jp, cfg, jnp.asarray(x), capacity_factor=cf,
                      token_chunk=16))


def test_combine_equals_a_scatter_add():
    """The per-token gather-and-add gives what an `index_add_` over the
    (E, C) rows gives — rows weighted by `combine`, so a kept token that did
    not choose the expert adds 0, as in `moe_apply` — and the same bits in
    every call."""
    cfg = jcfg.get_config("qwen2-moe-a2.7b").reduced()
    _, tp = _layer(cfg, 8)
    xf = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (40, cfg.d_model)).astype(np.float32))
    r = tmoe.route(tp, cfg, xf)
    E, C = r["idx"].shape
    out = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (E, C, cfg.d_model)).astype(np.float32)) * r["combine"][..., None]
    got = tmoe._combine_by_token(out, r["idx"], r["top_i"])
    want = torch.zeros((40, cfg.d_model)).index_add_(
        0, r["idx"].reshape(-1), out.reshape(E * C, -1))
    _close(got, want, 1e-6)
    assert torch.equal(got, tmoe._combine_by_token(out, r["idx"],
                                                   r["top_i"]))


@pytest.mark.parametrize("arch", MOE)
def test_zero_input_and_load_balancing_loss(arch):
    cfg = jcfg.get_config(arch).reduced()
    jp, tp = _layer(cfg, 5)
    x = np.random.default_rng(11).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    _close(tmoe.load_balancing_loss(tp, cfg, torch.from_numpy(x)),
           jmoe.load_balancing_loss(jp, cfg, jnp.asarray(x)))
    y0 = tmoe.moe_apply(tp, cfg, torch.zeros((2, 16, cfg.d_model)))
    np.testing.assert_allclose(_np(y0), 0.0, atol=1e-6)


# ---------------------------------------------------------------------------
# blocks and whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,arch", [("moe", "qwen2-moe-a2.7b"),
                                       ("moe_swa", "mixtral-8x22b")])
def test_moe_block_apply_decode_and_cache(kind, arch):
    cfg = jcfg.get_config(arch).reduced()
    jp = jblocks.block_init(jax.random.PRNGKey(12), cfg, kind)
    tp = _carry(jp)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)[None].repeat(2, 0)
    _close(tblocks.block_apply(tp, cfg, kind, torch.from_numpy(x),
                               torch.from_numpy(pos)),
           _j_block_apply(jp, cfg, kind, jnp.asarray(x), jnp.asarray(pos)))
    jc = jblocks.block_cache_init(cfg, kind, 2, 20, jnp.float32)
    tc = tblocks.block_cache_init(cfg, kind, 2, 20, torch.float32)
    assert tuple(tc.k.shape) == jc.k.shape
    for t in range(20):
        xt = x[:, t:t + 1]
        ya, jc = _j_block_decode(jp, cfg, kind, jnp.asarray(xt), jc)
        yb, tc = tblocks.block_decode(tp, cfg, kind, torch.from_numpy(xt),
                                      tc)
        _close(yb, ya)
    _close(tc.k, jc.k)


@pytest.mark.parametrize("arch", MOE)
def test_moe_model_apply_and_decode_match_jax(arch):
    cfg = jcfg.get_config(arch).reduced()
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(9))
    tp = _carry(jp)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    _close(tmodel.model_apply(tp, cfg, {"tokens": torch.from_numpy(toks)}),
           _j_apply(jp, cfg, {"tokens": jnp.asarray(toks)}))
    jc = jmodel.init_cache(cfg, 2, 24, dtype=jnp.float32)
    tc = tmodel.init_cache(cfg, 2, 24, torch.float32, device="cpu")
    for _ in range(24):
        x = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        ja, jc = _j_decode(jp, cfg, {"tokens": jnp.asarray(x)}, jc)
        tb, tc = tmodel.model_decode(tp, cfg, {"tokens": torch.from_numpy(x)},
                                     tc)
        _close(tb, ja)
