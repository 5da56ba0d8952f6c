"""Parity of the port's recurrent mixers and recurrent architectures
(`repro_torch.models.{layers,rglru,xlstm}`, the `rglru` / `mlstm` /
`slstm` block kinds) with the JAX package's, on small shapes and reduced
configs of recurrentgemma-9b and xlstm-125m. Parameters are made by the
reference and carried across with `params_from_jax`; every other input is
made with numpy from a seed. On these CPU tensors the kernels' wrappers
run their plain versions; the kernels themselves are held against those
on the card by `chip_smoke.py`.

Tolerances: f32 values agree to 1e-4 (atol and rtol), `test_torch_lm.py`'s
TOL (the associative scan, the chunked mLSTM and the step loops sum in
other orders, a few dozen f32 operations deep); decode against prefill
(teacher forcing) to 2e-3, the reference's own bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro_torch import configs as tcfg
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as trglru
from repro_torch.models import xlstm as txlstm
from repro_torch.models.interop import params_from_jax

TOL = 1e-4
RECURRENT = ["recurrentgemma-9b", "xlstm-125m"]

_j_apply = jax.jit(jmodel.model_apply, static_argnums=1)
_j_decode = jax.jit(jmodel.model_decode, static_argnums=1)
_j_block_apply = jax.jit(jblocks.block_apply, static_argnums=(1, 2))
_j_block_decode = jax.jit(jblocks.block_decode, static_argnums=(1, 2))
_j_chunkwise = jax.jit(jxlstm.mlstm_chunkwise, static_argnums=(2, 3),
                       static_argnames=("chunk",))
_j_mrec = jax.jit(jxlstm.mlstm_recurrent, static_argnums=(2, 3))
_j_slstm = jax.jit(jxlstm.slstm_apply, static_argnums=2)
_j_rglru = jax.jit(jrglru.rglru_apply)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _close_tree(got, want, tol=TOL):
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], tol)


def _carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# conv1d
# ---------------------------------------------------------------------------

def test_conv1d_full_and_streaming():
    """Full mode, and streaming mode fed in pieces of 1, 3 and 6 steps
    from an empty context, equal the reference; the pieces rebuild the
    full output and its trailing context."""
    p = jlayers.conv1d_init(jax.random.PRNGKey(0), 24, 4)
    p = dict(p, b=jnp.asarray(_rand(1, 24)))
    tp = _carry(p)
    x = _rand(2, 2, 10, 24)
    ya, sa = jlayers.conv1d_apply(p, jnp.asarray(x))
    yb, sb = tlayers.conv1d_apply(tp, torch.from_numpy(x))
    _close(yb, ya)
    _close(sb, sa)
    state_j = jnp.zeros((2, 3, 24))
    state_t = torch.zeros((2, 3, 24))
    outs = []
    for lo, hi in ((0, 1), (1, 4), (4, 10)):
        ya, state_j = jlayers.conv1d_apply(p, jnp.asarray(x[:, lo:hi]),
                                           state=state_j)
        yb, state_t = tlayers.conv1d_apply(tp, torch.from_numpy(x[:, lo:hi]),
                                           state=state_t)
        _close(yb, ya)
        _close(state_t, state_j)
        outs.append(yb)
    _close(torch.cat(outs, dim=1), tlayers.conv1d_apply(
        tp, torch.from_numpy(x))[0])
    _close(state_t, sb)


def test_conv1d_init_shapes():
    gen = torch.Generator().manual_seed(0)
    p = tlayers.conv1d_init(gen, 24, 4, lead=(3,))
    assert p["w"].shape == (3, 4, 24) and p["b"].shape == (3, 24)
    assert float(p["b"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# RG-LRU (B6's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_apply_matches_jax(with_h0):
    p = jrglru.rglru_init(jax.random.PRNGKey(3), 32)
    tp = _carry(p)
    x = _rand(4, 2, 70, 32)
    h0 = _rand(5, 2, 32) if with_h0 else None
    ya, ha = _j_rglru(p, jnp.asarray(x),
                      None if h0 is None else jnp.asarray(h0))
    before = trglru.rglru_scan_plain.calls
    yb, hb = trglru.rglru_apply(tp, torch.from_numpy(x),
                                None if h0 is None else torch.from_numpy(h0))
    assert trglru.rglru_scan_plain.calls == before + 1
    assert yb.dtype == torch.float32 and hb.dtype == torch.float32
    _close(yb, ya)
    _close(hb, ha)
    assert torch.equal(hb, yb[:, -1])


def test_rglru_step_matches_jax_and_continues_the_scan():
    p = jrglru.rglru_init(jax.random.PRNGKey(6), 32)
    tp = _carry(p)
    x = _rand(7, 2, 24, 32)
    y_full, _ = trglru.rglru_apply(tp, torch.from_numpy(x))
    _, h = trglru.rglru_apply(tp, torch.from_numpy(x[:, :16]))
    hj = jnp.asarray(h.numpy())
    for t in range(16, 24):
        ya, hj = jrglru.rglru_step(p, jnp.asarray(x[:, t:t + 1]), hj)
        yb, h = trglru.rglru_step(tp, torch.from_numpy(x[:, t:t + 1]), h)
        _close(yb, ya)
        _close(yb[:, 0], y_full[:, t], 1e-5)
    _close(h, hj)


def test_rglru_bf16_output_and_gates():
    """bf16 activations: y in bf16, h_last f32, the gates in f32 from the
    bf16 dense outputs (the reference's casts)."""
    p = jrglru.rglru_init(jax.random.PRNGKey(8), 32)
    tp = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)).astype(np.float32), p))
    tp = tmodel.tree_map(lambda t: t.bfloat16(), tp)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    x = _rand(9, 1, 40, 32)
    ya, ha = _j_rglru(jp, jnp.asarray(x, jnp.bfloat16))
    yb, hb = trglru.rglru_apply(tp, torch.from_numpy(x).bfloat16())
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
    # The dense outputs round to bf16 in both; the scans then agree to
    # f32 precision, and y to one bf16 rounding.
    _close(hb, ha, 2e-2)
    np.testing.assert_allclose(_np(yb), _np(ya), atol=2e-2, rtol=2 ** -7)


def test_rglru_cuda_wrapper_takes_no_cpu_tensor():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trglru.rglru_scan_cuda(x, x, x, torch.zeros(8))


# ---------------------------------------------------------------------------
# mLSTM (B7's plain version)
# ---------------------------------------------------------------------------

def _mlstm(seed, d=64, H=4, D=16):
    p = jxlstm.mlstm_init(jax.random.PRNGKey(seed), d, H, D)
    return p, _carry(p)


def test_mlstm_recurrent_matches_jax():
    p, tp = _mlstm(10)
    x = _rand(11, 2, 20, 64)
    ya, sa = _j_mrec(p, jnp.asarray(x), 4, 16)
    yb, sb = txlstm.mlstm_recurrent(tp, torch.from_numpy(x), 4, 16)
    _close(yb, ya)
    _close_tree(sb, sa)


@pytest.mark.parametrize("chunk", [16, 32, 64, 40])
def test_mlstm_chunkwise_matches_jax_and_the_recurrence(chunk):
    """Chunk 40 does not divide the kernel's 64-row tile: a ragged chunk."""
    p, tp = _mlstm(12)
    T = 320 if chunk == 40 else 128
    x = _rand(13, 2, T, 64)
    ya, sa = _j_chunkwise(p, jnp.asarray(x), 4, 16, chunk=chunk)
    before = txlstm.mlstm_chunk_scan_plain.calls
    yb, sb = txlstm.mlstm_chunkwise(tp, torch.from_numpy(x), 4, 16,
                                    chunk=chunk)
    assert txlstm.mlstm_chunk_scan_plain.calls == before + 1
    _close(yb, ya)
    _close_tree(sb, sa)
    yr, sr = txlstm.mlstm_recurrent(tp, torch.from_numpy(x), 4, 16)
    _close(yb, yr)
    _close(sb["C"], sr["C"])


def test_mlstm_state_resume():
    """As the reference's test: two halves with the state carried equal
    one pass; and the second half from the reference's state equals the
    reference's second half."""
    p, tp = _mlstm(14, d=32, H=2)
    x = _rand(15, 1, 96, 32)
    tx = torch.from_numpy(x)
    y_full, _ = txlstm.mlstm_chunkwise(tp, tx, 2, 16, chunk=16)
    y1, st = txlstm.mlstm_chunkwise(tp, tx[:, :48], 2, 16, chunk=16)
    y2, _ = txlstm.mlstm_chunkwise(tp, tx[:, 48:], 2, 16, state=st, chunk=16)
    _close(torch.cat([y1, y2], dim=1), y_full)
    _, sj = _j_chunkwise(p, jnp.asarray(x[:, :48]), 2, 16, chunk=16)
    ya, _ = _j_chunkwise(p, jnp.asarray(x[:, 48:]), 2, 16, state=sj,
                         chunk=16)
    yb, _ = txlstm.mlstm_chunkwise(tp, tx[:, 48:], 2, 16,
                                   state=_carry(sj), chunk=16)
    _close(yb, ya)


def test_mlstm_chunk_must_divide_t():
    _, tp = _mlstm(16)
    with pytest.raises(ValueError, match="divisible by chunk"):
        txlstm.mlstm_chunkwise(tp, torch.zeros(1, 40, 64), 4, 16, chunk=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        q = torch.zeros(1, 4, 16, 16)
        txlstm.mlstm_chunk_scan_cuda(
            q, q, q, torch.zeros(1, 4, 16), torch.zeros(1, 4, 16),
            txlstm.mlstm_state_init(1, 4, 16), 16)


# ---------------------------------------------------------------------------
# sLSTM (B8's plain version)
# ---------------------------------------------------------------------------

def test_slstm_apply_matches_jax_with_and_without_state():
    p = jxlstm.slstm_init(jax.random.PRNGKey(17), 32, 4)
    tp = _carry(p)
    x = _rand(18, 2, 30, 32)
    ya, sa = _j_slstm(p, jnp.asarray(x), 4)
    before = txlstm.slstm_scan_plain.calls
    yb, sb = txlstm.slstm_apply(tp, torch.from_numpy(x), 4)
    assert txlstm.slstm_scan_plain.calls == before + 1
    _close(yb, ya)
    _close_tree(sb, sa)
    assert float(sb["n"].min()) > 0.0
    ya, sa2 = _j_slstm(p, jnp.asarray(x[:, :7]), 4, state=sa)
    yb, sb2 = txlstm.slstm_apply(tp, torch.from_numpy(x[:, :7]), 4,
                                 state=sb)
    _close(yb, ya)
    _close_tree(sb2, sa2)


def test_slstm_state_init_and_tree():
    st = txlstm.slstm_state_init(2, 4, 8, lead=(3,))
    want = jxlstm.slstm_state_init(2, 4, 8)
    for key in ("h", "c", "n", "m"):
        assert st[key].shape == (3, *want[key].shape)
        assert float(st[key][0].sum()) == float(want[key].sum())
    assert float(st["n"].min()) == 1.0   # n starts at ones
    gen = torch.Generator().manual_seed(0)
    tshapes = tmodel.tree_map(lambda a: tuple(a.shape),
                              txlstm.slstm_init(gen, 32, 4))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jxlstm.slstm_init(jax.random.PRNGKey(0), 32, 4)))
    assert tshapes == jshapes
    with pytest.raises(ValueError, match="CUDA tensors"):
        w = torch.zeros(1, 2, 32)
        r = torch.zeros(4, 8, 8)
        txlstm.slstm_scan_cuda({g: w for g in "zifo"}, {g: r for g in "zifo"},
                               txlstm.slstm_state_init(1, 4, 8))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block_case(kind):
    arch = "recurrentgemma-9b" if kind == "rglru" else "xlstm-125m"
    return jcfg.get_config(arch).reduced()


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_block_apply_decode_and_cache_match_jax(kind):
    """Prefill of 32 steps, then 12 decode steps from a fresh cache, each
    against the reference; the cache's tensors are updated in place and
    equal the reference's, and decode reproduces the prefill."""
    cfg = _block_case(kind)
    jp = jblocks.block_init(jax.random.PRNGKey(19), cfg, kind)
    tp = _carry(jp)
    x = _rand(20, 2, 32, cfg.d_model)
    pos = np.arange(32, dtype=np.int32)[None].repeat(2, 0)
    y_pre = tblocks.block_apply(tp, cfg, kind, torch.from_numpy(x),
                                torch.from_numpy(pos))
    _close(y_pre, _j_block_apply(jp, cfg, kind, jnp.asarray(x),
                                 jnp.asarray(pos)))
    jc = jblocks.block_cache_init(cfg, kind, 2, 12, jnp.float32)
    tc = tblocks.block_cache_init(cfg, kind, 2, 12, torch.float32)
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype), key
    held = {key: tc[key] for key in tc}
    for t in range(12):
        xt = x[:, t:t + 1]
        ya, jc = _j_block_decode(jp, cfg, kind, jnp.asarray(xt), jc)
        yb, tc2 = tblocks.block_decode(tp, cfg, kind, torch.from_numpy(xt),
                                       tc)
        assert tc2 is tc and all(tc[k] is held[k] for k in tc)
        _close(yb, ya)
        _close(yb[:, 0], y_pre[:, t], 2e-3)
    _close_tree(tc, jc)


def test_block_cache_dtypes():
    cfg = tcfg.get_config("recurrentgemma-9b").reduced()
    c = tblocks.block_cache_init(cfg, "rglru", 2, 8, torch.bfloat16)
    assert c["h"].dtype == torch.float32 and c["conv"].dtype == torch.bfloat16
    cfg = tcfg.get_config("xlstm-125m").reduced()
    c = tblocks.block_cache_init(cfg, "mlstm", 2, 8, torch.bfloat16)
    assert {k: v.dtype for k, v in c.items()} == {
        "C": torch.float32, "n": torch.float32, "m": torch.float32,
        "conv": torch.bfloat16}
    c = tblocks.block_cache_init(cfg, "slstm", 2, 8, torch.bfloat16)
    assert all(v.dtype == torch.float32 for v in c.values())
    with pytest.raises(ValueError, match="unknown block kind"):
        tblocks.block_cache_init(cfg, "conv", 1, 8)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_model_apply_and_decode_match_jax(arch):
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


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_matches_forward_teacher_forcing(arch):
    """The reference's own check (tests/test_archs_smoke.py): per-token
    decode reproduces the prefill logits; T = 64 > window 16, so the
    local layers' rings wrap, and 64 steps are 4 mLSTM chunks of 16."""
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
    _close(torch.cat(outs, dim=1), ref, 2e-3)
