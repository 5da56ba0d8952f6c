"""Parity of the port's training half (`repro_torch.train`) with the JAX
package's, on reduced configs on the CPU.

The state is made by the reference (`init_train_state`) and carried
across with `params_from_jax`; batches are made with numpy from a
seed and handed to both packages. Tolerances: per leaf, relative L2 of
the gradients and of AdamW's first moment <= 1e-5 at f32 (the same function,
summed in other orders a few hundred f32 operations deep), <= 2^-6 at
bf16 compute (both round to bf16 at every product, at other places);
loss and grad norm within 1e-5 relative at f32. Also the JAX package's
tests/test_archs_smoke.py::test_train_step_reduces_and_stays_finite for
all ten registry archs, ported, and the compressed step at a one-pod mesh
against the reference's and at a two-pod CPU mesh against its formula."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch.mesh import make_debug_mesh as jax_mesh
from repro.optim.grad_compress import init_error_buffer as jax_err_buf
from repro.train import init_train_state as jax_init_state
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train import train_step as jtrain
from repro.train.compressed import \
    make_compressed_train_step as jax_compressed
from repro_torch import configs as tcfg
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.interop import params_from_jax
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.grad_compress import (decompress_int8,
                                             error_feedback_update,
                                             init_error_buffer)
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train import train_step as ttrain
from repro_torch.train.compressed import make_compressed_train_step
from repro_torch.train.train_step import split_microbatches

F32_TOL = 1e-5
BF16_TOL = 2 ** -6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_j_value_and_grad = jax.jit(jax.value_and_grad(jtrain.loss_fn),
                            static_argnums=1,
                            static_argnames=("compute_dtype",))


def _batch(cfg, seed, B=2, T=32):
    """The same batch with labels for both packages: (jax, torch)."""
    rng = np.random.default_rng(seed)
    arrs = {}
    t_out = T
    if cfg.input_mode == "embeds":
        arrs["embeds"] = rng.standard_normal((B, T, cfg.d_model)).astype(
            np.float32)
    elif cfg.input_mode == "patch_prefix":
        arrs["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix, cfg.d_model)).astype(np.float32)
        t_out = T - cfg.num_prefix
        arrs["tokens"] = rng.integers(0, cfg.vocab_size, (B, t_out)).astype(
            np.int32)
    else:
        arrs["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(
            np.int32)
    arrs["labels"] = rng.integers(0, cfg.vocab_size, (B, t_out)).astype(
        np.int32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _state(cfg, seed, moments_dtype=None):
    """(reference state tree, the port's copy of it)."""
    ts = jax_init_state(cfg, jax.random.PRNGKey(seed), jnp.float32,
                        moments_dtype)
    tree = ts.tree()
    return tree, params_from_jax(jax.tree.map(np.asarray, tree))


def _paths(tree, path=""):
    """{key path: leaf} of a nested-dict tree (either package's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_trees_close(got, want, tol, what):
    got, want = _paths(got), _paths(want)
    assert sorted(got) == sorted(want), what
    errs = {k: _rel_l2(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (what, worst, errs[worst])


@pytest.mark.parametrize("arch", tcfg.list_archs())
def test_train_step_reduces_and_stays_finite(arch):
    cfg = tcfg.get_config(arch).reduced()
    state = init_train_state(cfg, 1, device="cpu").tree()
    step = make_train_step(cfg, num_microbatches=2, peak_lr=1e-3,
                           compute_dtype=torch.float32)
    _, batch = _batch(cfg, 1)
    batch = split_microbatches(batch, 2)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    # Same batch twice: the second step should not be (much) worse.
    assert float(m2["loss"]) <= float(m1["loss"]) * 1.2
    assert int(state["opt"]["step"]) == 2


#: (arch, config changes, compute dtype): a dense arch with T = 32 above
#: attn_chunk = 16 (the chunked loop, two chunks), the MoE and both
#: recurrent families at f32; the dense arch again at bf16, and
#: stablelm-3b (MHA; its head size, 80, is reduced to 16) at bf16.
PARITY = [("qwen3-0.6b", dict(attn_chunk=16), "float32"),
          ("qwen2-moe-a2.7b", {}, "float32"),
          ("recurrentgemma-9b", {}, "float32"),
          ("xlstm-125m", {}, "float32"),
          ("qwen3-0.6b", dict(attn_chunk=16), "bfloat16"),
          ("stablelm-3b", dict(attn_chunk=16), "bfloat16")]


@pytest.mark.parametrize("arch,changes,dtype", PARITY)
def test_one_step_matches_the_reference(arch, changes, dtype):
    """The loss and every leaf's gradient (the reference's `loss_fn` under
    `jax.value_and_grad`), then one port `make_train_step` step against
    the rest of the reference's step on those gradients (its
    `cosine_schedule` and `adamw_update`, which is what its
    `make_train_step` does with one microbatch): loss, lr, grad_norm,
    AdamW's moments and step, from carried state."""
    jcfg_ = dataclasses.replace(jcfg.get_config(arch).reduced(), **changes)
    tcfg_ = dataclasses.replace(tcfg.get_config(arch).reduced(), **changes)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jstate, tstate = _state(jcfg_, 3)
    jb, tb = _batch(jcfg_, 4)

    jl, jg = _j_value_and_grad(jstate["params"], jcfg_, jb, compute_dtype=jdt)
    tl, tg = ttrain.value_and_grad(tstate["params"], tcfg_, tb, tdt)
    assert abs(float(tl) - float(jl)) <= tol * abs(float(jl))
    _assert_trees_close(tg, jg, tol, "gradients")

    jlr = jsched.cosine_schedule(jstate["opt"]["step"], peak_lr=1e-3,
                                 warmup_steps=100, total_steps=10_000)
    _, jopt, jm = jadamw.adamw_update(jstate["params"], jg, jstate["opt"],
                                      lr=jlr)
    tnew, tm = make_train_step(tcfg_, num_microbatches=1, peak_lr=1e-3,
                               compute_dtype=tdt)(tstate, tb)
    for key, want in (("loss", jl), ("lr", jlr),
                      ("grad_norm", jm["grad_norm"])):
        assert abs(float(tm[key]) - float(want)) <= tol * abs(float(want)), \
            key
    assert int(tnew["opt"]["step"]) == int(jopt["step"]) == 1
    # The moments are linear and quadratic in the clipped gradients. (The
    # new params are not compared leaf by leaf: a first AdamW step moves
    # each element by about lr * sign(g), and a zero-initialised bias whose
    # gradient is near 0 differs by its rounding's sign.)
    _assert_trees_close(tnew["opt"]["m"], jopt["m"], tol, "m")
    _assert_trees_close(tnew["opt"]["v"], jopt["v"], 2 * tol, "v")


def test_chunked_softmax_xent_at_a_ragged_token_count():
    """N = 3 x 7 = 21 tokens in chunks of 8 (three chunks, the last padded
    and masked): the loss and its gradients against the reference's."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)

    def jloss(table, x):
        return jtrain.chunked_softmax_xent({"embed": {"table": table}}, x,
                                           jnp.asarray(labels), chunk=8)
    jl, (jgt, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x))
    tt, tx = (torch.from_numpy(a).requires_grad_() for a in (table, x))
    tl = ttrain.chunked_softmax_xent({"embed": {"table": tt}}, tx,
                                     torch.from_numpy(labels), chunk=8)
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel_l2(tt.grad, jgt) <= F32_TOL and _rel_l2(tx.grad, jgx) \
        <= F32_TOL


def test_split_microbatches_matches_the_reference():
    arrs = {"tokens": np.arange(6 * 5, dtype=np.int32).reshape(6, 5),
            "labels": np.arange(6 * 5, dtype=np.int32).reshape(6, 5) + 1}
    for nm in (1, 2, 3):
        want = jtrain.split_microbatches(
            {k: jnp.asarray(v) for k, v in arrs.items()}, nm)
        got = split_microbatches({k: torch.from_numpy(v)
                                  for k, v in arrs.items()}, nm)
        for k in arrs:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_one_microbatch_and_two_agree():
    """The same batch as one microbatch and as two: the loss and the new
    params within the f32 tolerance (the mean of two means of equal
    halves is the mean)."""
    cfg = dataclasses.replace(tcfg.get_config("qwen3-0.6b").reduced(),
                              attn_chunk=16)
    _, batch = _batch(cfg, 6, B=4)
    outs = []
    for nm in (1, 2):
        state = init_train_state(cfg, 2, device="cpu").tree()
        step = make_train_step(cfg, num_microbatches=nm, peak_lr=1e-3,
                               compute_dtype=torch.float32)
        outs.append(step(state, split_microbatches(batch, nm)))
    (s1, m1), (s2, m2) = outs
    for key in ("loss", "grad_norm"):
        assert abs(float(m1[key]) - float(m2[key])) \
            <= F32_TOL * abs(float(m1[key])), key
    _assert_trees_close(s2["params"], s1["params"], F32_TOL, "params")


def test_compressed_step_at_one_pod_matches_the_reference():
    cfg = jcfg.get_config("qwen3-0.6b").reduced()
    jstate, tstate = _state(cfg, 0)
    jstate = dict(jstate, err=jax_err_buf(jstate["params"]))
    tstate = dict(tstate, err=init_error_buffer(tstate["params"]))
    jb, tb = _batch(cfg, 1, B=4, T=16)
    jstep = jax.jit(jax_compressed(cfg, jax_mesh(data=1, model=1, pod=1),
                                   peak_lr=1e-3, compute_dtype=jnp.float32))
    tstep = make_compressed_train_step(
        tcfg.get_config("qwen3-0.6b").reduced(),
        make_debug_mesh(data=1, model=1, pod=1, device="cpu"),
        peak_lr=1e-3, compute_dtype=torch.float32)
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for key in ("loss", "lr", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) \
                <= F32_TOL * abs(float(jm[key])), key
        _assert_trees_close(tstate["params"], jstate["params"], F32_TOL,
                            "params")
        # The residual is not smooth in g: where g / scale sits on a
        # rounding boundary the two packages may round to neighbouring
        # int8 values, and the residuals then differ by one step (scale,
        # >= 2 max |err|). Elsewhere they agree to the f32 tolerance of
        # the target g + err, whose largest element is 127 steps.
        for path, want in _paths(jstate["err"]).items():
            want = _np(want)
            d = np.abs(_np(_paths(tstate["err"])[path]) - want)
            step_ = 2 * np.abs(want).max() + 1e-12
            assert (d <= step_ * 1.001).all(), path
            assert (d > 127 * F32_TOL * step_).sum() <= max(
                1, 0.01 * d.size), path


def test_compressed_step_at_two_pods_follows_its_formula():
    """Two pods on a CPU mesh, each on its half of the batch: the int8
    payloads summed as int32, the scales averaged, AdamW on the
    dequantised mean; the error buffer kept is the first pod's."""
    cfg = tcfg.get_config("qwen3-0.6b").reduced()
    _, batch = _batch(cfg, 9, B=4, T=16)
    states = []
    for _ in range(2):
        st = init_train_state(cfg, 5, device="cpu").tree()
        st["err"] = init_error_buffer(st["params"])
        states.append(st)
    got, gm = make_compressed_train_step(
        cfg, make_debug_mesh(data=1, model=1, pod=2, device="cpu"),
        peak_lr=1e-3, compute_dtype=torch.float32)(states[0], batch)

    want = states[1]
    halves = [ttrain.value_and_grad(
        want["params"], cfg, {k: v[2 * i:2 * i + 2] for k, v in batch.items()},
        torch.float32) for i in range(2)]
    grads, errs = [], []
    for i, e in enumerate(tree_leaves(want["err"])):
        pay = [error_feedback_update(tree_leaves(g)[i], e) for _, g in halves]
        q_sum = pay[0][0].to(torch.int32) + pay[1][0].to(torch.int32)
        scale = (pay[0][1] + pay[1][1]) / 2
        grads.append(decompress_int8(q_sum, scale) / 2)
        errs.append(pay[0][2])
    it_g, it_e = iter(grads), iter(errs)
    lr = cosine_schedule(want["opt"]["step"], peak_lr=1e-3, warmup_steps=100,
                         total_steps=10_000)
    _, _, om = adamw_update(want["params"],
                            tree_map(lambda _: next(it_g), want["params"]),
                            want["opt"], lr=lr)
    assert abs(float(gm["loss"]) - float((halves[0][0] + halves[1][0]) / 2)) \
        <= 1e-6 * abs(float(gm["loss"]))
    assert float(gm["grad_norm"]) == pytest.approx(float(om["grad_norm"]),
                                                   rel=1e-6)
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(want["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(got["err"]), errs):
        assert torch.equal(a, b)
