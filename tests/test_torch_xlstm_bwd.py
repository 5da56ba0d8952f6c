"""The backwards of the xLSTM mixers on the CPU: B7-bwd's and B8-bwd's
plain versions and the autograd Functions around them
(`repro_torch.models.xlstm`).

The plain backwards hold every stabiliser (a max) constant and add back
the gauge part of a final-state gradient (xlstm.py's notes on B7-bwd and
B8-bwd). They are held against:
  * `torch.autograd` through the plain forwards (`mlstm_chunk_scan_plain`,
    `slstm_scan_plain`) in f64, with no detach anywhere, to 1e-10 of the
    largest |autograd| value of each gradient (the same function, a few
    hundred f64 operations apart), whole and — for B7-bwd — pass by pass:
    pass 1 against the gradient of each chunk's incoming state through
    that chunk's outputs alone, pass 2 against the gradient at each chunk
    boundary of the whole loss;
  * `jax.grad` of the JAX package's `mlstm_chunkwise` / `slstm_apply`
    with respect to the parameters, the input and the carried state, the
    port's side going through `MLSTMChunkScan` / `SLSTMScan` on the CPU,
    in f32: each gradient within 1e-5 x max |reference| of it (the
    tolerance of tests/test_torch_flash_bwd.py; f32 sums in other orders);
  * `torch.autograd.gradcheck` of both Functions in f64.
The cases span chunks 16 / 40 / 64, D 16 and 192, a carried state that
requires grad, random final-state gradients (the gauge term), the extreme
gates of tests/test_torch_xlstm_passes.py, rows of both denominator
branches (asserted to occur), sLSTM head sizes 5 / 20 / 33 and bf16 wx
and R."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxlstm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.interop import params_from_jax

F64_TOL = 1e-10
F32_TOL = 1e-5
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def _mlstm_raw(seed, B, H, T, D, chunk, extreme=False, spike=6.0):
    """q, k, v (B, H, T, D) as views of (B, T, H, D), gates (B, H, T),
    a carried state and the final state's gradients, f64, from numpy.
    `extreme`: the gate recipe of test_torch_xlstm_passes.py by chunk
    (an input spike, the input gate shut, a forget gate near -8) and a
    direction shared by q and k."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape))
    q, k, v = (t(B, T, H, D).transpose(1, 2) for _ in range(3))
    k = k / D ** 0.5
    it, fpre = t(B, T, H), t(B, T, H) + 1.0
    if extreme:
        s = torch.arange(T)[None, :, None]
        c, mid = s // chunk, s % chunk == chunk // 2
        it = torch.where(mid & (c % 3 == 0), it + spike, it)
        it = torch.where(c % 3 == 1, it - 40.0, it)
        fpre = torch.where(mid & (c % 3 == 2), fpre - 8.0, fpre)
        q, k = q + 2.0, k + 2.0 / D ** 0.5
    ft = torch.nn.functional.logsigmoid(fpre).transpose(1, 2)
    state = {"C": t(B, H, D, D), "n": t(B, H, D), "m": t(B, H)}
    fin = {"C": t(B, H, D, D), "n": t(B, H, D), "m": t(B, H)}
    return q, k, v, it.transpose(1, 2), ft, state, fin, t(B, T, H * D)


def _mlstm_autograd(q, k, v, it, ft, state, fin, dh, chunk):
    """Gradients of <dh, h> + <fin, final state> by autograd through
    `mlstm_chunk_scan_plain`, w.r.t. q, k, v, it, ft and the state."""
    leaves = [x.detach().clone().requires_grad_()
              for x in (q, k, v, it, ft, state["C"], state["n"],
                        state["m"])]
    h, s1 = txlstm.mlstm_chunk_scan_plain(
        *leaves[:5], dict(zip("Cnm", leaves[5:])), chunk)
    loss = (h * dh).sum() + sum((s1[key] * fin[key]).sum() for key in "Cnm")
    return torch.autograd.grad(loss, leaves), s1


def _mlstm_forward(q, k, v, it, ft, state, chunk):
    """The Function's plain forward: (h, dot, work, scal, final state)."""
    work, scal = txlstm.mlstm_chunk_states_plain(k, v, it, ft, chunk)
    s1 = txlstm.mlstm_state_scan_plain(work, scal, state)
    h, dot = txlstm.mlstm_chunk_outputs_plain(q, k, v, it, ft, work, scal,
                                              chunk, with_dot=True)
    return h, dot, work, scal, s1


MLSTM_CASES = [  # (chunk, D, T, extreme)
    (16, 16, 96, False), (40, 16, 200, False), (64, 16, 192, False),
    (64, 192, 128, False), (16, 16, 96, True), (40, 16, 240, True),
    (64, 24, 192, True)]


@pytest.mark.parametrize("chunk,D,T,extreme", MLSTM_CASES)
def test_mlstm_plain_backward_is_f64_autograd(chunk, D, T, extreme):
    B, H = 2, 2 if D < 192 else 1
    q, k, v, it, ft, st, fin, dh = _mlstm_raw(chunk + D + T, B, H, T, D,
                                              chunk, extreme)
    want, s_ref = _mlstm_autograd(q, k, v, it, ft, st, fin, dh, chunk)
    h, dot, work, scal, s1 = _mlstm_forward(q, k, v, it, ft, st, chunk)
    got = txlstm.mlstm_chunk_scan_bwd_plain(
        q, k, v, it, ft, h, dot, work, scal, s1["C"], s1["n"], dh, fin["C"],
        fin["n"], fin["m"], chunk)
    for name, a, b in zip(("dq", "dk", "dv", "di", "df", "dC0", "dn0",
                           "dm0"), got, want):
        _close(a, b, F64_TOL, name)
    # Both branches of the denominator max(|dot_r|, exp(-(b_r + M_r))).
    *_, on_dot = txlstm._bwd_rows(dot, it, ft, scal, chunk)
    assert bool(on_dot.any()) and bool((~on_dot).any())


@pytest.mark.parametrize("final", ["none", "state_gradients"])
def test_mlstm_plain_backward_without_a_final_gradient(final):
    """The training case (the final state's gradient None: no gauge term)
    and the gauge term alone (dh = 0)."""
    B, H, T, D, chunk = 2, 2, 96, 8, 16
    q, k, v, it, ft, st, fin, dh = _mlstm_raw(5, B, H, T, D, chunk)
    if final == "none":
        fin = {key: torch.zeros_like(val) for key, val in fin.items()}
        given = (None, None, None)
    else:
        dh = torch.zeros_like(dh)
        given = (fin["C"], fin["n"], fin["m"])
    want, _ = _mlstm_autograd(q, k, v, it, ft, st, fin, dh, chunk)
    h, dot, work, scal, s1 = _mlstm_forward(q, k, v, it, ft, st, chunk)
    got = txlstm.mlstm_chunk_scan_bwd_plain(
        q, k, v, it, ft, h, dot, work, scal, s1["C"], s1["n"], dh, *given,
        chunk)
    for name, a, b in zip(("dq", "dk", "dv", "di", "df", "dC0", "dn0",
                           "dm0"), got, want):
        _close(a, b, F64_TOL, name)


@pytest.mark.parametrize("chunk,extreme", [(16, False), (40, True)])
def test_mlstm_backward_passes_one_by_one(chunk, extreme):
    """Pass 1: each chunk's (dC_own, dn_own, dm_own) is the gradient of
    <dh_c, h_c> w.r.t. the chunk's incoming state, through that chunk
    alone. Pass 2: each chunk's dC_out, dn_out is the whole loss's
    gradient at the chunk's end state; X_c and the gauge g_c follow from
    it. Pass 3 gives the whole's input gradients (above)."""
    B, H, T, D = 2, 2, 5 * chunk, 8
    q, k, v, it, ft, st, fin, dh = _mlstm_raw(30 + chunk, B, H, T, D, chunk,
                                              extreme)
    h, dot, work, scal, s1 = _mlstm_forward(q, k, v, it, ft, st, chunk)
    dwork, dscal = txlstm.mlstm_bwd_outputs_plain(q, dh, h, dot, it, ft,
                                                  work, scal, chunk)
    assert float(dscal[..., 1:].abs().max()) == 0.0
    assert float(dwork[..., D:].abs().max()) == 0.0
    nc = T // chunk
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        inc = [work[:, :, c, :D, :D], work[:, :, c, D, :D], scal[:, :, c, 2]]
        leaves = [x.clone().requires_grad_() for x in inc]
        hc, _ = txlstm.mlstm_chunk_scan_plain(
            q[:, :, sl], k[:, :, sl], v[:, :, sl], it[:, :, sl],
            ft[:, :, sl], dict(zip("Cnm", leaves)), chunk)
        dhc = dh.reshape(B, T, H, D)[:, sl].reshape(B, chunk, H * D)
        want = torch.autograd.grad((hc * dhc).sum(), leaves)
        _close(dwork[:, :, c, :D, :D], want[0], F64_TOL, f"dC_own {c}")
        _close(dwork[:, :, c, D, :D], want[1], F64_TOL, f"dn_own {c}")
        _close(dscal[:, :, c, 0], want[2], F64_TOL, f"dm_own {c}")
    gauge = txlstm.mlstm_gauge(fin["C"], fin["n"], fin["m"], s1["C"],
                               s1["n"])
    txlstm.mlstm_bwd_scan_plain(dwork, dscal, work, scal, fin["C"], fin["n"],
                                gauge)
    for c in range(nc):
        # The whole loss split at the end of chunk c.
        sl = slice(0, (c + 1) * chunk)
        _, sc = txlstm.mlstm_chunk_scan_plain(
            q[:, :, sl], k[:, :, sl], v[:, :, sl], it[:, :, sl],
            ft[:, :, sl], st, chunk)
        leaves = [sc[key].clone().requires_grad_() for key in "Cnm"]
        rest = slice((c + 1) * chunk, T)
        sr, loss = dict(zip("Cnm", leaves)), 0.0
        if c < nc - 1:
            hr, sr = txlstm.mlstm_chunk_scan_plain(
                q[:, :, rest], k[:, :, rest], v[:, :, rest], it[:, :, rest],
                ft[:, :, rest], sr, chunk)
            loss = (hr * dh.reshape(B, T, H, D)[:, rest].reshape(
                B, -1, H * D)).sum()
        loss = loss + sum((sr[key] * fin[key]).sum() for key in "Cnm")
        dC, dn, dm = torch.autograd.grad(loss, leaves)
        _close(dwork[:, :, c, :D, :D], dC, F64_TOL, f"dC_out {c}")
        _close(dwork[:, :, c, D, :D], dn, F64_TOL, f"dn_out {c}")
        X = (dC * work[:, :, c, :D, :D]).sum((-2, -1)) \
            + (dn * work[:, :, c, D, :D]).sum(-1)
        _close(dscal[:, :, c, 1], X, F64_TOL, f"X {c}")
        # The gauge cancels terms: held to the scale of those.
        g = dm - (dC * sc["C"]).sum((-2, -1)) - (dn * sc["n"]).sum(-1)
        terms = dm.abs() + (dC * sc["C"]).abs().sum((-2, -1)) \
            + (dn * sc["n"]).abs().sum(-1)
        assert float((dscal[:, :, c, 2] - g).abs().max()) \
            <= F64_TOL * float(terms.max()), f"gauge {c}"


def _slstm_raw(seed, B, T, H, Dh):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape))
    d = H * Dh
    wx = {g: t(B, T, d) for g in "zifo"}
    r = {g: t(H, Dh, Dh) * Dh ** -0.5 for g in "zifo"}
    st = {"h": torch.tanh(t(B, H, Dh)), "c": t(B, H, Dh),
          "n": 1.0 + torch.from_numpy(rng.random((B, H, Dh))),
          "m": t(B, H, Dh)}
    fin = {key: t(B, H, Dh) for key in "hcnm"}
    return wx, r, st, fin, t(B, T, d)


@pytest.mark.parametrize("B,T,H,Dh", [(2, 9, 2, 5), (2, 37, 1, 20),
                                      (1, 16, 2, 33)])
@pytest.mark.parametrize("final", [True, False])
def test_slstm_plain_backward_is_f64_autograd(B, T, H, Dh, final):
    wx, r, st, fin, dh = _slstm_raw(B * T + Dh, B, T, H, Dh)
    if not final:
        fin = {key: torch.zeros_like(val) for key, val in fin.items()}
    leaves = [x.clone().requires_grad_() for x in
              (*wx.values(), *r.values(), *st.values())]
    h, s1 = txlstm.slstm_scan_plain(dict(zip("zifo", leaves[:4])),
                                    dict(zip("zifo", leaves[4:8])),
                                    dict(zip("hcnm", leaves[8:])))
    loss = (h * dh).sum() + sum((s1[key] * fin[key]).sum() for key in "hcnm")
    want = torch.autograd.grad(loss, leaves)
    h, _, saved = txlstm.slstm_scan_plain(wx, r, st, with_saved=True)
    given = [fin[key] if final else None for key in "hcnm"]
    delta, dR, *dstate = txlstm.slstm_scan_bwd_plain(
        [r[g] for g in "zifo"], *st.values(), h, saved, dh, *given)
    got = [delta[:, :, g] for g in range(4)] + dR + dstate
    for name, a, b in zip([f"dwx_{g}" for g in "zifo"]
                          + [f"dr_{g}" for g in "zifo"]
                          + ["dh0", "dc0", "dn0", "dm0"], got, want):
        _close(a, b, F64_TOL, name)


def test_slstm_record_is_the_steps_pre_activations_and_states():
    wx, r, st, _, _ = _slstm_raw(3, 2, 6, 2, 4)
    h, s1, saved = txlstm.slstm_scan_plain(wx, r, st, with_saved=True)
    assert saved.shape == (2, 6, txlstm.SLSTM_SAVED, 8)
    p = {f"r{g}": r[g] for g in "zifo"}
    state = st
    for t in range(6):
        pre = txlstm._slstm_pre(p, state["h"], {g: wx[g][:, t] for g in
                                                "zifo"}, 2, 4)
        state = txlstm.slstm_step(p, state, {g: wx[g][:, t] for g in "zifo"},
                                  2, 4)
        got = saved[:, t].reshape(2, 7, 2, 4)
        for j, want in enumerate([*pre, state["c"], state["n"],
                                  state["m"]]):
            torch.testing.assert_close(got[:, j], want, rtol=0, atol=0)


# ---- the Functions against jax.grad of the reference ----------------------

_j_mlstm = jax.jit(jxlstm.mlstm_chunkwise, static_argnums=(2, 3),
                   static_argnames=("chunk",))
_j_slstm = jax.jit(jxlstm.slstm_apply, static_argnums=(2,))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, f"{path}/{key}")
    else:
        yield path, tree


def _grad_close(tree_t, tree_j, what):
    got = dict(_leaves(tree_t))
    for path, want in _leaves(tree_j):
        _close(got[path], torch.from_numpy(np.asarray(want)), F32_TOL,
               f"{what}{path}")


def _jax_grads(fn, p, x, state, dy, dstate):
    def loss(p, x, state):
        y, s1 = fn(p, x, state)
        out = jnp.sum(y * dy)
        for key in dstate:
            out = out + jnp.sum(s1[key] * dstate[key])
        return out
    return jax.grad(loss, argnums=(0, 1, 2))(p, x, state)


def _torch_grads(fn, p, x, state, dy, dstate, dtype=None):
    if dtype is not None:
        p, x, state, dy, dstate = jax.tree.map(
            lambda a: np.asarray(a, dtype), (p, x, state, dy, dstate))
    tp = params_from_jax(p)
    for _, leaf in _leaves(tp):
        leaf.requires_grad_()
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    ts = {key: torch.from_numpy(np.array(val)).requires_grad_()
          for key, val in state.items()}
    y, s1 = fn(tp, tx, ts)
    loss = (y * torch.from_numpy(dy)).sum() + sum(
        (s1[key] * torch.from_numpy(val)).sum() for key, val in dstate.items())
    loss.backward()
    return (jax.tree.map(lambda t: t.grad, tp), tx.grad,
            {key: val.grad for key, val in ts.items()})


def _witness_close(got, ref, want, what):
    """The extreme gates' rule: both f32 sides may stray from the f64
    result by ~1e-5 of its largest value (gradients of a few hundred
    summed over exponentially weighted terms); the port's distance from
    the f64 result must stay within the reference's distance plus
    F32_TOL x max |f64|."""
    want = want.detach().double()
    d_got = float((got.detach().double() - want).abs().max())
    d_ref = float((torch.from_numpy(np.asarray(ref, np.float64))
                   - want).abs().max())
    assert d_got <= d_ref + F32_TOL * float(want.abs().max()), \
        (what, d_got, d_ref)


@pytest.mark.parametrize("chunk,D,T,extreme", [(16, 16, 96, False),
                                               (40, 24, 240, True),
                                               (64, 32, 192, False)])
def test_mlstm_function_matches_jax_grad(chunk, D, T, extreme):
    """jax.grad of the reference against the Function, both f32. At the
    extreme gates each side is held against the Function's f64 gradients
    (the plain backward, f64 autograd's equal above) by `_witness_close`."""
    B, H, d = 2, 3, 48
    rng = np.random.default_rng(90 + chunk)
    p = jax.tree.map(np.array, jxlstm.mlstm_init(jax.random.PRNGKey(chunk),
                                                 d, H, D))
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    if extreme:
        p["wi"]["w"][0, :] = 1.0
        p["wf"]["w"][1, :] = 1.0
        s = np.arange(T)
        c, mid = s // chunk, s % chunk == chunk // 2
        x[:, :, :2] = 0.0
        x[:, mid & (c % 3 == 0), 0] = 6.0
        x[:, c % 3 == 1, 0] = -40.0
        x[:, mid & (c % 3 == 2), 1] = -8.0
    state = {"C": rng.standard_normal((B, H, D, D)).astype(np.float32),
             "n": rng.standard_normal((B, H, D)).astype(np.float32),
             "m": rng.standard_normal((B, H)).astype(np.float32)}
    dy = rng.standard_normal((B, T, d)).astype(np.float32)
    dstate = {key: rng.standard_normal(val.shape).astype(np.float32)
              for key, val in state.items()}
    jp, jx, js = _jax_grads(
        lambda p_, x_, s_: _j_mlstm(p_, x_, H, D, state=s_, chunk=chunk),
        p, x, state, dy, dstate)
    def port(dtype=None):
        return _torch_grads(
            lambda p_, x_, s_: txlstm.mlstm_chunkwise(p_, x_, H, D,
                                                      state=s_, chunk=chunk),
            p, x, state, dy, dstate, dtype)
    tp, tx, ts = port()
    if not extreme:
        _grad_close(tp, jp, "params")
        _close(tx, torch.from_numpy(np.asarray(jx)), F32_TOL, "x")
        _grad_close(ts, js, "state")
        return
    fp, fx, fs = port(np.float64)
    ref, want = (dict(_leaves({"p": g, "s": s_})) for g, s_ in
                 ((jp, js), (fp, fs)))
    for path, got in _leaves({"p": tp, "s": ts}):
        _witness_close(got, ref[path], want[path], path)
    _witness_close(tx, jx, fx, "x")


@pytest.mark.parametrize("T,H,d", [(37, 4, 32), (16, 2, 40)])
def test_slstm_function_matches_jax_grad(T, H, d):
    B = 2
    rng = np.random.default_rng(T + d)
    p = jax.tree.map(np.array, jxlstm.slstm_init(jax.random.PRNGKey(T), d,
                                                 H))
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    Dh = d // H
    state = {"h": np.tanh(rng.standard_normal((B, H, Dh))).astype(np.float32),
             "c": rng.standard_normal((B, H, Dh)).astype(np.float32),
             "n": (1 + rng.random((B, H, Dh))).astype(np.float32),
             "m": rng.standard_normal((B, H, Dh)).astype(np.float32)}
    dy = rng.standard_normal((B, T, d)).astype(np.float32)
    dstate = {key: rng.standard_normal(val.shape).astype(np.float32)
              for key, val in state.items()}
    jp, jx, js = _jax_grads(lambda p_, x_, s_: _j_slstm(p_, x_, H, s_),
                            p, x, state, dy, dstate)
    tp, tx, ts = _torch_grads(
        lambda p_, x_, s_: txlstm.slstm_apply(p_, x_, H, state=s_),
        p, x, state, dy, dstate)
    _grad_close(tp, jp, "params")
    _close(tx, torch.from_numpy(np.asarray(jx)), F32_TOL, "x")
    _grad_close(ts, js, "state")


def test_slstm_function_takes_bf16_wx_and_r():
    """bf16 wx and R (the training path's types): dwx and dR come back in
    bf16, each element within one bf16 ulp (plus the f32 tolerance) of f64
    autograd through the plain forward on the same bf16 values upcast.
    (Autograd through the plain forward on the bf16 leaves themselves is
    no oracle for dR: it adds each step's bf16-cast gradient into the bf16
    leaf, where the Function sums over the steps in f32.)"""
    wx, r, st, _, dh = _slstm_raw(11, 2, 20, 2, 16)
    wx = {g: val.to(torch.bfloat16) for g, val in wx.items()}
    r = {g: val.to(torch.bfloat16) for g, val in r.items()}

    def grads(fn, dtype):
        leaves = [x.to(dtype).requires_grad_() for x in
                  (*wx.values(), *r.values())]
        h, _ = fn(dict(zip("zifo", leaves[:4])),
                  dict(zip("zifo", leaves[4:])),
                  {key: val.to(dtype if dtype == F64 else torch.float32)
                   for key, val in st.items()})
        return torch.autograd.grad((h * dh.to(h.dtype)).sum(), leaves)
    got = grads(txlstm.slstm_scan, torch.bfloat16)
    want = grads(txlstm.slstm_scan_plain, F64)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        ulp = torch.exp2(torch.floor(torch.log2(
            b.float().abs().clamp_min(1e-30))) - 7)
        err = (a.float() - b.float()).abs()
        assert bool((err <= ulp + F32_TOL * b.float().abs().max()).all())


def test_functions_pass_gradcheck():
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    B, H, T, D, chunk = 1, 2, 8, 3, 4
    q, k, v = (t(B, H, T, D) for _ in range(3))
    it = t(B, H, T)
    ft = torch.nn.functional.logsigmoid(
        torch.from_numpy(rng.standard_normal((B, H, T))) + 1.0) \
        .requires_grad_()
    C0, n0, m0 = t(B, H, D, D), t(B, H, D), t(B, H)
    assert torch.autograd.gradcheck(
        lambda *a: txlstm.MLSTMChunkScan.apply(*a, chunk),
        (q, k, v, it, ft, C0, n0, m0))
    Bs, Ts, Hs, Dh = 1, 4, 2, 3
    wx = [t(Bs, Ts, Hs * Dh) for _ in range(4)]
    r = [t(Hs, Dh, Dh) for _ in range(4)]
    h0, c0, m0s = t(Bs, Hs, Dh), t(Bs, Hs, Dh), t(Bs, Hs, Dh)
    n0s = (1.0 + torch.from_numpy(rng.random((Bs, Hs, Dh)))).requires_grad_()
    assert torch.autograd.gradcheck(txlstm.SLSTMScan.apply,
                                    (*wx, *r, h0, c0, n0s, m0s))


@pytest.mark.parametrize("train", [True, False])
def test_routes_under_autograd(train):
    """Where autograd records the call the scans go through the Functions;
    elsewhere they make the plain call they made before."""
    q, k, v, it, ft, st, _, _ = _mlstm_raw(1, 1, 2, 32, 4, 16)
    q, k, v, it, ft = (x.float() for x in (q, k, v, it, ft))
    st = {key: val.float() for key, val in st.items()}
    q.requires_grad_(train)
    h, _ = txlstm.mlstm_chunk_scan(q, k, v, it, ft, st, 16)
    assert (type(h.grad_fn).__name__ == "MLSTMChunkScanBackward") == train
    wx, r, s, _, _ = _slstm_raw(2, 1, 5, 2, 3)
    wx["z"].requires_grad_(train)
    h, _ = txlstm.slstm_scan(wx, r, s)
    assert (type(h.grad_fn).__name__ == "SLSTMScanBackward") == train
