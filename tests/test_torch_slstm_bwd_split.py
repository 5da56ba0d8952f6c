"""B8-bwd's design on the CPU: the sLSTM backward with only the linear part
of its cell on the step chain (`repro_torch.models.xlstm`).

The kernel (`models/csrc/slstm_bwd.cu`) forms every step's coefficients
from the forward's record off the chain and, after each exchange, runs
only a linear update from dh_rec and the carried dc, dn; it forms dh_rec
from per-block partial sums and a tree over the cluster's slots. Its
arithmetic in that order, `slstm_scan_bwd_split_plain` (with
`slstm_bwd_coefficients_plain` and `slstm_bwd_partials_plain`), is held
against:
  * `slstm_scan_bwd_plain` and `torch.autograd` through
    `slstm_scan_plain` in f64, with no detach anywhere, to 1e-10 of the
    largest |value| of each gradient (the same function, a few hundred
    f64 operations apart);
  * the f64 plain backward when it runs in f32 on an f32 record, to
    1e-5 x max |f64| (f32 sums in other orders; the card's own tolerance,
    1e-3, is a hundred times looser);
  * `jax.grad` of the JAX package's `slstm_apply` through `SLSTMScan` on
    the CPU, with the emulation in place of the plain backward, f32 at
    1e-5 x max |reference| of each gradient (the tolerance and the
    gradient plumbing of tests/test_torch_xlstm_bwd.py, which holds the
    plain backward itself there).
The cases span head sizes 5, 20, 192 and 256 (clusters of 1, 1, 6 and 8
blocks), ragged T, final-state gradients present and absent, and input
gates driven by a square wave so that the step's max takes both branches
and flips between them within the run (asserted)."""

import contextlib
import types

import jax
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxlstm
from repro_torch.models import xlstm as txlstm
from test_torch_xlstm_bwd import (_close, _grad_close, _j_slstm, _jax_grads,
                                  _torch_grads)

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


def _wave(T, flip):
    """A square wave of height `flip` and period 8 steps over T."""
    return np.where(np.arange(T) % 8 < 4, flip, -flip)


def _raw(seed, B, T, H, Dh, flip=0.0):
    """wx, r, a random state, final-state gradients and dh, f64; wx_i plus
    `_wave(T, flip)`."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape))
    d = H * Dh
    wx = {g: t(B, T, d) for g in "zifo"}
    wx["i"] = wx["i"] + torch.from_numpy(_wave(T, flip))[None, :, None]
    r = {g: t(H, Dh, Dh) * Dh ** -0.5 for g in "zifo"}
    st = {"h": torch.tanh(t(B, H, Dh)), "c": t(B, H, Dh),
          "n": 1.0 + torch.from_numpy(rng.random((B, H, Dh))),
          "m": t(B, H, Dh)}
    fin = {key: t(B, H, Dh) for key in "hcnm"}
    return wx, r, st, fin, t(B, T, d)


def _flat(out):
    delta, dR, *rest = out
    return [delta[:, :, g] for g in range(4)] + list(dR) + rest


NAMES = ([f"dwx_{g}" for g in "zifo"] + [f"dr_{g}" for g in "zifo"]
         + ["dh0", "dc0", "dn0", "dm0"])

#: (B, T, H, Dh, flip): head sizes of clusters 1, 1, 6 and 8, ragged T.
CASES = [(2, 9, 2, 5, 0.0), (2, 37, 1, 20, 3.0), (1, 7, 1, 192, 3.0),
         (1, 5, 1, 256, 0.0)]


@pytest.mark.parametrize("B,T,H,Dh,flip", CASES)
@pytest.mark.parametrize("final", [True, False])
def test_split_is_the_plain_backward_and_f64_autograd(B, T, H, Dh, flip,
                                                      final):
    wx, r, st, fin, dh = _raw(B * T + Dh, B, T, H, Dh, flip)
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
    if flip:
        wins = txlstm.slstm_lsf_wins(saved, st["m"])
        assert bool(wins.any()) and not bool(wins.all())
        assert bool((wins[:, 1:] != wins[:, :-1]).any())
    given = [fin[key] if final else None for key in "hcnm"]
    args = ([r[g] for g in "zifo"], *st.values(), h, saved, dh, *given)
    got = _flat(txlstm.slstm_scan_bwd_split_plain(*args))
    plain = _flat(txlstm.slstm_scan_bwd_plain(*args))
    for name, a, b, c in zip(NAMES, got, plain, want):
        _close(a, b, F64_TOL, f"{name} vs plain")
        _close(a, c, F64_TOL, f"{name} vs autograd")


@pytest.mark.parametrize("B,T,H,Dh,flip", CASES)
def test_split_in_f32_is_the_f64_backward(B, T, H, Dh, flip):
    wx, r, st, fin, dh = _raw(7 * T + Dh, B, T, H, Dh, flip)
    h, _, saved = txlstm.slstm_scan_plain(wx, r, st, with_saved=True)
    args = ([r[g] for g in "zifo"], *st.values(), h, saved, dh,
            *fin.values())
    want = _flat(txlstm.slstm_scan_bwd_plain(*args))
    f32 = ([x.float() for x in args[0]],
           *(x.float() for x in args[1:]))
    got = _flat(txlstm.slstm_scan_bwd_split_plain(*f32))
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.float32, name
        _close(a, b, F32_TOL, name)


def test_coefficients_are_the_cells_terms():
    """Each coefficient against the cell's backward written out, step by
    step, with the gauge term carried as the first design carried it: on
    while log_sigmoid(f~) + m wins, into i~ and stopped where i~ wins."""
    B, T, H, Dh = 2, 24, 2, 6
    wx, r, st, fin, dh = _raw(5, B, T, H, Dh, 3.0)
    h, s1, saved = txlstm.slstm_scan_plain(wx, r, st, with_saved=True)
    d = H * Dh
    g = (fin["m"] - fin["c"] * s1["c"] - fin["n"] * s1["n"]).reshape(B, d)
    coef, wins = txlstm.slstm_bwd_coefficients_plain(
        saved, dh, st["c"], st["n"], st["m"], g)
    assert coef.shape == (B, T, len(txlstm.SLSTM_BWD_COEFS), d)
    assert bool(wins.any()) and not bool(wins.all())
    flat = [x.reshape(B, d) for x in (st["c"], st["n"], st["m"])]
    for t in reversed(range(T)):
        k = dict(zip(txlstm.SLSTM_BWD_COEFS, coef[:, t].unbind(1)))
        cp, np_, mp = txlstm._slstm_prev(saved, t, *flat)
        pz, pi, pf, po = saved[:, t, :4].unbind(1)
        lsf = torch.nn.functional.logsigmoid(pf + 1.0)
        mn = torch.maximum(lsf + mp, pi)
        ip, fp = torch.exp(pi - mn), torch.exp(lsf + mp - mn)
        z, o = torch.tanh(pz), torch.sigmoid(po)
        cn, nn = fp * cp + ip * z, fp * np_ + ip
        terms = {"dh": dh[:, t], "kdc": o / nn, "kdn": o * cn / nn ** 2,
                 "kdo": cn / nn * o * (1 - o), "kz": ip * (1 - z * z),
                 "kzi": z * ip, "ip": ip, "kc": cp * fp, "kn": np_ * fp,
                 "kf": torch.sigmoid(-(pf + 1.0)), "fp": fp}
        on = lsf + mp >= pi
        assert torch.equal(on, wins[:, t])
        terms["gf"] = torch.where(on, g, 0.0)
        terms["gi"] = torch.where(on, 0.0, g)
        g = terms["gf"]
        for name, want in terms.items():
            _close(k[name], want, F64_TOL, f"{name} at step {t}")


@pytest.mark.parametrize("Dh", [5, 20, 33, 192, 256])
def test_partials_are_dh_rec_by_blocks_and_slots(Dh):
    """dh_rec from the cluster's per-block partials and the slot tree is
    the whole product sum_g R_g delta_g, at every cluster size B8-bwd
    launches (1 to 8 blocks)."""
    rng = np.random.default_rng(Dh)
    B, H = 2, 2
    dg = torch.from_numpy(rng.standard_normal((B, 4, H, Dh)))
    R = torch.from_numpy(rng.standard_normal((4, H, Dh, Dh)))
    CL = txlstm.slstm_cluster(Dh)
    assert 1 <= CL <= txlstm.SLSTM_MAX_CL
    got = txlstm.slstm_bwd_partials_plain(dg, R, CL)
    want = torch.einsum("bghe,ghde->bhd", dg, R).reshape(B, H * Dh)
    _close(got, want, F64_TOL)


@pytest.mark.parametrize("B,T,H,Dh,flip", CASES)
def test_dr_product_is_the_plain_backwards(B, T, H, Dh, flip):
    """`slstm_bwd_dr`, the product B8-bwd's wrapper runs after its kernel,
    in f32 against the plain backward's dR in f64 (1e-5)."""
    wx, r, st, fin, dh = _raw(3 * T + Dh, B, T, H, Dh, flip)
    h, _, saved = txlstm.slstm_scan_plain(wx, r, st, with_saved=True)
    delta, dR, *_ = txlstm.slstm_scan_bwd_plain(
        [r[g] for g in "zifo"], *st.values(), h, saved, dh, *fin.values())
    got = txlstm.slstm_bwd_dr(st["h"].float(), h.float(), delta.float())
    for g, (a, b) in enumerate(zip(got, dR)):
        assert a.dtype == torch.float32 and a.shape == (H, Dh, Dh)
        _close(a, b, F32_TOL, f"dr_{'zifo'[g]}")


@pytest.fixture
def launches(monkeypatch):
    """B8-bwd's C entry point replaced by a recorder, and the card's device
    context and stream by stand-ins; device checks pass CPU tensors."""
    calls = []

    def get(name, *_):
        def record(*args):
            calls.append((name, args))
            return 0
        return record
    monkeypatch.setattr(txlstm, "_slstm_fn", get)
    monkeypatch.setattr(txlstm, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    return calls


@pytest.mark.parametrize("Dh,cluster", [(5, 1), (20, 1), (192, 6),
                                        (256, 8)])
@pytest.mark.parametrize("final", [True, False])
def test_wrapper_hands_the_kernel_its_launch(launches, Dh, cluster, final):
    """What `slstm_scan_bwd_cuda` hands the C entry point: 18 pointers (the
    four R, c0, n0, m0, the record, dh, the four final-state gradients —
    null where absent —, delta and the four initial-state gradients),
    then B, T, H, Dh, R's dtype code (bf16: 1), the cluster and the
    stream; one launch counted, by the kernel alone too."""
    B, T, H = 2, 3, 2
    d = H * Dh
    r = [torch.zeros(H, Dh, Dh, dtype=torch.bfloat16) for _ in range(4)]
    st = [torch.zeros(B, H, Dh) for _ in range(4)]
    h, dh = torch.zeros(B, T, d), torch.zeros(B, T, d)
    saved = torch.zeros(B, T, txlstm.SLSTM_SAVED, d)
    fin = [torch.zeros(B, H, Dh) if final else None for _ in range(4)]
    before = txlstm.slstm_scan_bwd_cuda.launches
    delta, dR, *out = txlstm.slstm_scan_bwd_cuda(r, *st, h, saved, dh, *fin)
    assert txlstm.slstm_scan_bwd_cuda.launches == before + 1
    assert delta.shape == (B, T, 4, d) and len(dR) == 4
    assert all(x.shape == (B, H, Dh) for x in out)
    ((name, args),) = launches
    assert name == "slstm_bwd"
    assert args[:4] == tuple(x.data_ptr() for x in r)
    assert args[7:9] == (saved.data_ptr(), dh.data_ptr())
    assert all((a != 0) == final for a in args[9:13])
    assert args[13] == delta.data_ptr()
    assert args[18:] == (B, T, H, Dh, 1, cluster, 7)
    txlstm.slstm_bwd_cells_cuda(r, *st[1:], h, saved, dh, *fin)
    assert txlstm.slstm_scan_bwd_cuda.launches == before + 2
    assert len(launches) == 2 and launches[1][1][18:] == args[18:]


# ---- SLSTMScan against jax.grad of the reference ------------------------

@pytest.mark.parametrize("T,H,d,bias_i", [(11, 3, 15, 1.0), (23, 2, 40, 0.0),
                                          (9, 1, 192, -1.0)])
def test_slstm_scan_matches_jax_grad(monkeypatch, T, H, d, bias_i):
    """`SLSTMScan` on the CPU under `slstm_apply`, with the kernel's
    arithmetic in place of the plain backward, against `jax.grad` of the
    reference's `slstm_apply`: every parameter's, the input's and the
    carried state's gradient, f32, each within 1e-5 x max |reference|.
    `bias_i` shifts the input gate's bias, so that i~ wins the max more or
    less often."""
    used = []

    def split(*args):
        used.append(1)
        return txlstm.slstm_scan_bwd_split_plain(*args)
    monkeypatch.setattr(txlstm, "slstm_scan_bwd_plain", split)
    B = 2
    rng = np.random.default_rng(T + d)
    p = jax.tree.map(np.array, jxlstm.slstm_init(jax.random.PRNGKey(T), d,
                                                 H))
    p["wi"]["b"] = p["wi"]["b"] + np.float32(bias_i)
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
    assert used == [1]
    _grad_close(tp, jp, "params")
    _close(tx, torch.from_numpy(np.asarray(jx)), F32_TOL, "x")
    _grad_close(ts, js, "state")
