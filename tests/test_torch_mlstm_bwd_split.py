"""B7-bwd's tensor-core arithmetic on the CPU (`repro_torch.models.xlstm`).

The kernels (`models/csrc/mlstm_chunk_bwd.cu`) form the products of
passes 1 and 3 on `mma.sync` m16n8k16 in bf16: every f32 operand cut into
three bf16 pieces as it is loaded into a fragment, each product the six
piece products a_i b_j (0-based i + j <= 2) of 16 rows of K at a time
added to one f32 accumulator, the state part (K = D) and the
intra-chunk part (K = L) of dv, dk and dq in one accumulator with the
scaling between them. The kernels cannot run here, so their arithmetic is
held in plain versions of it:

* the pieces (`split3_plain`, tests/test_torch_flash_f32_bwd_split.py
  holds them bit by bit): bf16 each, |x2| <= 2^-8 |x|, |x3| <= 2^-16
  |x|, summing to x; `pieces3_matmul_plain` within (2^-23 + (6 K / 16 +
  8) x 2^-24) x (|a| @ |b|) of the f64 product at K 16 to 256 (the
  dropped piece products and the f32 sums), a hundred times closer than
  one bf16 product;
* `mlstm_chunk_scan_bwd_split_plain` (the two split passes around the
  plain reverse scan) in f32 against f64 autograd through
  `mlstm_chunk_scan_plain` with no detach: each gradient's distance from
  the f64 result within the plain f32 backward's own distance plus 1e-5 x
  max |f64| (both f32 sides inherit the f32 forward's rounding, up to
  about 1e-5 of the largest value at D 192), at D 16 and 192, chunks 16,
  40 and 64, a carried state and random final-state gradients (the gauge
  term), the extreme gates of tests/test_torch_xlstm_passes.py, and rows
  on both branches of the denominator (asserted to occur);
* `MLSTMChunkScan` on the CPU under `mlstm_chunkwise`, with the split
  arithmetic in place of the plain backward, against `jax.grad` of the
  JAX package's `mlstm_chunkwise`: every parameter's, the input's and the
  carried state's gradient, f32, each within 1e-5 x max |reference|
  (stated before the first run: tests/test_torch_xlstm_bwd.py's
  tolerance for the plain backward). At the extreme gates, and at D 192,
  each f32 side is held against the Function's f64 gradients by that
  file's witness rule: at D 192 two f32 computations of the same gradient
  part by more than 1e-5 of its largest value (at chunk 40, T 80 the
  plain backward's wf bias gradient lies 1.0e-5 of it from jax.grad's).
  A tf32 hi + lo split (three passes) was tried first, in an emulation
  like this one, and failed the witness rule at the extreme gates at D
  192 (the wf bias gradient); the bf16 pieces pass it."""

import jax
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxlstm
from repro_torch.kernels.local_attention.local_attention import split3_plain
from repro_torch.models import xlstm as txlstm
from test_torch_xlstm_bwd import (F32_TOL, _close, _grad_close, _j_mlstm,
                                  _jax_grads, _leaves, _mlstm_autograd,
                                  _mlstm_forward, _mlstm_raw, _torch_grads,
                                  _witness_close)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split_values(kind):
    rng = np.random.default_rng(31)
    if kind == "normal":
        x = rng.standard_normal(8192) * 2.0 ** rng.uniform(-60, 60, 8192)
    else:  # zeros and values down to where the third piece still fits
        x = np.concatenate([
            [0.0, -0.0, 2.0 ** -100, -(2.0 ** -100)],
            rng.standard_normal(2048) * 2.0 ** rng.uniform(-100, -80, 2048)])
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("kind", ["normal", "small"])
def test_pieces_are_within_their_bound(kind):
    x = _split_values(kind)
    pieces = split3_plain(x)
    assert all(p.dtype == torch.bfloat16 for p in pieces)
    x1, x2, x3 = (p.double() for p in pieces)
    xd = x.double()
    assert bool((x2.abs() <= 2.0 ** -8 * xd.abs()).all())
    assert bool((x3.abs() <= 2.0 ** -16 * xd.abs()).all())
    assert torch.equal(x1 + x2 + x3, xd)


@pytest.mark.parametrize("K", [16, 40, 64, 192, 256])
def test_pieces_matmul_is_within_its_bound(K):
    rng = np.random.default_rng(K)
    a = torch.from_numpy((rng.standard_normal((3, 64, K))
                          * 2.0 ** rng.uniform(-8, 8, (3, 64, K)))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, K, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err = (txlstm.pieces3_matmul_plain(a, b).double() - exact).abs()
    bound = (2.0 ** -23 + (6 * K / 16 + 8) * 2.0 ** -24) * scale
    assert bool((err <= bound).all())
    one_piece = split3_plain(a)[0].double() @ split3_plain(b)[0].double()
    assert float(err.max()) * 100 < float((one_piece - exact).abs().max())
    # With an accumulator: added to it, the products after.
    acc = torch.from_numpy(rng.standard_normal((3, 64, 48))
                           .astype(np.float32))
    got = txlstm.pieces3_matmul_plain(a, b, acc).double()
    assert bool(((got - exact - acc.double()).abs()
                 <= bound + 2.0 ** -22 * acc.double().abs()).all())


SPLIT_CASES = [  # (chunk, D, T, extreme)
    (16, 16, 96, False), (40, 16, 200, False), (64, 16, 192, False),
    (64, 192, 128, False), (40, 192, 120, False), (16, 16, 96, True),
    (40, 16, 240, True), (64, 192, 192, True)]


@pytest.mark.parametrize("chunk,D,T,extreme", SPLIT_CASES)
def test_split_backward_is_f64_autograd(chunk, D, T, extreme):
    B, H = 2, 2 if D < 192 else 1
    raw = _mlstm_raw(chunk + D + T + 31, B, H, T, D, chunk, extreme)
    q, k, v, it, ft, st, fin, dh = raw
    want, _ = _mlstm_autograd(q, k, v, it, ft, st, fin, dh, chunk)
    f32 = [x.float() for x in (q, k, v, it, ft, dh)]
    q, k, v, it, ft, dh = f32
    st, fin = ({key: x.float() for key, x in s.items()} for s in (st, fin))
    h, dot, work, scal, s1 = _mlstm_forward(q, k, v, it, ft, st, chunk)
    args = (q, k, v, it, ft, h, dot, work, scal, s1["C"], s1["n"], dh,
            fin["C"], fin["n"], fin["m"], chunk)
    got = txlstm.mlstm_chunk_scan_bwd_split_plain(*args)
    ref = txlstm.mlstm_chunk_scan_bwd_plain(*args)
    for name, a, r, w in zip(("dq", "dk", "dv", "di", "df", "dC0", "dn0",
                              "dm0"), got, ref, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        _witness_close(a, r.numpy(), w, name)
    *_, on_dot = txlstm._bwd_rows(dot, it, ft, scal, chunk)
    assert bool(on_dot.any()) and bool((~on_dot).any())


@pytest.mark.parametrize("chunk,D,T,extreme", [
    (16, 16, 96, False), (40, 16, 200, False), (64, 16, 128, False),
    (64, 192, 128, False), (40, 192, 80, False), (40, 16, 240, True),
    (64, 192, 128, True)])
def test_function_with_split_backward_matches_jax_grad(
        monkeypatch, chunk, D, T, extreme):
    """jax.grad of the reference against `MLSTMChunkScan` with the split
    arithmetic as its CPU backward, both f32, a carried state and random
    gradients of the final state. At the extreme gates and at D 192 each
    side is held against the Function's f64 gradients (through the plain
    backward) by `_witness_close`."""
    B, H, d = 2, 2, 48
    rng = np.random.default_rng(310 + chunk + D)
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
    by_witness = extreme or D >= 192
    witness = port(np.float64) if by_witness else None
    used = []

    def split(*args):
        used.append(1)
        return txlstm.mlstm_chunk_scan_bwd_split_plain(*args)
    monkeypatch.setattr(txlstm, "mlstm_chunk_scan_bwd_plain", split)
    tp, tx, ts = port()
    assert used == [1]
    if not by_witness:
        _grad_close(tp, jp, "params")
        _close(tx, torch.from_numpy(np.asarray(jx)), F32_TOL, "x")
        _grad_close(ts, js, "state")
        return
    fp, fx, fs = witness
    ref, want = (dict(_leaves({"p": g, "s": s_})) for g, s_ in
                 ((jp, js), (fp, fs)))
    for path, got in _leaves({"p": tp, "s": ts}):
        _witness_close(got, ref[path], want[path], path)
    _witness_close(tx, jx, fx, "x")
