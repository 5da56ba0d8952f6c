"""The backward of the RG-LRU scan (B6-bwd's plain version and the
autograd Function around it) on the CPU.

`rglru_scan_bwd_plain` recomputes (a, b) and h from the inputs and scans
the gradient of h from the end of T, as the kernel
`models/csrc/rglru_scan_bwd.cu` does. It is held against:
  * `torch.autograd` through `rglru_scan_plain` in f64, to 1e-10 (the
    same function: the plain version computes in f64 for f64 inputs), and
    with f32 / bf16 inputs (the plain backward computing in f32 and
    rounding each output once) within 1e-5 x max |f64 gradient| of that
    tensor, one bf16 ulp of the value more for a bf16 output;
  * `jax.grad` of the JAX package's `rglru_apply` at f32 (the gradients
    of the dense layers' weights and biases, of Lambda, x and h0 through
    `RGLRUScan`), each leaf within 1e-4 x max |reference| (the reference
    scans by `associative_scan`, the port step by step: f32 sums in other
    orders);
and `RGLRUScan` passes `torch.autograd.gradcheck` in f64. The cases span
h0 or none, ragged T, bf16 and f32 inputs, a bf16 Lambda, and the clamp
case a = 1 (wa far below 0, so that 1 - a^2 < 1e-9: the square root
passes a no gradient while i and x keep theirs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro_torch.models import rglru as trglru


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, T, D, clamp=False):
    """(wa, wx, x, lam, h0, dy, dh_last) as f64 numpy arrays; `clamp`
    shifts wa to -40 (r ~ 4e-18: a = 1 in f32 and 1 - a^2 < 1e-9 in
    f64)."""
    rng = np.random.default_rng(seed)
    wa, wx, x, dy = (rng.standard_normal((B, T, D)) for _ in range(4))
    if clamp:
        wa = wa - 40.0
    lam = rng.uniform(0.01, 0.5, D)
    h0, dh_last = (rng.standard_normal((B, D)) for _ in range(2))
    return wa, wx, x, lam, h0, dy, dh_last


def _f64_autograd(wa, wx, x, lam, h0, dy, dh_last):
    """Gradients of <y, dy> + <h_last, dh_last> by torch.autograd through
    `rglru_scan_plain` in f64: (dwa, dwx, dx, dlam, dh0 or None)."""
    ins = [torch.from_numpy(a).requires_grad_() if a is not None else None
           for a in (wa, wx, x, lam, h0)]
    y, hl = trglru.rglru_scan_plain(*ins)
    loss = (y * torch.from_numpy(dy)).sum() \
        + (hl * torch.from_numpy(dh_last)).sum()
    live = [t for t in ins if t is not None]
    grads = list(torch.autograd.grad(loss, live))
    return grads + ([None] if h0 is None else [])


CASES = {  # name: (B, T, D, dtype, lam dtype, with h0, clamp)
    "f32_h0": (2, 37, 8, torch.float32, torch.float32, True, False),
    "f32_no_h0": (1, 64, 5, torch.float32, torch.float32, False, False),
    "bf16": (2, 50, 16, torch.bfloat16, torch.bfloat16, True, False),
    "bf16_f32_lam": (1, 33, 12, torch.bfloat16, torch.float32, False, False),
    "f32_bf16_lam": (2, 21, 7, torch.float32, torch.bfloat16, True, False),
    "clamp_a1_f32": (2, 30, 6, torch.float32, torch.float32, True, True),
    "clamp_a1_bf16": (1, 25, 8, torch.bfloat16, torch.float32, True, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_bwd_matches_f64_autograd(name):
    B, T, D, dt, lam_dt, with_h0, clamp = CASES[name]
    wa, wx, x, lam, h0, dy, dhl = _inputs(len(name) + T, B, T, D, clamp)
    if not with_h0:
        h0 = None
    # f64 inputs: the same function, to 1e-10.
    want = _f64_autograd(wa, wx, x, lam, h0, dy, dhl)
    got = trglru.rglru_scan_bwd_plain(
        *(None if a is None else torch.from_numpy(a)
          for a in (wa, wx, x, lam, h0, dy, dhl)))
    for label, a, b in zip(("wa", "wx", "x", "lam", "h0"), got, want):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=f"d{label}")
    # The working dtypes: inputs rounded first, autograd in f64 of those.
    def cast(a, t):
        return torch.from_numpy(a).to(t)
    xs = [cast(a, dt) for a in (wa, wx, x)]
    lam_t = cast(lam, lam_dt)
    h0_t = None if h0 is None else cast(h0, torch.float32)
    dy_t, dhl_t = cast(dy, dt), cast(dhl, torch.float32)
    want = _f64_autograd(*(None if t is None else t.double().numpy()
                           for t in (*xs, lam_t, h0_t, dy_t, dhl_t)))
    got = trglru.rglru_scan_bwd_plain(*xs, lam_t, h0_t, dy_t, dhl_t)
    for label, a, b in zip(("wa", "wx", "x", "lam", "h0"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == {"lam": lam_dt, "h0": torch.float32}.get(label, dt)
        d = (a.double() - b).abs()
        tol = 1e-5 * float(b.abs().max())
        if a.dtype == torch.bfloat16:
            tol = tol + torch.exp2(torch.floor(torch.log2(
                b.abs().clamp_min(1e-30))) - 7)
        assert bool((d <= tol).all()), (label, float(d.max()))


def test_clamp_case_passes_a_no_gradient_through_the_square_root():
    """At a = 1 exactly the clamp binds: da is g h_{t-1} alone, so dwa is
    the recurrence's part only; i and x keep their gradients."""
    wa, wx, x, lam, h0, dy, dhl = _inputs(5, 1, 9, 4, clamp=True)
    ts = [torch.from_numpy(a).float() for a in (wa, wx, x, lam, h0, dy, dhl)]
    a = torch.exp(-8.0 * torch.nn.functional.softplus(ts[3])
                  * torch.sigmoid(ts[0]))
    assert bool((a == 1.0).all())
    dwa, dwx, dx, _, _ = trglru.rglru_scan_bwd_plain(*ts)
    assert bool(torch.isfinite(dwa).all())
    assert float(dwx.abs().max()) > 0 and float(dx.abs().max()) > 0


def _jax_grads(p, x, h0, dy, dh_last):
    def loss(p, x, h0):
        y, hl = jrglru.rglru_apply(p, x, h0)
        return (y * dy).sum() + (hl * dh_last).sum()
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(p, x, h0)


@pytest.mark.parametrize("B,T,D,with_h0,clamp", [
    (2, 24, 16, True, False), (1, 40, 8, False, False),
    (2, 17, 12, True, True)])
def test_function_matches_jax_grad_of_rglru_apply(B, T, D, with_h0, clamp):
    rng = np.random.default_rng(B * 100 + T)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    p = {"wa": {"w": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(
             np.float32),
                "b": np.full(D, -40.0 if clamp else 0.1, np.float32)},
         "wx": {"w": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(
             np.float32),
                "b": np.full(D, -0.2, np.float32)},
         "lam": rng.uniform(0.01, 0.5, D).astype(np.float32)}
    h0 = rng.standard_normal((B, D)).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal((B, T, D)).astype(np.float32)
    dhl = rng.standard_normal((B, D)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jg_p, jg_x, jg_h0 = _jax_grads(jp, jnp.asarray(x),
                                   None if h0 is None else jnp.asarray(h0),
                                   jnp.asarray(dy), jnp.asarray(dhl))
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    before = trglru.rglru_scan_bwd_plain.calls
    y, hl = trglru.rglru_apply(tp, tx, th0)
    assert type(y.grad_fn).__name__ == "RGLRUScanBackward"
    ((y * torch.from_numpy(dy)).sum()
     + (hl * torch.from_numpy(dhl)).sum()).backward()
    assert trglru.rglru_scan_bwd_plain.calls == before + 1
    pairs = [(tp["wa"]["w"].grad, jg_p["wa"]["w"]),
             (tp["wa"]["b"].grad, jg_p["wa"]["b"]),
             (tp["wx"]["w"].grad, jg_p["wx"]["w"]),
             (tp["wx"]["b"].grad, jg_p["wx"]["b"]),
             (tp["lam"].grad, jg_p["lam"]), (tx.grad, jg_x)]
    if with_h0:
        pairs.append((th0.grad, jg_h0))
    for i, (a, b) in enumerate(pairs):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-4 * max(np.abs(b).max(), 1e-30), (i, err)


@pytest.mark.parametrize("B,T,D,with_h0", [(2, 6, 3, True), (1, 9, 4, False),
                                           (2, 5, 2, True)])
def test_function_passes_gradcheck_in_f64(B, T, D, with_h0):
    rng = np.random.default_rng(T + D)
    wa, wx, x = (torch.from_numpy(rng.standard_normal((B, T, D)))
                 .requires_grad_() for _ in range(3))
    lam = torch.from_numpy(rng.uniform(0.01, 0.5, D)).requires_grad_()
    h0 = torch.from_numpy(rng.standard_normal((B, D))).requires_grad_() \
        if with_h0 else None
    assert torch.autograd.gradcheck(
        lambda *a: trglru.RGLRUScan.apply(*a), (wa, wx, x, lam, h0))
