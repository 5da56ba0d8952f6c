"""B6-bwd's order of summation for dLambda on the CPU
(`repro_torch.models.rglru`).

The kernel (`models/csrc/rglru_scan_bwd.cu`) walks each tile of
`KERNEL_CHUNK` steps with `BWD_WARPS` warps: each warp adds its steps' da
a r from the last, the warps' sums are added in order, the tile's sum
times -8 sigmoid(Lambda) goes to dLambda by one atomic per channel.
`rglru_scan_bwd_tiles_plain` sums in that order. It is held against:
  * `rglru_scan_bwd_plain` (one sum over B and T): dwa, dwx, dx and dh0
    equal, dLambda within 1e-5 x max |plain| in f32 (the same terms in
    another order) and 1e-12 in f64;
  * `jax.grad` of the JAX package's `rglru_apply` at f32 through
    `RGLRUScan`, with the tile order in place of the plain backward: every
    leaf within 1e-4 x max |reference| (tests/test_torch_rglru_bwd.py's
    tolerance, stated before the first run).
The cases span several tiles (T 97 to 300, the last ragged), channels
across a channel tile (D 130), h0 or none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro_torch.models import rglru as trglru

CASES = [(2, 200, 16, True), (1, 97, 130, False), (2, 300, 8, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(seed, B, T, D, dtype):
    rng = np.random.default_rng(seed)
    wa, wx, x, dy = (torch.from_numpy(rng.standard_normal((B, T, D)))
                     .to(dtype) for _ in range(4))
    lam = torch.from_numpy(rng.uniform(0.01, 0.5, D)).to(dtype)
    h0, dhl = (torch.from_numpy(rng.standard_normal((B, D))).to(dtype)
               for _ in range(2))
    return wa, wx, x, lam, h0, dy, dhl


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("B,T,D,with_h0", CASES)
def test_tile_order_is_the_plain_backward(B, T, D, with_h0, dtype, tol):
    wa, wx, x, lam, h0, dy, dhl = _raw(T + D, B, T, D, dtype)
    h0 = h0 if with_h0 else None
    got = trglru.rglru_scan_bwd_tiles_plain(wa, wx, x, lam, h0, dy, dhl)
    want = trglru.rglru_scan_bwd_plain(wa, wx, x, lam, h0, dy, dhl)
    for i in (0, 1, 2):
        assert torch.equal(got[i], want[i])
    assert (got[4] is None) == (want[4] is None)
    if want[4] is not None:
        assert torch.equal(got[4], want[4])
    err = float((got[3] - want[3]).abs().max())
    assert err <= tol * float(want[3].abs().max()), err


@pytest.mark.parametrize("B,T,D,with_h0", CASES)
def test_function_with_tile_order_matches_jax_grad(monkeypatch, B, T, D,
                                                   with_h0):
    rng = np.random.default_rng(B * 1000 + T + D)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    p = {"wa": {"w": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(
             np.float32), "b": np.full(D, 0.1, np.float32)},
         "wx": {"w": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(
             np.float32), "b": np.full(D, -0.2, np.float32)},
         "lam": rng.uniform(0.01, 0.5, D).astype(np.float32)}
    h0 = rng.standard_normal((B, D)).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal((B, T, D)).astype(np.float32)
    dhl = rng.standard_normal((B, D)).astype(np.float32)

    def loss(p_, x_, h0_):
        y, hl = jrglru.rglru_apply(p_, x_, h0_)
        return (y * dy).sum() + (hl * dhl).sum()
    jg_p, jg_x, jg_h0 = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        None if h0 is None else jnp.asarray(h0))
    used = []

    def tiles(*args):
        used.append(1)
        return trglru.rglru_scan_bwd_tiles_plain(*args)
    monkeypatch.setattr(trglru, "rglru_scan_bwd_plain", tiles)
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    y, hl = trglru.rglru_apply(tp, tx, th0)
    ((y * torch.from_numpy(dy)).sum()
     + (hl * torch.from_numpy(dhl)).sum()).backward()
    assert used == [1]
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
