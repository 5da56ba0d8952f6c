"""B6, the RG-LRU scan (`repro_torch.models.rglru`): the kernel's order of
arithmetic, and its CUDA wrapper's checks and launch.

The kernel (`csrc/rglru_scan.cu`) cuts T into tiles of L steps, each tile
into segments of R steps (one warp each). Every segment is scanned from 0
into a map h -> P h + H; the segments compose into each one's incoming
map and the tile's aggregate; a tile's incoming h comes from the nearest
earlier tile that has published its inclusive h, composed with the
aggregates of the tiles between (a decoupled look-back, whose depth
depends on timing); then each segment runs the plain recurrence
h = a h + b from its incoming h. `_kernel_order` below does the same in
f32 — with look-back depths drawn at random, so that one tile's incoming h
is composed from several predecessors' aggregates — and is held, like the
port's `rglru_apply`, against the JAX package's `rglru_apply`: parameters
made by the reference and carried across with `params_from_jax`, inputs
made with numpy from a seed. Recipes: the Griffin init as it is (a ~ 0.04
at the dense outputs' scale) and the long-memory recipe, the recurrence
gate's bias lowered by 8 (a ~ 0.999, Griffin's intended range): only
there does a carry live past a few steps, so only there would a wrong
look-back show.

Tolerance: atol = rtol = 1e-5 in f32 (both sides compute in f32 and sum in
other orders; the dense products of the two frameworks differ by a few
f32 roundings). The CUDA kernel is held against `rglru_scan_plain` on the
card by chip_smoke.py (1e-4 of the largest |y|).

The wrapper's checks run on CPU tensors that say they live on a card,
with the kernel's entry point replaced by a recorder."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models.interop import params_from_jax
from torch_parity import fake_cuda

TOL = 1e-5
_j_rglru = jax.jit(jrglru.rglru_apply)


def _compose(outer, inner):
    """The map h -> outer(inner(h)) of two (A, H) maps h -> A h + H."""
    return outer[0] * inner[0], outer[0] * inner[1] + outer[1]


def _kernel_order(wa, wx, x, lam, h0, L, R, seed):
    """The kernel's arithmetic on (B, T, D) f32 tensors: tiles of L steps
    in segments of R, each tile's incoming h from the inclusive h of a
    tile 1-4 tiles back (drawn from `seed`), composed with the aggregates
    between. Returns (y, h_last) in f32."""
    assert L % R == 0
    a, b = trglru._gate_values(wa, wx, x, lam)
    B, T, D = x.shape
    nt = -(-T // L)
    pad = nt * L - T
    a = torch.cat([a, torch.ones(B, pad, D)], 1)
    b = torch.cat([b, torch.zeros(B, pad, D)], 1)
    one, zero = torch.ones(B, D), torch.zeros(B, D)
    segs = []                        # per tile: each segment's (P, H)
    for t in range(nt):
        row = []
        for s0 in range(t * L, (t + 1) * L, R):
            P, H = one, zero
            for u in range(s0, s0 + R):
                P, H = a[:, u] * P, a[:, u] * H + b[:, u]
            row.append((P, H))
        segs.append(row)
    aggs = []
    for row in segs:
        agg = (one, zero)
        for m in row:
            agg = _compose(m, agg)
        aggs.append(agg)
    rng = np.random.default_rng(seed)
    inc, h_in = [], []
    for t in range(nt):
        if t == 0:
            hin = zero if h0 is None else h0
        else:
            back = int(rng.integers(1, 5))
            j = max(t - back, 0)
            acc = (one, zero)
            for q in range(t - 1, j, -1):
                acc = _compose(acc, aggs[q])
            hin = acc[0] * inc[j] + acc[1]
        h_in.append(hin)
        inc.append(aggs[t][0] * hin + aggs[t][1])
    y = torch.empty(B, nt * L, D)
    for t in range(nt):
        ex = (one, zero)
        for k, m in enumerate(segs[t]):
            h = ex[0] * h_in[t] + ex[1]
            for u in range(t * L + k * R, t * L + (k + 1) * R):
                h = a[:, u] * h + b[:, u]
                y[:, u] = h
            ex = _compose(m, ex)
    return y[:, :T], y[:, T - 1]


def _setup(seed, B, T, D, long_memory, with_h0):
    p = jrglru.rglru_init(jax.random.PRNGKey(seed), D)
    if long_memory:
        p["wa"]["b"] = p["wa"]["b"] - 8.0
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32) if with_h0 else None
    return p, tp, x, h0


def _reference(p, x, h0):
    ya, ha = _j_rglru(p, jnp.asarray(x),
                      None if h0 is None else jnp.asarray(h0))
    return np.asarray(ya), np.asarray(ha)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


L_KERNEL = trglru.KERNEL_CHUNK
R_KERNEL = L_KERNEL // trglru.KERNEL_WARPS  # steps a warp scans
CASES = {
    # name: (B, T, L, R, h0)
    "kernel_tile": (1, 4 * L_KERNEL, L_KERNEL, R_KERNEL, False),
    "odd_tile_b2_h0": (2, 105, 21, 3, True),
    "ragged_t": (2, 3 * L_KERNEL + 7, L_KERNEL, R_KERNEL, False),
    "b2_h0": (2, 5 * L_KERNEL, L_KERNEL, R_KERNEL, True),
}


@pytest.mark.parametrize("long_memory", [False, True],
                         ids=["griffin_init", "long_memory"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_order_matches_jax(case, long_memory):
    B, T, L, R, with_h0 = CASES[case]
    D = 24
    p, tp, x, h0 = _setup(11, B, T, D, long_memory, with_h0)
    xt = torch.from_numpy(x)
    wa = tlayers.dense_apply(tp["wa"], xt)
    wx = tlayers.dense_apply(tp["wx"], xt)
    y, h_last = _kernel_order(wa, wx, xt, tp["lam"],
                              None if h0 is None else torch.from_numpy(h0),
                              L, R, seed=len(case))
    ya, ha = _reference(p, x, h0)
    _close(y, ya)
    _close(h_last, ha)
    if long_memory:
        # The recipe reaches what it is for: a carry that lives across
        # tiles (a over one tile multiplies to well above 0).
        a, _ = trglru._gate_values(wa, wx, xt, tp["lam"])
        assert float(a[:, :L].prod(1).median()) > 0.5


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_apply_matches_jax_at_long_memory(with_h0):
    p, tp, x, h0 = _setup(13, 2, 150, 32, True, with_h0)
    y, h_last = trglru.rglru_apply(
        tp, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    ya, ha = _reference(p, x, h0)
    _close(y, ya)
    _close(h_last, ha)


# ---------------------------------------------------------------------------
# The CUDA wrapper
# ---------------------------------------------------------------------------

def _args(B=2, T=5, D=16, dtype=torch.float32, lam_dtype=torch.float32,
          h0=True):
    wa, wx, x = (fake_cuda(torch.zeros(B, T, D, dtype=dtype))
                 for _ in range(3))
    lam = fake_cuda(torch.zeros(D, dtype=lam_dtype))
    return [wa, wx, x, lam, fake_cuda(torch.zeros(B, D)) if h0 else None]


def _edit(i, t):
    def edit(args):
        args[i] = fake_cuda(t)
    return edit


@pytest.mark.parametrize("edit,match", [
    (_edit(0, torch.zeros(2, 5, 15)), "one \\(B, T, D\\) shape"),
    (_edit(2, torch.zeros(10, 16)), "one \\(B, T, D\\) shape"),
    (_edit(1, torch.zeros(2, 5, 16, dtype=torch.bfloat16)), "one dtype"),
    (lambda a: a.__setitem__(slice(0, 3), [fake_cuda(
        torch.zeros(2, 5, 16, dtype=torch.float16))] * 3), "one dtype"),
    (_edit(3, torch.zeros(15)), "lam must be"),
    (_edit(3, torch.zeros(16, dtype=torch.float16)), "lam must be"),
    (_edit(4, torch.zeros(2, 15)), "h0 must be"),
    (_edit(4, torch.zeros(2, 16, dtype=torch.bfloat16)), "h0 must be"),
    (_edit(2, torch.zeros(2, 16, 5).transpose(1, 2)), "contiguous"),
    (lambda a: a.__setitem__(slice(0, 3), [fake_cuda(
        torch.zeros(2, 0, 16))] * 3), "non-empty"),
], ids=["wa_shape", "x_2d", "wx_dtype", "float16", "lam_shape",
        "lam_float16", "h0_shape", "h0_bf16", "x_not_contiguous", "empty"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(edit, match):
    args = _args()
    edit(args)
    with pytest.raises(ValueError, match=match):
        trglru.rglru_scan_cuda(*args)


@pytest.fixture
def launches(monkeypatch):
    """The kernel's entry point and scratch size replaced by recorders,
    and the card's device context and stream by stand-ins."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(trglru, "_lib", lambda: (
        record,
        lambda B, T, D: calls.append(("size", B, T, D)) or 64))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    return calls


@pytest.mark.parametrize("dtype,lam_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_one_call_is_one_launch(launches, dtype, lam_dtype):
    B, T, D = 3, 70, 40
    args = _args(B, T, D, dtype, lam_dtype, h0=dtype == torch.float32)
    before = trglru.rglru_scan_cuda.launches
    y, h_last = trglru.rglru_scan_cuda(*args)
    assert trglru.rglru_scan_cuda.launches == before + 1
    assert y.shape == (B, T, D) and y.dtype == dtype
    assert h_last.shape == (B, D) and h_last.dtype == torch.float32
    (size, launch) = launches
    assert size == ("size", B, T, D)
    # B, T, D, dtype codes, stream; h0 null when not given.
    assert launch[8:] == (B, T, D, trglru.KERNEL_DTYPES[dtype],
                          trglru.KERNEL_DTYPES[lam_dtype], 7)
    assert (launch[4] is None) == (args[4] is None)
