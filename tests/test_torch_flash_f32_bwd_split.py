"""The f32 attention backward's arithmetic (`csrc/flash_tf32x3_bwd.cu`,
its wgmma design) on the CPU.

The kernel cannot run here, so its arithmetic is held in two steps:

* `split3_plain`, the plain version of the split the kernels apply to
  every f32 operand: x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 -
  x2). Each piece holds at most 8 significant bits (its f32 pattern's low
  16 bits are 0), and x1 + x2 + x3 == x exactly for |x| >= 2^-110;
  below, where x3's last bits fall under bf16's smallest subnormal
  (2^-133), the sum is within 2^-134 of x. So everywhere within
  max(2^-24 |x|, 2^-134). Inputs: normal values over 60 binades, zeros
  of both signs, values near f32's and bf16's smallest, and the scale
  factor 1/sqrt(D) with its products.
* an emulation of the kernel's products in its tile order: 64-key tiles;
  for each, the G query heads of its group and their 32-query tiles that
  meet the band; every product formed from the six kept piece products
  a_i b_j (0-based i + j <= 2) of the operands' pieces, each exact in f32
  and summed in f32; P = exp2(s * sl2 - lse * log2(e)) with masked pairs
  0, dS = P (dP - delta) in f32 from the f32 output; each query tile's
  share of dV and dK summed in a fresh f32 tile and added to the running
  sum, dQ^T formed per (key tile, query tile) and added, times scale, to
  dq. It is held against `jax.grad` of the JAX package's
  `_chunked_attention` on the same numpy-seeded f32 inputs over D {16,
  64, 80, 128, 256} x W {full, 1, 40} x G {1, 2} at ragged T (not a
  multiple of 32 or 64), each of dq, dk, dv within 1e-5 x max |reference|
  (stated before the first run: a tenth of the card check's 1e-4; at W =
  1, where dq and dk are exactly 0, within 1e-5 x max |reference dv|). At
  D 256 the card runs the mma.sync kernel; the emulation holds the
  arithmetic there too.

A last test reads what the wrapper hands the C entry point at every head
size: eleven pointers, the padded per-row vectors, the pieces' scratch
(none at D 256), and which launch counter moves."""

import contextlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _chunked_attention as jax_chunked
from repro_torch.kernels.local_attention import local_attention as la
from torch_parity import fake_cuda

LOG2E = 1.4426950408889634
TOL = 1e-5
BK, BQ = 64, 32
#: The kept piece products (a_i, b_j), the small terms first.
PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
CASES = [(D, W, G) for D in (16, 64, 80, 128, 256) for W in (None, 1, 40)
         for G in (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split_values(kind):
    rng = np.random.default_rng(7)
    if kind == "normal":
        x = rng.standard_normal(4096) * 2.0 ** rng.uniform(-30, 30, 4096)
    elif kind == "zeros_and_tiny":
        x = np.concatenate([
            [0.0, -0.0, 2.0 ** -149, -(2.0 ** -149), 2.0 ** -133,
             2.0 ** -126, 2.0 ** -110, 2.0 ** -103, 1e-40, -3e-39],
            rng.standard_normal(1024) * 2.0 ** rng.uniform(-149, -90, 1024)])
    else:  # the scale factor 1/sqrt(D) and what it multiplies
        s = np.array([1.0 / math.sqrt(d) for d in (16, 64, 80, 128, 256)],
                     np.float32)
        q = rng.standard_normal(1024).astype(np.float32)
        x = np.concatenate([s, s * np.float32(LOG2E),
                            (q[:, None] * s[None, :]).ravel()])
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("kind", ["normal", "zeros_and_tiny", "scale"])
def test_split3_pieces_are_bf16_and_sum_to_x(kind):
    x = _split_values(kind)
    pieces = la.split3_plain(x)
    for p in pieces:
        assert p.dtype == torch.bfloat16
        bits = p.float().view(torch.int32)
        assert bool(((bits & 0xFFFF) == 0).all()), "not bf16-representable"
    x1, x2, x3 = (p.double() for p in pieces)
    xd = x.double()
    assert torch.equal(pieces[0], x.to(torch.bfloat16))
    err = (x1 + x2 + x3 - xd).abs()
    assert bool((err <= torch.clamp(2.0 ** -24 * xd.abs(),
                                    min=2.0 ** -134)).all())
    assert bool((err[xd.abs() >= 2.0 ** -110] == 0).all())
    assert bool((x2.abs() <= 2.0 ** -8 * xd.abs()).all())
    assert bool((x3.abs() <= 2.0 ** -16 * xd.abs()).all())


def _pieces(x):
    return [p.float() for p in la.split3_plain(x)]


def _product(a, b):
    """The six kept piece products of a @ b, each exact in f32, summed in
    f32 (a, b: lists of three f32 tensors holding bf16 pieces)."""
    out = None
    for i, j in PAIRS:
        t = a[i] @ b[j]
        out = t if out is None else out + t
    return out


def emulate_split_bwd(q, k, v, out, lse, dout, window=None):
    """(dq, dk, dv) in f32 as the wgmma design computes them (module
    docstring): f32 q, k, v, out, dout, f32 lse (B, Hq, T)."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    W = T if window is None else min(int(window), T)
    sl2 = torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qg, dog = (x.reshape(B, Hkv, G, T, D) for x in (q, dout))
    lse2 = (lse * torch.tensor(LOG2E, dtype=torch.float32)) \
        .reshape(B, Hkv, G, T)
    delta = (dog * out.reshape(B, Hkv, G, T, D)).sum(-1)
    qp, dop, kp, vp = (_pieces(x) for x in (qg, dog, k, v))
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for k_lo in range(0, T if W > 0 else 0, BK):
        k_hi = min(k_lo + BK, T)
        kt = [p[:, :, k_lo:k_hi] for p in kp]
        vt = [p[:, :, k_lo:k_hi] for p in vp]
        ktt = [p.transpose(-1, -2) for p in kt]
        kpos = torch.arange(k_lo, k_hi)[:, None]
        q_last = min(k_lo + BK - 1 + W - 1, T - 1)
        run_dk = torch.zeros_like(dk[:, :, k_lo:k_hi])
        run_dv = torch.zeros_like(run_dk)
        for g in range(G):
            for q0 in range(k_lo // BQ * BQ, q_last + 1, BQ):
                q1 = min(q0 + BQ, T)
                qt = [p[:, :, g, q0:q1] for p in qp]
                dot = [p[:, :, g, q0:q1] for p in dop]
                qpos = torch.arange(q0, q1)[None, :]
                live = (kpos <= qpos) & (kpos > qpos - W)
                st = _product(kt, [p.transpose(-1, -2) for p in qt])
                pt = torch.where(
                    live, torch.exp2(st * sl2 - lse2[:, :, g, None, q0:q1]),
                    0.0)
                dpt = _product(vt, [p.transpose(-1, -2) for p in dot])
                dst = pt * (dpt - delta[:, :, g, None, q0:q1])
                ptp, dstp = _pieces(pt), _pieces(dst)
                run_dv += _product(ptp, dot)
                run_dk += _product(dstp, qt)
                dq[:, :, g, q0:q1] += (_product(ktt, dstp) * scale) \
                    .transpose(-1, -2)
        dk[:, :, k_lo:k_hi] = run_dk * scale
        dv[:, :, k_lo:k_hi] = run_dv
    return dq.reshape(B, Hq, T, D), dk, dv


_jax_vjp = jax.jit(
    lambda q, k, v, dout, window, chunk: jax.vjp(
        lambda a, b, c: jax_chunked(a, b, c, window, chunk, chunk),
        q, k, v)[1](dout),
    static_argnums=(4, 5))


@pytest.mark.parametrize("D,W,G", CASES)
def test_emulated_products_match_jax_grad(D, W, G):
    T, chunk = ((80, 16), (100, 20), (144, 16))[CASES.index((D, W, G)) % 3]
    Hkv = 2
    rng = np.random.default_rng(2900 + D + 7 * G + (W or 0))
    q, k, v, dout = (rng.standard_normal((1, h, T, D)).astype(np.float32)
                     for h in (Hkv * G, Hkv, Hkv, Hkv * G))
    want = [np.asarray(x) for x in
            _jax_vjp(*(jnp.asarray(a) for a in (q, k, v, dout)), W, chunk)]
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = la.flash_attention_plain(qt, kt, vt, window=W, block_q=T,
                                        block_k=T, return_lse=True)
    got = emulate_split_bwd(qt, kt, vt, out, lse, dot, W)
    dv_peak = np.abs(want[2]).max()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        err = np.abs(a.numpy() - b).max()
        peak = dv_peak if W == 1 and name != "dv" else np.abs(b).max()
        assert err <= TOL * peak, (name, err, peak)


@pytest.mark.parametrize("D", [16, 64, 80, 128, 256])
def test_wrapper_hands_the_entry_point_its_scratch(monkeypatch, D):
    """Eleven pointers: q, k, v, out, lse, dout, dq, dk, dv, the per-row
    vectors (2, B*Hq, T padded to 64) f32 and the pieces' bf16 scratch
    (3 pieces of q, dO, k, v; none at D 256, the mma.sync kernel), then
    (B, Hq, Hkv, T, D, W); at D 256 `mma_sync_launches` moves, elsewhere
    `launches`."""
    calls = []

    def lib(lib_name, fn, n_int, n_ptr=4):
        def record(*args):
            calls.append((fn, args[:n_ptr], args[n_ptr:-1]))
            return 0
        return record

    def call(fn, ptrs, ints, what):
        assert fn(*ptrs, *ints, 7) == 0

    monkeypatch.setattr(la, "_lib", lib)
    monkeypatch.setattr(la, "_call", call)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    B, Hq, Hkv, T, W = 2, 4, 2, 70, 33
    q, out, dout = (fake_cuda(torch.zeros(B, Hq, T, D)) for _ in range(3))
    k, v = (fake_cuda(torch.zeros(B, Hkv, T, D)) for _ in range(2))
    lse = fake_cuda(torch.zeros(B, Hq, T))
    fn = la.flash_attention_bwd_tf32x3_cuda
    before = (fn.launches, fn.mma_sync_launches)
    dq, dk, dv = fn(q, k, v, out, lse, dout, window=W)
    (name, ptrs, ints), = calls
    assert name == "flash_attention_bwd_tf32x3_launch" and len(ptrs) == 11
    assert [p.shape for p in ptrs[6:9]] == [q.shape, k.shape, v.shape]
    assert all(p.dtype == torch.float32 for p in ptrs[6:9])
    assert ptrs[9].shape == (2, B * Hq, 128) \
        and ptrs[9].dtype == torch.float32
    if D == 256:
        assert ptrs[10] is None
        moved = (0, 1)
    else:
        assert ptrs[10].dtype == torch.bfloat16 \
            and ptrs[10].numel() == 3 * (2 * B * Hq + 2 * B * Hkv) * T * D
        moved = (1, 0)
    assert ints == (B, Hq, Hkv, T, D, W)
    assert (fn.launches - before[0], fn.mma_sync_launches - before[1]) \
        == moved
