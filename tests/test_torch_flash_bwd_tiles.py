"""B5-bwd's arithmetic in the order of its kernels, on the CPU.

The kernels of `csrc/flash_tc_bwd.cu` cannot run here, so their arithmetic
is emulated in plain PyTorch at their tile order and rounding points:

  * key tiles of 128 keys at D 16, 64, 80 and 128 (`BwdTile::BK`), 64 at
    D 256 (`SplitTile::BK`, where the kernel's two warpgroups split dK and
    dV); for each, the G query heads of its group and, for each head, the
    64-query tiles that meet the band [k_lo, k_hi + W - 1];
  * S and dP summed in f32 from the bf16 inputs, P = exp2(s * sl2 - lse *
    log2(e)) with masked pairs 0, delta = rowsum(dO * O) from the bf16
    output the forward returned, dS = P (dP - delta) in f32;
  * P and dS rounded to bf16 before each product; dV and dK summed in f32
    over the group and its query tiles; dQ summed in f32 into an f32
    scratch one partial at a time: below D 128 each consumer warpgroup's
    own 64 keys (two partials a 128-key tile), at D 128 the whole tile, at
    D 256 its 64 keys; dq, dk, dv each rounded to bf16 once. The products
    run at the true D (16 and 80 are staged at 64 and 128 columns, the
    padding zero, and no product reads it).

The emulation is held, with the card check's tolerance (each of dq, dk, dv
within 2^-6 x max |reference| and relative L2 2^-7; at W = 1 dq and dk,
exactly 0 there, within 2^-6 x max |dv|), against `torch.autograd` of the
naive masked attention in f64 on the same bf16 inputs, and against
`flash_attention_bwd_plain`, the version the card check compares with. So
the tolerance holds for this order before the card runs it. Inputs come
from a numpy seed, over D {16, 64, 80, 128, 256} x W {full, 1, 40} x G {1,
2, 8} at ragged T (not a multiple of 64). The forward's lse comes from
`flash_tc.cu` on the card; here from the plain forward.

A last test reads what the wrapper hands the C entry point: eleven
pointers, the padded per-row vectors and the f32 dq scratch."""

import contextlib
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.local_attention import local_attention as la
from torch_parity import fake_cuda

LOG2E = 1.4426950408889634
MAX_TOL = 2 ** -6
L2_TOL = 2 ** -7
BQ = 64
#: Keys per block of the kernels, by head size.
KEY_TILE = {16: 128, 64: 128, 80: 128, 128: 128, 256: 64}
#: Keys of one dQ partial: a consumer warpgroup's own 64 below D 128.
DQ_KEYS = {16: 64, 64: 64, 80: 64, 128: 128, 256: 64}
CASES = [(D, W, G) for D in (64, 128, 256, 16, 80) for W in (None, 1, 40)
         for G in (1, 2, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_bwd_tiles(q, k, v, out, lse, dout, window=None):
    """(dq, dk, dv) in bf16 as B5-bwd's kernels compute them (module
    docstring): bf16 q, k, v, out, dout, f32 lse (B, Hq, T)."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    W = T if window is None else min(int(window), T)
    bk = KEY_TILE[D]
    sl2 = torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qf, dof = (x.float().reshape(B, Hkv, G, T, D) for x in (q, dout))
    kf, vf = k.float(), v.float()
    lse2 = (lse.float() * torch.tensor(LOG2E, dtype=torch.float32)) \
        .reshape(B, Hkv, G, T)
    delta = (dof * out.float().reshape(B, Hkv, G, T, D)).sum(-1)
    dq_acc = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k_lo in range(0, T if W > 0 else 0, bk):
        k_hi = min(k_lo + bk, T)
        kt, vt = kf[:, :, k_lo:k_hi], vf[:, :, k_lo:k_hi]
        kpos = torch.arange(k_lo, k_hi)
        q_last = min(k_lo + bk - 1 + W - 1, T - 1)
        for g in range(G):
            for q0 in range(k_lo // BQ * BQ, q_last + 1, BQ):
                q1 = min(q0 + BQ, T)
                qt, dot = qf[:, :, g, q0:q1], dof[:, :, g, q0:q1]
                qpos = torch.arange(q0, q1)[:, None]
                live = (kpos <= qpos) & (kpos > qpos - W)
                s = qt @ kt.transpose(-1, -2)
                p = torch.exp2(s * sl2 - lse2[:, :, g, q0:q1, None])
                p = torch.where(live, p, 0.0)
                dp = dot @ vt.transpose(-1, -2)
                ds = p * (dp - delta[:, :, g, q0:q1, None])
                pb, dsb = _bf16(p), _bf16(ds)
                dv[:, :, k_lo:k_hi] += pb.transpose(-1, -2) @ dot
                dk[:, :, k_lo:k_hi] += dsb.transpose(-1, -2) @ qt
                for h in range(0, k_hi - k_lo, DQ_KEYS[D]):
                    dq_acc[:, :, g, q0:q1] += dsb[..., h:h + DQ_KEYS[D]] \
                        @ kt[:, :, h:h + DQ_KEYS[D]]
    return ((dq_acc * scale).reshape(B, Hq, T, D).to(torch.bfloat16),
            (dk * scale).to(torch.bfloat16), dv.to(torch.bfloat16))


def _inputs(seed, B, Hq, Hkv, T, D):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, h, T, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for h in (Hq, Hkv, Hkv, Hq)]


def _naive_grads_f64(q, k, v, dout, W):
    """torch.autograd of the naive masked attention in f64 (masked
    probabilities 0) on the bf16 inputs."""
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    B, Hq, T, D = q.shape
    G = Hq // k.shape[1]
    kk, vv = (x.repeat_interleave(G, dim=1) for x in (k, v))
    s = q @ kk.transpose(-1, -2) / math.sqrt(D)
    pos = torch.arange(T)
    W = T if W is None else W
    live = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    p = torch.softmax(torch.where(live, s, -1e300), dim=-1)
    out = torch.where(live, p, 0.0) @ vv
    return torch.autograd.grad(out, (q, k, v), dout.double())


def _check(got, want, W):
    """The card check's rule (chip_smoke.py `bwd_errs`)."""
    dv_peak = float(want[2].abs().max())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.double(), w.double()
        if W == 1 and name != "dv":
            assert float(g.abs().max()) <= MAX_TOL * dv_peak, name
            continue
        err = float((g - w).abs().max())
        assert err <= MAX_TOL * float(w.abs().max()), (name, err)
        rel = float((g - w).norm() / w.norm())
        assert rel <= L2_TOL, (name, rel)


@pytest.mark.parametrize("D,W,G", CASES)
def test_tile_order_holds_the_card_tolerance(D, W, G):
    T = (200, 331, 147)[CASES.index((D, W, G)) % 3]
    Hkv = 2 if G < 8 else 1
    q, k, v, dout = _inputs(1000 + D + G + (W or 0), 1, Hkv * G, Hkv, T, D)
    out, lse = la.flash_attention_plain(q, k, v, window=W, block_q=T,
                                        block_k=T, return_lse=True)
    got = emulate_bwd_tiles(q, k, v, out, lse, dout, W)
    _check(got, _naive_grads_f64(q, k, v, dout, W), W)
    _check(got, la.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                             window=W), W)


@pytest.mark.parametrize("D", [16, 64, 80, 128, 256])
def test_wrapper_hands_the_entry_point_its_scratch(monkeypatch, D):
    """One launch a call; rowvec (2, B*Hq, T padded to 64) f32; dq_acc
    (B, Hq, T, D) f32."""
    seen = []
    monkeypatch.setattr(la, "_lib", lambda lib, fn, n_int, n_ptr=4: (
        lib, fn, n_int, n_ptr))
    monkeypatch.setattr(la, "_call", lambda fn, ptrs, ints, what: seen.append(
        (fn, ptrs, ints)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    B, Hq, Hkv, T = 2, 4, 2, 70
    q, k, v, dout = (fake_cuda(x) for x in _inputs(5, B, Hq, Hkv, T, D))
    out = fake_cuda(torch.zeros_like(q))
    lse = fake_cuda(torch.zeros(B, Hq, T))
    before = la.flash_attention_bwd_tc_cuda.launches
    dq, dk, dv = la.flash_attention_bwd_tc_cuda(q, k, v, out, lse, dout,
                                                window=33)
    assert la.flash_attention_bwd_tc_cuda.launches == before + 1
    (lib, fn, n_int, n_ptr), ptrs, ints = seen[0]
    assert (lib, fn, n_int, n_ptr) == ("flash_tc_bwd",
                                      "flash_attention_bwd_tc_launch", 6, 11)
    assert len(ptrs) == n_ptr and len(ints) == n_int
    assert ints == (B, Hq, Hkv, T, D, 33)
    rowvec, dq_acc = ptrs[9], ptrs[10]
    assert rowvec.shape == (2, B * Hq, 128) and rowvec.dtype == torch.float32
    assert dq_acc.shape == (B, Hq, T, D) and dq_acc.dtype == torch.float32
    assert ptrs[6] is dq and ptrs[7] is dk and ptrs[8] is dv
