"""The arithmetic of the split-TF32 flash kernel (`csrc/flash_tf32x3.cu`) on
the CPU, and the route that picks a kernel for a CUDA tensor.

The kernel cannot run here, so its rounding is emulated in the test: f32
operands (q scaled by 1/sqrt(D) after the upcast) split into tf32 hi + lo
— hi rounded to nearest with ties away on the int32 view, as the kernel
does it, lo = x - hi rounded the same way — and every product taken as
the three passes
lo*hi + hi*lo + hi*hi in f32 (tf32 products are exact in f32); an online
softmax over key tiles of 32 (16 at D > 128) taken in the kernel's order,
from the band's first tile up; p split the same way for P.V; O / l. It
must agree with `flash_attention_plain` within the check the card holds
the kernel to: |err| <= 2e-5 + 2e-5 |plain| (the reference's own kernel
test bound). The same pass with one tf32 operand per product is held
beside it and breaks that check: the reason for the split. Inputs are
made with numpy from a seed. The kernel takes f32 only: bf16 goes to
`csrc/flash_tc.cu` at every head size, and the wrapper refuses it before
any launch."""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.local_attention import local_attention as la
from repro_torch.kernels.local_attention.local_attention import (
    KERNEL_HEAD_DIMS, flash_attention_cuda,
    flash_attention_fma_cuda, flash_attention_plain, flash_attention_tc_cuda,
    flash_attention_tf32x3_cuda, kernel_route)
from torch_parity import fake_cuda

# The f32 shapes of tests/test_torch_flash.py's ATT_CASES (B, Hq, Hkv, T,
# D, window) and a GQA-2 case at the main path's D = 128.
SHAPES = [
    (2, 4, 2, 256, 64, None),
    (1, 4, 4, 256, 64, 64),
    (2, 8, 2, 512, 32, 100),
    (1, 2, 1, 128, 128, 32),
    (1, 2, 2, 256, 64, 17),
    (1, 1, 1, 512, 64, 512),
    (1, 4, 2, 384, 128, None),
]
TOL = 2e-5


def _inputs(seed, B, Hq, Hkv, T, D):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Hq, T, D), (B, Hkv, T, D), (B, Hkv, T, D))]


def tf32_round(x):
    """x rounded to tf32 (10 mantissa bits) to nearest, ties away from
    zero: cvt.rna.tf32.f32, on the int32 view (sign-magnitude, so adding
    half an ulp of tf32 to the magnitude bits and clearing the 13 low bits
    rounds |x| half away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def product(a, b, passes):
    """a @ b as the kernel's tensor cores take it: three passes of the
    split, or one tf32 pass."""
    if passes == 1:
        return tf32_round(a) @ tf32_round(b)
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def emulate(q, k, v, window=None, passes=3):
    """The kernel's pass, one query tile of 64 rows at a time, with the
    kernel's three passes per product unless `passes` is 1."""
    B, Hq, T, D = q.shape
    BQ = 64
    group = Hq // k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    BK = 16 if D > 128 else 32
    W = T if window is None else window
    out = torch.empty(B, Hq, T, D)
    for q_lo in range(0, T, BQ):
        rows = torch.arange(q_lo, min(q_lo + BQ, T))
        q_hi = int(rows[-1])
        m = torch.full((B, Hq, len(rows), 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hq, len(rows), D)
        for kt in range(max(q_lo - W + 1, 0) // BK, q_hi // BK + 1):
            keys = torch.arange(kt * BK, min(kt * BK + BK, T))
            s = product(qf[:, :, rows], kf[:, :, keys].transpose(-1, -2),
                        passes)
            live = (keys <= rows[:, None]) & (keys > rows[:, None] - W)
            s = torch.where(live, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(live, torch.exp(s - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + product(p, vf[:, :, keys], passes)
            m = m_new
        out[:, :, rows] = acc / torch.where(l == 0.0, 1.0, l)
    return out


def card_check(out, ref):
    """chip_smoke.py's f32 check: (worst |out - ref| in units of its
    tolerance 2e-5 + 2e-5 |ref|, the number of elements beyond it)."""
    ratio = (out.float() - ref.float()).abs() / (TOL + TOL * ref.abs())
    return float(ratio.max()), int((ratio > 1).sum())


def _plain(q, k, v, W):
    T = q.shape[2]
    blk = 128 if T % 128 == 0 else T
    return flash_attention_plain(q, k, v, window=W, block_q=blk, block_k=blk)


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10                       # tf32 ulp at 1.0
    x = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                      1.0 + 3 * ulp / 4, 3.0e-3, -7.5])
    want = torch.tensor([1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp])
    got = tf32_round(x)
    assert torch.equal(got[:5], want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    hi, lo = split(x)
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"s{i}" for i in range(len(SHAPES))])
def test_split_emulation_within_the_card_check(shape):
    B, Hq, Hkv, T, D, W = shape
    q, k, v = _inputs(23 + T + D + (W or 0), B, Hq, Hkv, T, D)
    ref = _plain(q, k, v, W)
    worst, bad = card_check(emulate(q, k, v, W), ref)
    assert bad == 0, (shape, worst)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[-1]],
                         ids=["d64", "gqa2_d128"])
def test_one_tf32_pass_breaks_the_card_check(shape):
    """One tf32 pass errs by about 2^-11 of each product: scores off by
    ~1e-3, far beyond 2e-5. The split stays inside; record both."""
    B, Hq, Hkv, T, D, W = shape
    q, k, v = _inputs(23 + T + D + (W or 0), B, Hq, Hkv, T, D)
    ref = _plain(q, k, v, W)
    split_worst, split_bad = card_check(emulate(q, k, v, W), ref)
    one_worst, one_bad = card_check(emulate(q, k, v, W, passes=1), ref)
    print(f"worst error / tolerance: split {split_worst:.3g}, one tf32 "
          f"pass {one_worst:.3g} ({one_bad} of {ref.numel()} elements "
          f"beyond)")
    assert split_bad == 0 and split_worst <= 1
    assert one_bad > 0 and one_worst > 10, one_worst


def test_emulation_ragged_t_and_empty_window():
    """T not a multiple of the tiles, and W = 0 (every key masked: the
    normaliser stays 0 and the output is 0, as in the reference)."""
    q, k, v = _inputs(5, 1, 2, 1, 200, 128)
    ref = _plain(q, k, v, None)
    assert card_check(emulate(q, k, v), ref)[1] == 0
    assert torch.equal(emulate(q, k, v, 0), _plain(q, k, v, 0))
    assert not emulate(q, k, v, 0).abs().max()


@pytest.mark.parametrize("dtype,D", [
    (dt, D) for dt in (torch.float32, torch.bfloat16)
    for D in KERNEL_HEAD_DIMS])
def test_route_table_covers_every_built_case_once(dtype, D):
    """Each (dtype, D) the kernels are built for has one route, and the
    kernel it names takes that case: the wgmma kernel bf16 at every head
    size, the split-TF32 kernel f32 at every head size."""
    route = kernel_route(dtype, D)
    takes = {"tc": dtype == torch.bfloat16 and D in KERNEL_HEAD_DIMS,
             "tf32x3": dtype == torch.float32 and D in KERNEL_HEAD_DIMS}
    assert takes[route]
    assert sum(takes.values()) == 1, takes


def test_tf32x3_wrapper_refuses_what_it_does_not_take():
    f = torch.zeros(1, 2, 64, 128)
    before = (flash_attention_tf32x3_cuda.launches,
              flash_attention_tc_cuda.launches,
              flash_attention_fma_cuda.launches,
              flash_attention_cuda.launches)
    with pytest.raises(ValueError, match="dtype"):
        x = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)
        flash_attention_tf32x3_cuda(x, x, x)     # bf16 is the tc's
    with pytest.raises(ValueError, match="head size"):
        x = torch.zeros(1, 2, 64, 32)
        flash_attention_tf32x3_cuda(x, x, x)
    with pytest.raises(ValueError, match="dtype"):
        x = torch.zeros(1, 2, 64, 128, dtype=torch.float16)
        flash_attention_tf32x3_cuda(x, x, x)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_tf32x3_cuda(f, f, f.bfloat16())
    for fn in (flash_attention_tf32x3_cuda, flash_attention_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(f, f, f)                          # a CPU tensor: no fallback
    assert (flash_attention_tf32x3_cuda.launches,
            flash_attention_tc_cuda.launches,
            flash_attention_fma_cuda.launches,
            flash_attention_cuda.launches) == before


@pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)
def test_split_forward_refuses_bf16_before_any_launch(monkeypatch, D):
    """bf16 at every head size is `flash_tc.cu`'s: the split-TF32
    forward's wrapper raises on it, serving and under autograd (where it
    would otherwise reach `FlashAttention`, which routes bf16 to the
    wgmma kernel), and neither kernel library is reached."""
    reached = []
    monkeypatch.setattr(la, "_lib", lambda *a, **kw: reached.append(a))
    x = fake_cuda(torch.zeros(1, 2, 16, D, dtype=torch.bfloat16))
    before = (flash_attention_tf32x3_cuda.launches,
              flash_attention_tc_cuda.launches)
    for q in (x, fake_cuda(torch.zeros(1, 2, 16, D, dtype=torch.bfloat16)
                           .requires_grad_())):
        with pytest.raises(ValueError, match="one dtype in"):
            flash_attention_tf32x3_cuda(q, x, x)
    assert reached == []
    assert (flash_attention_tf32x3_cuda.launches,
            flash_attention_tc_cuda.launches) == before
