"""The arithmetic of the tensor-core flash kernel (`csrc/flash_tc.cu`) on
the CPU, and the route that picks a kernel for a CUDA tensor.

The kernel cannot run here, so its rounding is emulated in the test:
bf16 operands, f32 scores (bf16 products are exact in f32) scaled by
log2(e)/sqrt(D) inside exp2 after the product, an online softmax over
key tiles of 128 (64 at D > 128) taken from the diagonal down, p split
into bf16 hi + lo and P.V taken as the two products, l summed from the
f32 p, O / l rounded to bf16. It must agree with `flash_attention_plain`
within the check the card holds the kernel to: one bf16 ulp of the plain
value, floor 2e-5. The same pass with one bf16 P is held beside it: its
error is larger and breaks that check — the reason for the split. Inputs
are made with numpy from a seed. D 16 and 80 (stablelm-3b's), which the
kernel stages as whole 64-column chunks, are emulated at their true D
(the zero columns add nothing) and held to the same check, and D 80
against the JAX package's Pallas kernel in interpret mode. The last
tests read what the wrapper hands the C entry point (recorders in place
of the library, inputs that say they live on a card)."""

import contextlib
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_attention import flash_attention as jax_flash
from repro_torch.kernels.local_attention import flash_attention
from repro_torch.kernels.local_attention import local_attention as la
from repro_torch.kernels.local_attention.local_attention import (
    flash_attention_cuda, flash_attention_fma_cuda, flash_attention_plain,
    flash_attention_tc_cuda, kernel_route)
from torch_parity import fake_cuda

# The shapes of tests/test_torch_flash.py's ATT_CASES (B, Hq, Hkv, T, D,
# window), taken in bf16, and a GQA-2 case at the main path's D = 128.
SHAPES = [
    (2, 4, 2, 256, 64, None),
    (1, 4, 4, 256, 64, 64),
    (2, 8, 2, 512, 32, 100),
    (1, 2, 1, 128, 128, 32),
    (1, 2, 2, 256, 64, 17),
    (1, 1, 1, 512, 64, 512),
    (2, 4, 2, 256, 64, 64),
    (1, 4, 2, 384, 128, None),
    (1, 4, 2, 384, 128, 64),
]
#: The head sizes staged as whole chunks: stablelm-3b's MHA causal pass at
#: D 80, GQA with W 40 at a ragged T, D 16 with W 17 and causal.
NARROW_SHAPES = [
    (1, 4, 4, 256, 80, None),
    (2, 8, 2, 300, 80, 40),
    (1, 4, 2, 200, 16, 17),
    (1, 2, 2, 384, 16, None),
]
LOG2E = 1.4426950408889634


def _inputs(seed, B, Hq, Hkv, T, D):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16() for s in ((B, Hq, T, D), (B, Hkv, T, D),
                                  (B, Hkv, T, D))]


def emulate_tc(q, k, v, window=None, split=True):
    """The kernel's rounding, one query tile of 128 rows at a time."""
    B, Hq, T, D = q.shape
    group = Hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    BK = 64 if D > 128 else 128
    W = T if window is None else window
    sl2 = torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32).double()
    out = torch.empty(B, Hq, T, D)
    for q_lo in range(0, T, 128):
        rows = torch.arange(q_lo, min(q_lo + 128, T))
        q_hi = int(rows[-1])
        m = torch.full((B, Hq, len(rows), 1), -math.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hq, len(rows), D)
        for kt in range(q_hi // BK, max(q_lo - W + 1, 0) // BK - 1, -1):
            keys = torch.arange(kt * BK, min(kt * BK + BK, T))
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            live = (keys <= rows[:, None]) & (keys > rows[:, None] - W)
            s = torch.where(live, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2.float())
            shift = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - shift)
            # fmaf(s, sl2, -shift): one rounding of the exact value.
            p = torch.exp2((s.double() * sl2 - shift.double()).float())
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha
            hi = p.bfloat16().float()
            acc = acc + hi @ vf[:, :, keys]
            if split:
                acc = acc + (p - hi).bfloat16().float() @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = acc / torch.where(l == 0.0, 1.0, l)
    return out.bfloat16()


def card_check(out, ref):
    """chip_smoke.py's bf16 check: (worst |out - ref| in units of its
    tolerance — one bf16 ulp of ref, or 2e-5 where that is larger — and
    the number of elements beyond it)."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.clamp_min(1e-30))) - 7)
    ratio = d / ulp.clamp_min(2e-5)
    return float(ratio.max()), int((ratio > 1).sum())


def _plain(q, k, v, W):
    T = q.shape[2]
    blk = 128 if T % 128 == 0 else T
    return flash_attention_plain(q, k, v, window=W, block_q=blk, block_k=blk)


@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"s{i}" for i in range(len(SHAPES))])
def test_split_emulation_within_the_card_check(shape):
    B, Hq, Hkv, T, D, W = shape
    q, k, v = _inputs(17 + T + D + (W or 0), B, Hq, Hkv, T, D)
    ref = _plain(q, k, v, W)
    worst, bad = card_check(emulate_tc(q, k, v, W), ref)
    assert bad == 0, (shape, worst)


@pytest.mark.parametrize("shape", NARROW_SHAPES,
                         ids=["d80_mha_causal", "d80_gqa_w40_ragged",
                              "d16_w17_ragged", "d16_causal"])
def test_narrow_head_sizes_within_the_card_check(shape):
    B, Hq, Hkv, T, D, W = shape
    q, k, v = _inputs(31 + T + D + (W or 0), B, Hq, Hkv, T, D)
    ref = _plain(q, k, v, W)
    worst, bad = card_check(emulate_tc(q, k, v, W), ref)
    assert bad == 0, (shape, worst)


def test_d80_emulation_matches_the_jax_kernel():
    """stablelm-3b's head size against the JAX package's Pallas kernel in
    interpret mode, within the reference's bf16 tolerance (atol = rtol =
    2e-2, its kernel test's), on the same bf16 inputs."""
    q, k, v = _inputs(41, 1, 4, 2, 256, 80)
    want = jax_flash(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v)), block_q=128, block_k=128)
    got = emulate_tc(q, k, v)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("shape", SHAPES[-2:], ids=["causal", "w64"])
def test_single_bf16_p_breaks_the_card_check(shape):
    """One bf16 P errs by up to 2^-9 sum(p|v|)/l: beyond one ulp where the
    output is small. The split stays inside; record both."""
    B, Hq, Hkv, T, D, W = shape
    q, k, v = _inputs(17 + T + D + (W or 0), B, Hq, Hkv, T, D)
    ref = _plain(q, k, v, W)
    split_worst, split_bad = card_check(emulate_tc(q, k, v, W), ref)
    one_worst, one_bad = card_check(emulate_tc(q, k, v, W, split=False),
                                    ref)
    print(f"worst error / tolerance: split {split_worst:.3g}, one bf16 P "
          f"{one_worst:.3g} ({one_bad} of {ref.numel()} elements beyond)")
    assert split_bad == 0 and split_worst <= 1
    assert one_bad > 0 and one_worst > 2, one_worst


def test_emulation_ragged_t_and_empty_window():
    """T not a multiple of the tiles, and W = 0 (every key masked: the
    normaliser stays 0 and the output is 0, as in the reference)."""
    q, k, v = _inputs(5, 1, 2, 1, 200, 128)
    ref = _plain(q, k, v, None)
    assert card_check(emulate_tc(q, k, v), ref)[1] == 0
    assert torch.equal(emulate_tc(q, k, v, 0), _plain(q, k, v, 0))
    assert not emulate_tc(q, k, v, 0).float().abs().max()


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 256, "tc"), (torch.bfloat16, 16, "tc"),
    (torch.bfloat16, 80, "tc"), (torch.float32, 128, "tf32x3"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 256, "tf32x3"),
    (torch.float32, 16, "tf32x3"), (torch.float32, 80, "tf32x3"),
])
def test_kernel_route(dtype, D, want):
    assert kernel_route(dtype, D) == want


@pytest.mark.parametrize("dtype,D,match", [
    (torch.float16, 128, "dtype"), (torch.float64, 64, "dtype"),
    (torch.float32, 32, "head size"), (torch.bfloat16, 96, "head size"),
])
def test_kernel_route_raises_for_what_no_kernel_takes(dtype, D, match):
    with pytest.raises(ValueError, match=match):
        kernel_route(dtype, D)
    x = torch.zeros(1, 2, 64, D, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(x, x, x)


def test_tc_wrapper_refuses_what_it_does_not_take():
    bf = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)
    before = (flash_attention_tc_cuda.launches,
              flash_attention_fma_cuda.launches, flash_attention_cuda.launches)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_tc_cuda(bf.float(), bf.float(), bf.float())
    with pytest.raises(ValueError, match="head size"):
        x = torch.zeros(1, 2, 64, 96, dtype=torch.bfloat16)
        flash_attention_tc_cuda(x, x, x)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_tc_cuda(bf, bf, bf.float())
    for fn in (flash_attention_tc_cuda, flash_attention_fma_cuda,
               flash_attention_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(bf, bf, bf)                  # a CPU tensor: no fallback
    assert (flash_attention_tc_cuda.launches,
            flash_attention_fma_cuda.launches,
            flash_attention_cuda.launches) == before


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _inputs(3, 1, 4, 2, 256, 128)
    calls = flash_attention_plain.calls
    out = flash_attention(q, k, v, window=64)
    assert flash_attention_plain.calls == calls + 1
    assert torch.equal(out, flash_attention_plain(q, k, v, window=64))


@pytest.fixture
def entry_points(monkeypatch):
    """The kernel entry points replaced by recorders of (name, the pointer
    arguments as the tensors passed, the int arguments)."""
    calls = []

    def lib(lib_name, fn, n_int, n_ptr=4):
        def record(*args):
            calls.append((fn, args[:n_ptr], args[n_ptr:-1]))
            return 0
        return record

    # `_call` hands the C function data_ptr()s; keep the tensors instead.
    def call(fn, ptrs, ints, what):
        assert fn(*ptrs, *ints, 7) == 0

    monkeypatch.setattr(la, "_lib", lib)
    monkeypatch.setattr(la, "_call", call)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    return calls


@pytest.mark.parametrize("with_lse", [False, True], ids=["serving", "lse"])
@pytest.mark.parametrize("D", [16, 80])
def test_tc_wrapper_hands_the_entry_point_narrow_head_sizes(entry_points, D,
                                                            with_lse):
    """At D 16 and 80 `flash_attention_tc_cuda` launches
    `flash_attention_tc_launch` with (B, Hq, Hkv, T, D, W) at the true D:
    serving with a null lse, under autograd (through `FlashAttention`)
    with an f32 (B, Hq, T) lse."""
    B, Hq, Hkv, T, W = 2, 4, 2, 24, 9
    q = fake_cuda(torch.zeros(B, Hq, T, D, dtype=torch.bfloat16)
                  .requires_grad_(with_lse))
    k, v = (fake_cuda(torch.zeros(B, Hkv, T, D, dtype=torch.bfloat16))
            for _ in range(2))
    before = flash_attention_tc_cuda.launches
    out = flash_attention_tc_cuda(q, k, v, window=W)
    (name, ptrs, ints), = entry_points
    assert name == "flash_attention_tc_launch" and len(ptrs) == 5
    assert ints == (B, Hq, Hkv, T, D, W)
    assert ptrs[3].shape == q.shape and ptrs[3].dtype == torch.bfloat16
    lse = ptrs[4]
    if with_lse:
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        assert lse.shape == (B, Hq, T) and lse.dtype == torch.float32
    else:
        assert lse is None
    assert flash_attention_tc_cuda.launches == before + 1
