"""Banded (sliding-window) flash attention: the CUDA kernel's wrapper and
the plain PyTorch version of the same blocked pass.

A causal sliding window of width W is the band RAPIDx puts around the DP
diagonal; the online-softmax state (running max, normaliser, f32
accumulator) is the wavefront state that never leaves fast memory. One
function serves both arms: W >= T (or None) is full causal attention,
W < T the sliding window (gemma3's local layers, mixtral's SWA).

`flash_attention_cuda` launches one of two kernels that replace the TPU
kernel `_flash_kernel` of the JAX package's
`kernels/local_attention/local_attention.py`, chosen by `kernel_route`
from (dtype, head size): `csrc/flash_tc.cu` (bf16 at D 64/128/256 on the
tensor cores: wgmma, TMA, an exact bf16 hi/lo split of the
probabilities) and `csrc/flash_tf32x3.cu` (f32 at every head size of the
registry and bf16 at D 16/80, on the tensor cores: mma.sync with every
operand split into tf32 hi + lo). A third kernel, `csrc/local_attention.cu`
(f32 FMA, every dtype and head size), is on no route; it stays callable
as `flash_attention_fma_cuda` and is timed beside the others. Each design
note is at the top of its source.
`flash_attention_plain` is the TPU kernel's pass written in PyTorch — its
grid's sequential kv axis becomes a loop over the kv block offsets,
vectorised over every (batch, head, query block) — and runs on any
device; `ops.flash_attention` picks between it and the kernels by where
the tensors live.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: Head sizes the FMA kernel is built for (every head_dim of the registry).
KERNEL_HEAD_DIMS = (16, 64, 80, 128, 256)

#: Input dtypes the FMA kernel takes; it computes in f32 and writes q's
#: dtype.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Head sizes the wgmma kernel takes, bf16 only.
TC_HEAD_DIMS = (64, 128, 256)

#: Head sizes the split-TF32 kernel takes in bf16 (in f32: every size of
#: `KERNEL_HEAD_DIMS`).
TF32X3_BF16_HEAD_DIMS = (16, 80)

_P, _I = ctypes.c_void_p, ctypes.c_int


def check_inputs(q, k, v, *, window=None, block_q=128, block_k=128):
    """Validate shapes as the reference wrapper does (`local_attention.py`
    lines 100-108). Returns (group, block_q, block_k, W) with the blocks
    clipped to T and W = T for a full causal pass."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, T, D); got q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}")
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, T, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Hkv, T, D) = (B, Hkv, {T}, "
                         f"{D}); got k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} not divisible by Hkv={Hkv}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    block_q = min(block_q, T)
    block_k = min(block_k, T)
    if block_q < 1 or block_k < 1 or T % block_q or T % block_k:
        raise ValueError(f"T={T} must divide block sizes {block_q},{block_k}")
    W = int(window) if window is not None else T
    return Hq // Hkv, block_q, block_k, W


def flash_attention_plain(q, k, v, *, window=None, block_q=128,
                          block_k=128):
    """The blocked online-softmax pass of the TPU kernel in PyTorch.

    For each kv block offset `ki` (the TPU grid's sequential axis), every
    query block attends to kv block ``last - (n_kv_blocks - 1) + ki``,
    where ``last`` holds the block's final query; blocks below 0 or wholly
    behind the window are masked whole, which leaves (m, l, acc) exactly
    as they were (alpha = 1, p = 0) — the kernel's skip. f32 math on the
    upcast inputs, q scaled after the upcast; output in q's dtype.
    """
    build.count(flash_attention_plain, "calls")
    group, bq, bk, W = check_inputs(q, k, v, window=window, block_q=block_q,
                                    block_k=block_k)
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    nq, nkb = T // bq, T // bk
    n_kv = min((bq - 1) // bk + -(-max(W - 1, 0) // bk) + 1, nkb)
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    # Rows of one (b, kv head, query block): the group's heads, g-major.
    qf = (q.float() * scale).reshape(B, Hkv, group, nq, bq, D) \
        .permute(0, 1, 3, 2, 4, 5).reshape(B, Hkv, nq, group * bq, D)
    kf = k.float().reshape(B, Hkv, nkb, bk, D)
    vf = v.float().reshape(B, Hkv, nkb, bk, D)

    qi = torch.arange(nq, device=dev)
    q_pos = (qi[:, None] * bq + torch.arange(bq, device=dev)).repeat(1, group)
    last_kv = (qi * bq + bq - 1) // bk
    m = torch.full((B, Hkv, nq, group * bq, 1), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, nq, group * bq, D), device=dev)
    for ki in range(n_kv):
        kv_blk = last_kv - (n_kv - 1) + ki
        below = (kv_blk * bk + bk - 1) < (qi * bq - W + 1)
        live = (kv_blk >= 0) & ~below                       # (nq,)
        idx = kv_blk.clamp(0, nkb - 1)
        k_pos = kv_blk[:, None] * bk + torch.arange(bk, device=dev)
        mask = ((k_pos[:, None, :] <= q_pos[:, :, None])
                & (k_pos[:, None, :] > q_pos[:, :, None] - W)
                & live[:, None, None])                      # (nq, rows, bk)
        s = qf @ kf[:, :, idx].transpose(-1, -2)            # (B,Hkv,nq,rows,bk)
        s = torch.where(mask, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.where(mask, torch.exp(s - m_cur), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vf[:, :, idx]
        m = m_cur
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).reshape(B, Hkv, nq, group, bq, D) \
        .permute(0, 1, 3, 2, 4, 5).reshape(B, Hq, T, D)
    return out.to(q.dtype)


#: Calls of the plain version since the count was last set to 0.
flash_attention_plain.calls = 0


def _lib(name, fn_name, n_int):
    lib = build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * n_int + [_P]
        fn.restype = _I
    return fn


def kernel_route(dtype, D):
    """Which kernel takes (dtype, D) on a CUDA tensor: "tc" (the wgmma
    kernel, `csrc/flash_tc.cu`) for bf16 at `TC_HEAD_DIMS`, "tf32x3"
    (`csrc/flash_tf32x3.cu`) for f32 and bf16 at the other head sizes of
    `KERNEL_HEAD_DIMS`. Raises ValueError for what neither takes."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"kernel takes q, k, v all of one dtype in "
                         f"{list(KERNEL_DTYPES)}; got {dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head size D={D} not built; the kernels take "
                         f"{KERNEL_HEAD_DIMS}")
    return "tc" if dtype == torch.bfloat16 and D in TC_HEAD_DIMS \
        else "tf32x3"


def _prepare(q, k, v, window, dtypes, head_dims, name):
    """Shared checks of both kernel wrappers. Returns (q, k, v) contiguous
    on 16-byte boundaries, W clipped to [0, T], and the sizes."""
    _, _, _, W = check_inputs(q, k, v, window=window, block_q=q.shape[2],
                              block_k=q.shape[2])
    B, Hq, T, D = q.shape
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes q, k, v all of one dtype in "
                         f"{list(dtypes)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D not in head_dims:
        raise ValueError(f"head size D={D} not built; {name} takes "
                         f"{head_dims}")
    if B * Hq > 65535 or T > 2 ** 30:
        raise ValueError(f"B*Hq={B * Hq} > 65535 or T={T} too long for one "
                         f"launch")
    if not q.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors; the plain version "
                         f"flash_attention_plain runs anywhere")
    build.refuse_grad(name, q, k, v)
    # Contiguous rows on 16-byte boundaries: the kernels load 16 bytes of
    # a row at a time (TMA requires it of its base address).
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    return q, k, v, max(min(W, T), 0), (B, Hq, k.shape[1], T, D)


def _launch(fn, q, k, v, sizes, W, extra, what):
    out = torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), *sizes, W, *extra, stream)
        if err != 0:
            raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                               f"{err}")
    return out


def flash_attention_tc_cuda(q, k, v, *, window=None):
    """Launch the tensor-core kernel (`csrc/flash_tc.cu`: wgmma, TMA,
    exact-split P.V) on CUDA tensors: bf16 q (B, Hq, T, D), k/v (B, Hkv,
    T, D), D in `TC_HEAD_DIMS`, any T up to 65,535 query tiles of 128.
    Returns (B, Hq, T, D) bf16 on PyTorch's current stream, without
    synchronising. Raises on anything the kernel does not take."""
    q, k, v, W, sizes = _prepare(q, k, v, window, (torch.bfloat16,),
                                 TC_HEAD_DIMS, "flash_attention_tc_cuda")
    if sizes[3] > 65535 * 128:
        raise ValueError(f"T={sizes[3]} > 65,535 query tiles of 128")
    out = _launch(_lib("flash_tc", "flash_attention_tc_launch", 6), q, k, v,
                  sizes, W, (), "flash_tc")
    if q.numel():
        build.count(flash_attention_tc_cuda)
    return out


def flash_attention_tf32x3_cuda(q, k, v, *, window=None):
    """Launch the split-TF32 kernel (`csrc/flash_tf32x3.cu`: mma.sync,
    each operand as tf32 hi + lo, three passes per product; two for bf16,
    whose k and v are exact in tf32) on CUDA tensors: q (B, Hq, T, D),
    k/v (B, Hkv, T, D), f32 at D in `KERNEL_HEAD_DIMS` or bf16 at D in
    `TF32X3_BF16_HEAD_DIMS`, any T >= 1. Returns (B, Hq, T, D) in q's dtype on PyTorch's current
    stream, without synchronising. Raises on anything the kernel does not
    take."""
    head_dims = TF32X3_BF16_HEAD_DIMS if q.dtype == torch.bfloat16 \
        else KERNEL_HEAD_DIMS
    q, k, v, W, sizes = _prepare(q, k, v, window, KERNEL_DTYPES, head_dims,
                                 "flash_attention_tf32x3_cuda")
    out = _launch(_lib("flash_tf32x3", "flash_attention_tf32x3_launch", 7),
                  q, k, v, sizes, W, (KERNEL_DTYPES[q.dtype],),
                  "flash_tf32x3")
    if q.numel():
        build.count(flash_attention_tf32x3_cuda)
    return out


def flash_attention_fma_cuda(q, k, v, *, window=None):
    """Launch the f32-FMA kernel (`csrc/local_attention.cu`) on CUDA
    tensors: q (B, Hq, T, D), k/v (B, Hkv, T, D), one dtype of
    `KERNEL_DTYPES`, D in `KERNEL_HEAD_DIMS`, any T >= 1. Returns
    (B, Hq, T, D) in q's dtype on PyTorch's current stream, without
    synchronising. Raises on anything the kernel does not take. No route
    leads here any more: `flash_attention_tf32x3_cuda` computes the same
    function on the tensor cores."""
    q, k, v, W, sizes = _prepare(q, k, v, window, KERNEL_DTYPES,
                                 KERNEL_HEAD_DIMS,
                                 "flash_attention_fma_cuda")
    out = _launch(_lib("local_attention", "flash_attention_launch", 7), q,
                  k, v, sizes, W, (KERNEL_DTYPES[q.dtype],), "local_attention")
    if q.numel():
        build.count(flash_attention_fma_cuda)
    return out


def flash_attention_cuda(q, k, v, *, window=None):
    """The banded flash attention on CUDA tensors, by `kernel_route`:
    bf16 at D in `TC_HEAD_DIMS` launches `flash_attention_tc_cuda`, the
    rest of `KERNEL_DTYPES` x `KERNEL_HEAD_DIMS`
    `flash_attention_tf32x3_cuda`. Returns (B, Hq, T, D) in q's dtype;
    raises on anything neither kernel takes (a CPU tensor included)."""
    route = kernel_route(q.dtype, q.shape[-1])
    kernel = flash_attention_tc_cuda if route == "tc" \
        else flash_attention_tf32x3_cuda
    before = kernel.launches
    out = kernel(q, k, v, window=window)
    flash_attention_cuda.launches += kernel.launches - before
    return out


#: Kernel launches since the count was last set to 0.
flash_attention_tc_cuda.launches = 0
flash_attention_tf32x3_cuda.launches = 0
flash_attention_fma_cuda.launches = 0
#: Launches of either kernel made through the route.
flash_attention_cuda.launches = 0
