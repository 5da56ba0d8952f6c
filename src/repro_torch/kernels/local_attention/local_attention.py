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
from the dtype, at every head size of the registry: `csrc/flash_tc.cu`
(bf16, on the tensor cores: wgmma, TMA, an exact bf16 hi/lo split of the
probabilities; D 16 and 80 staged as whole 64-column chunks, TMA
zero-filling past D) and `csrc/flash_tf32x3.cu` (f32, on the tensor
cores: mma.sync with every operand split into tf32 hi + lo). A third
kernel, `csrc/local_attention.cu`
(f32 FMA, every dtype and head size), is on no route; it stays callable
as `flash_attention_fma_cuda` and is timed beside the others. Each design
note is at the top of its source.
`flash_attention_plain` is the TPU kernel's pass written in PyTorch — its
grid's sequential kv axis becomes a loop over the kv block offsets,
vectorised over every (batch, head, query block) — and runs on any
device; `ops.flash_attention` picks between it and the kernels by where
the tensors live.

The backward: `FlashAttention`, a `torch.autograd.Function`, runs on CUDA
tensors the forward of the route `kernel_route` picks, with its per-row
log-sum-exp, and the backward kernel `bwd_route` picks, the same route:
B5-bwd (`csrc/flash_tc_bwd.cu`, `flash_attention_bwd_tc_cuda`: one wgmma
kernel per (b, kv head, key tile) that also reduces dQ into an f32
scratch) for bf16, and `csrc/flash_tf32x3_bwd.cu`
(`flash_attention_bwd_tf32x3_cuda`) for f32: at D 16-128 B5-bwd's
wgmma/TMA pipeline on bf16 tensor cores, every f32 operand split into
three bf16 pieces (`split3_plain`) and each product formed from six piece
products, dQ reduced into dq by TMA; at D 256 the mma.sync kernel with
split tf32 operands. On CPU tensors it runs
`flash_attention_plain(return_lse=True)` and `flash_attention_bwd_plain`.
`flash_attention_tc_cuda` and `flash_attention_tf32x3_cuda` go through it
whenever autograd would record the call; the FMA kernel, on no route, has
no backward and raises there (`build.refuse_grad`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: Head sizes every kernel is built for (every head_dim of the registry),
#: the wgmma kernels (`csrc/flash_tc.cu`, B5-bwd) included: they stage D 16
#: and 80 as whole 64-column chunks.
KERNEL_HEAD_DIMS = (16, 64, 80, 128, 256)

#: Input dtypes the FMA kernel takes; it computes in f32 and writes q's
#: dtype.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The one dtype each route's kernels take.
ROUTE_DTYPE = {"tc": torch.bfloat16, "tf32x3": torch.float32}

#: B5-bwd's and the f32 backward's per-row vectors (lse * log2(e), delta)
#: are padded to a multiple of this many rows (one of B5-bwd's streamed
#: query tiles, two of the f32 backward's).
BWD_ROW_PAD = 64

#: Head sizes at which the f32 backward runs its wgmma design; D 256 runs
#: the mma.sync kernel (the pieces of a 64-key tile's K and V would fill a
#: block's shared memory: `csrc/flash_tf32x3_bwd.cu`).
SPLIT_BWD_WGMMA_DIMS = (16, 64, 80, 128)

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


def _plain_dtype(q):
    """The plain versions compute in f32, or in f64 for f64 inputs (the
    gradient checks)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def flash_attention_plain(q, k, v, *, window=None, block_q=128,
                          block_k=128, return_lse=False):
    """The blocked online-softmax pass of the TPU kernel in PyTorch.

    For each kv block offset `ki` (the TPU grid's sequential axis), every
    query block attends to kv block ``last - (n_kv_blocks - 1) + ki``,
    where ``last`` holds the block's final query; blocks below 0 or wholly
    behind the window are masked whole, which leaves (m, l, acc) exactly
    as they were (alpha = 1, p = 0) — the kernel's skip. f32 math (f64 for
    f64 inputs) on the upcast inputs, q scaled after the upcast; output in
    q's dtype. With `return_lse`, also each row's log-sum-exp of the
    scaled scores, (B, Hq, T) in the compute dtype: m + log l, +inf where
    no key is live (l = 0, only at W = 0).
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
    ct = _plain_dtype(q)

    # Rows of one (b, kv head, query block): the group's heads, g-major.
    qf = (q.to(ct) * scale).reshape(B, Hkv, group, nq, bq, D) \
        .permute(0, 1, 3, 2, 4, 5).reshape(B, Hkv, nq, group * bq, D)
    kf = k.to(ct).reshape(B, Hkv, nkb, bk, D)
    vf = v.to(ct).reshape(B, Hkv, nkb, bk, D)

    qi = torch.arange(nq, device=dev)
    q_pos = (qi[:, None] * bq + torch.arange(bq, device=dev)).repeat(1, group)
    last_kv = (qi * bq + bq - 1) // bk
    m = torch.full((B, Hkv, nq, group * bq, 1), NEG_INF, dtype=ct,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, nq, group * bq, D), dtype=ct, device=dev)
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
    lse = torch.where(l == 0.0, math.inf, m + torch.log(l))
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).reshape(B, Hkv, nq, group, bq, D) \
        .permute(0, 1, 3, 2, 4, 5).reshape(B, Hq, T, D).to(q.dtype)
    if not return_lse:
        return out
    return out, lse.reshape(B, Hkv, nq, group, bq).permute(0, 1, 3, 2, 4) \
        .reshape(B, Hq, T)


#: Calls of the plain version since the count was last set to 0.
flash_attention_plain.calls = 0


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, window=None,
                              block_k=128):
    """The backward of the banded flash attention in PyTorch, with the
    recomputation of B5-bwd: for each block of `block_k` keys, the
    queries that meet its band ``[k_lo, k_hi + W - 1]``, P = exp(s *
    scale - lse) (0 where masked), dV = P^T dO, dP = dO V^T, dS = P (dP -
    delta) with delta = rowsum(dO * O) from `out` as the forward returned
    it, dQ = scale dS K and dK = scale dS^T Q, dK and dV summed over each
    kv head's group. `lse` (B, Hq, T) as `flash_attention_plain(...,
    return_lse=True)` or the tc kernel gives it. f32 math (f64 for f64
    inputs); returns (dq, dk, dv) in the dtypes of q, k, v. Any T."""
    build.count(flash_attention_bwd_plain, "calls")
    group, _, _, W = check_inputs(q, k, v, window=window, block_q=q.shape[2],
                                  block_k=q.shape[2])
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    ct = _plain_dtype(q)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = q.to(ct).reshape(B, Hkv, group, T, D)
    dof = dout.to(ct).reshape(B, Hkv, group, T, D)
    kf, vf = k.to(ct), v.to(ct)
    lsef = lse.to(ct).reshape(B, Hkv, group, T, 1)
    delta = (dof * out.to(ct).reshape(B, Hkv, group, T, D)).sum(
        -1, keepdim=True)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k_lo in range(0, T if W > 0 else 0, block_k):
        k_hi = min(k_lo + block_k, T)
        q_hi = min(k_hi - 1 + W - 1, T - 1) + 1
        qs, dos = qf[:, :, :, k_lo:q_hi], dof[:, :, :, k_lo:q_hi]
        kc, vc = kf[:, :, k_lo:k_hi], vf[:, :, k_lo:k_hi]
        qpos = torch.arange(k_lo, q_hi, device=dev)[:, None]
        kpos = torch.arange(k_lo, k_hi, device=dev)[None, :]
        live = (kpos <= qpos) & (kpos > qpos - W)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qs, kc) * scale
        p = torch.where(live, torch.exp(torch.where(
            live, s - lsef[:, :, :, k_lo:q_hi], 0.0)), 0.0)
        dv[:, :, k_lo:k_hi] = torch.einsum("bkgqc,bkgqd->bkcd", p, dos)
        dp = torch.einsum("bkgqd,bkcd->bkgqc", dos, vc)
        ds = p * (dp - delta[:, :, :, k_lo:q_hi])
        dk[:, :, k_lo:k_hi] = torch.einsum("bkgqc,bkgqd->bkcd", ds,
                                           qs) * scale
        dq[:, :, :, k_lo:q_hi] += torch.einsum("bkgqc,bkcd->bkgqd", ds,
                                               kc) * scale
    return (dq.reshape(B, Hq, T, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


#: Calls of the plain backward since the count was last set to 0.
flash_attention_bwd_plain.calls = 0


def _lib(name, fn_name, n_int, n_ptr=4):
    lib = build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
        fn.restype = _I
    return fn


def kernel_route(dtype, D):
    """Which kernel takes (dtype, D) on a CUDA tensor: "tc" (the wgmma
    kernel, `csrc/flash_tc.cu`) for bf16, "tf32x3" (`csrc/flash_tf32x3.cu`)
    for f32, at every head size of `KERNEL_HEAD_DIMS`. Raises ValueError
    for what neither takes."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"kernel takes q, k, v all of one dtype in "
                         f"{list(KERNEL_DTYPES)}; got {dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head size D={D} not built; the kernels take "
                         f"{KERNEL_HEAD_DIMS}")
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def bwd_route(dtype, D):
    """Which backward kernel takes (dtype, D) on a CUDA tensor: the
    forward's route, "tc" (B5-bwd, `csrc/flash_tc_bwd.cu`) for bf16 and
    "tf32x3" (`csrc/flash_tf32x3_bwd.cu`) for f32. Raises ValueError for
    what neither takes, as `kernel_route` does."""
    return kernel_route(dtype, D)


def _check_route(q, k, v, route, name):
    """Refuse, before anything launches, inputs that the kernels of
    `route` do not take: under autograd a wrapper goes through
    `FlashAttention`, which would pick the forward by `kernel_route`."""
    want = ROUTE_DTYPE[route]
    if q.dtype != want or k.dtype != want or v.dtype != want:
        raise ValueError(f"{name} takes q, k, v all of one dtype in "
                         f"{[want]}; got {q.dtype}, {k.dtype}, {v.dtype}")


def _contiguous(*ts):
    """Contiguous rows on 16-byte boundaries: the kernels load 16 bytes of
    a row at a time (TMA requires it of its base address)."""
    return tuple(t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in ts)


def _prepare(q, k, v, window, dtypes, head_dims, name):
    """Shared checks of the kernel wrappers. Returns (q, k, v) contiguous
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
    return (*_contiguous(q, k, v), max(min(W, T), 0),
            (B, Hq, k.shape[1], T, D))


def _call(fn, ptrs, ints, what):
    """One launch of a C entry point on the current stream of the device
    of `ptrs[0]`; raises on a CUDA error."""
    with torch.cuda.device(ptrs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() if t is not None else None for t in ptrs),
                 *ints, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _launch(fn, q, k, v, sizes, W, extra, what):
    out = torch.empty_like(q)
    if q.numel():
        _call(fn, (q, k, v, out), (*sizes, W, *extra), what)
    return out


def _tc_forward(q, k, v, window, with_lse):
    """One launch of `csrc/flash_tc.cu`: (out, lse or None)."""
    q, k, v, W, sizes = _prepare(q, k, v, window, (ROUTE_DTYPE["tc"],),
                                 KERNEL_HEAD_DIMS, "flash_attention_tc_cuda")
    if sizes[3] > 65535 * 128:
        raise ValueError(f"T={sizes[3]} > 65,535 query tiles of 128")
    out = torch.empty_like(q)
    lse = torch.empty(sizes[:2] + sizes[3:4], dtype=torch.float32,
                      device=q.device) if with_lse else None
    if q.numel():
        _call(_lib("flash_tc", "flash_attention_tc_launch", 6, n_ptr=5),
              (q, k, v, out, lse), (*sizes, W), "flash_tc")
        build.count(flash_attention_tc_cuda)
    return out, lse


def flash_attention_tc_cuda(q, k, v, *, window=None):
    """Launch the tensor-core kernel (`csrc/flash_tc.cu`: wgmma, TMA,
    exact-split P.V) on CUDA tensors: bf16 q (B, Hq, T, D), k/v (B, Hkv,
    T, D), D in `KERNEL_HEAD_DIMS`, any T up to 65,535 query tiles of 128.
    Returns (B, Hq, T, D) bf16 on PyTorch's current stream, without
    synchronising. Where autograd would record the call, it goes through
    `FlashAttention` (the forward with its log-sum-exp, B5-bwd behind it).
    Raises on anything the kernel does not take."""
    if build.records_grad(q, k, v):
        _check_route(q, k, v, "tc", "flash_attention_tc_cuda")
        return FlashAttention.apply(q, k, v, window)
    return _tc_forward(q, k, v, window, False)[0]


def _bwd_operands(name, q, out, lse, dout, sizes):
    """The backward wrappers' checks of the forward's output `out`, its
    gradient `dout` (both like q) and `lse` ((B, Hq, T) f32); returns the
    three contiguous on 16-byte boundaries."""
    B, Hq, _, T, _ = sizes
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"{name}: out and dout must be like q "
                         f"{tuple(q.shape)} {q.dtype}; got out "
                         f"{tuple(out.shape)} {out.dtype}, dout "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if lse.shape != (B, Hq, T) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be ({B}, {Hq}, {T}) float32; "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    if not (out.device == dout.device == lse.device == q.device):
        raise ValueError(f"{name}: out, lse and dout must lie on q's device")
    if T > 65535 * 64:
        raise ValueError(f"T={T} > 65,535 tiles of 64")
    return _contiguous(out, dout, lse)


def flash_attention_bwd_tc_cuda(q, k, v, out, lse, dout, *, window=None):
    """Launch B5-bwd (`csrc/flash_tc_bwd.cu`) on CUDA tensors: a pre-pass
    (delta = rowsum(dO * O) and lse * log2(e), per row padded to
    `BWD_ROW_PAD`; it also zeroes an f32 scratch `dq_acc`), one wgmma
    kernel per (b, kv head, 128-key tile; 64 at D 256) that sums dK, dV
    over the group and adds each tile's dQ into `dq_acc`, and a cast dq =
    bf16(scale * dq_acc). bf16 operands, f32 accumulation. bf16 q (B, Hq,
    T, D), k/v (B, Hkv, T, D), D in `KERNEL_HEAD_DIMS`, `out` the
    forward's output and `dout` its gradient (bf16, like q), `lse` (B, Hq,
    T) f32 from the forward kernel `flash_tc.cu`. Returns (dq, dk, dv)
    bf16 on PyTorch's current stream, without synchronising; dq's f32 sums
    come in an order that varies from call to call. Raises on anything the
    kernels do not take."""
    name = "flash_attention_bwd_tc_cuda"
    q, k, v, W, sizes = _prepare(q, k, v, window, (ROUTE_DTYPE["tc"],),
                                 KERNEL_HEAD_DIMS, name)
    B, Hq, Hkv, T, D = sizes
    out, dout, lse = _bwd_operands(name, q, out, lse, dout, sizes)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel():
        t_pad = -(-T // BWD_ROW_PAD) * BWD_ROW_PAD
        rowvec = torch.empty((2, B * Hq, t_pad), dtype=torch.float32,
                             device=q.device)
        dq_acc = torch.empty((B, Hq, T, D), dtype=torch.float32,
                             device=q.device)
        _call(_lib("flash_tc_bwd", "flash_attention_bwd_tc_launch", 6,
                   n_ptr=11),
              (q, k, v, out, lse, dout, dq, dk, dv, rowvec, dq_acc),
              (*sizes, W), "flash_tc_bwd")
        build.count(flash_attention_bwd_tc_cuda)
    return dq, dk, dv


def split_bwd_pieces_numel(B, Hq, Hkv, T, D):
    """Elements of the bf16 scratch `flash_attention_bwd_tf32x3_cuda`
    hands its wgmma design: the three pieces of q, dO (B, Hq, T, D) and of
    k, v (B, Hkv, T, D); 0 at a head size the mma.sync kernel takes."""
    if D not in SPLIT_BWD_WGMMA_DIMS:
        return 0
    return 3 * 2 * (B * Hq + B * Hkv) * T * D


def split3_plain(x):
    """The three bf16 pieces of an f32 tensor as the f32 backward's kernels
    form them: x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2),
    each rounded to nearest (even). The differences are exact in f32, and
    x3 is exact: x1 + x2 + x3 == x wherever x3 stays in bf16's range
    (|x| above about 2^-103)."""
    x1 = x.to(torch.bfloat16)
    r = x - x1.float()
    x2 = r.to(torch.bfloat16)
    return x1, x2, (r - x2.float()).to(torch.bfloat16)


def flash_attention_bwd_tf32x3_cuda(q, k, v, out, lse, dout, *,
                                    window=None):
    """Launch the f32 backward (`csrc/flash_tf32x3_bwd.cu`) on CUDA
    tensors. At D 16, 64, 80 and 128: a pre-pass (delta = rowsum(dO * O)
    and lse * log2(e), per row padded to `BWD_ROW_PAD`; dq, the TMA
    reductions' target, zeroed; the three bf16 pieces of q and dO, as
    `split3_plain` forms them), one for the pieces of k and v, and one
    wgmma kernel per (b, kv head, 64-key tile), fed by TMA, that forms
    every product from six piece products with f32 accumulation, sums dK
    and dV over the group and adds each query tile's dQ into dq by TMA
    reductions. At D 256 the mma.sync kernel (every operand split into
    tf32 hi + lo, dQ by f32 atomics), counted apart in
    ``mma_sync_launches``. f32 q (B, Hq, T, D), k/v (B, Hkv, T, D), D in
    `KERNEL_HEAD_DIMS`, `out` the forward's output and `dout` its gradient
    (like q), `lse` (B, Hq, T) f32 from `flash_tf32x3.cu`. Returns (dq, dk,
    dv) f32 on PyTorch's current stream, without synchronising; dq's f32
    sums come in an order that varies from call to call. Raises on
    anything the kernels do not take, bf16 included (its backward is
    `flash_attention_bwd_tc_cuda`)."""
    name = "flash_attention_bwd_tf32x3_cuda"
    q, k, v, W, sizes = _prepare(q, k, v, window, (ROUTE_DTYPE["tf32x3"],),
                                 KERNEL_HEAD_DIMS, name)
    B, Hq, Hkv, T, D = sizes
    out, dout, lse = _bwd_operands(name, q, out, lse, dout, sizes)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel():
        t_pad = -(-T // BWD_ROW_PAD) * BWD_ROW_PAD
        rowvec = torch.empty((2, B * Hq, t_pad), dtype=torch.float32,
                             device=q.device)
        n = split_bwd_pieces_numel(B, Hq, Hkv, T, D)
        pieces = torch.empty(n, dtype=torch.bfloat16, device=q.device) \
            if n else None
        _call(_lib("flash_tf32x3_bwd", "flash_attention_bwd_tf32x3_launch",
                   6, n_ptr=11),
              (q, k, v, out, lse, dout, dq, dk, dv, rowvec, pieces),
              (*sizes, W), "flash_tf32x3_bwd")
        build.count(flash_attention_bwd_tf32x3_cuda,
                    "launches" if n else "mma_sync_launches")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The banded flash attention with its backward: on CUDA tensors the
    forward of the route `kernel_route` picks with the per-row
    log-sum-exp and the backward of the route `bwd_route` picks
    (`flash_tc.cu` and B5-bwd for bf16, the split-TF32 forward and the
    f32 backward, `csrc/flash_tf32x3_bwd.cu`, for f32), on CPU tensors
    `flash_attention_plain(return_lse=True)` and
    `flash_attention_bwd_plain`. Everything the backward reads is saved
    through `ctx.save_for_backward` (q, k, v, out, lse), so a
    non-reentrant checkpoint may run the forward again. `apply(q, k, v,
    window=None, block_q=128, block_k=128)`; the blocks tile the plain
    forward only."""

    @staticmethod
    def forward(ctx, q, k, v, window=None, block_q=128, block_k=128):
        if q.is_cuda:
            forward = _tc_forward if kernel_route(
                q.dtype, q.shape[-1]) == "tc" else _tf32x3_forward
            out, lse = forward(q, k, v, window, True)
        else:
            out, lse = flash_attention_plain(q, k, v, window=window,
                                             block_q=block_q,
                                             block_k=block_k,
                                             return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if not q.is_cuda:
            bwd = flash_attention_bwd_plain
        elif bwd_route(q.dtype, q.shape[-1]) == "tc":
            bwd = flash_attention_bwd_tc_cuda
        else:
            bwd = flash_attention_bwd_tf32x3_cuda
        dq, dk, dv = bwd(q, k, v, out, lse, dout, window=ctx.window)
        return dq, dk, dv, None, None, None


def _tf32x3_forward(q, k, v, window, with_lse):
    """One launch of `csrc/flash_tf32x3.cu`: (out, lse or None)."""
    q, k, v, W, sizes = _prepare(q, k, v, window, (ROUTE_DTYPE["tf32x3"],),
                                 KERNEL_HEAD_DIMS,
                                 "flash_attention_tf32x3_cuda")
    out = torch.empty_like(q)
    lse = torch.empty(sizes[:2] + sizes[3:4], dtype=torch.float32,
                      device=q.device) if with_lse else None
    if q.numel():
        _call(_lib("flash_tf32x3", "flash_attention_tf32x3_launch", 6,
                   n_ptr=5),
              (q, k, v, out, lse), (*sizes, W), "flash_tf32x3")
        build.count(flash_attention_tf32x3_cuda)
    return out, lse


def flash_attention_tf32x3_cuda(q, k, v, *, window=None):
    """Launch the split-TF32 kernel (`csrc/flash_tf32x3.cu`: mma.sync,
    each operand as tf32 hi + lo, three passes per product) on CUDA
    tensors: f32 q (B, Hq, T, D), k/v (B, Hkv, T, D), D in
    `KERNEL_HEAD_DIMS`, any T >= 1. Returns (B, Hq, T, D) f32 on PyTorch's
    current stream, without synchronising. Where autograd would record the
    call, it goes through `FlashAttention` (the forward with its
    log-sum-exp, the split-TF32 backward behind it). Raises on anything
    the kernel does not take, bf16 included (its kernel is
    `flash_attention_tc_cuda`), before any launch."""
    if build.records_grad(q, k, v):
        _check_route(q, k, v, "tf32x3", "flash_attention_tf32x3_cuda")
        return FlashAttention.apply(q, k, v, window)
    return _tf32x3_forward(q, k, v, window, False)[0]


def flash_attention_fma_cuda(q, k, v, *, window=None):
    """Launch the f32-FMA kernel (`csrc/local_attention.cu`) on CUDA
    tensors: q (B, Hq, T, D), k/v (B, Hkv, T, D), one dtype of
    `KERNEL_DTYPES`, D in `KERNEL_HEAD_DIMS`, any T >= 1. Returns
    (B, Hq, T, D) in q's dtype on PyTorch's current stream, without
    synchronising. Raises on anything the kernel does not take. No route
    leads here any more: `flash_attention_tf32x3_cuda` computes the same
    function on the tensor cores."""
    build.refuse_grad("flash_attention_fma_cuda", q, k, v)
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
    bf16 launches `flash_attention_tc_cuda`, f32
    `flash_attention_tf32x3_cuda`, at D in `KERNEL_HEAD_DIMS`. Returns (B,
    Hq, T, D) in q's dtype; raises on anything neither kernel takes (a CPU
    tensor included). Both routes are differentiable (through
    `FlashAttention`)."""
    route = kernel_route(q.dtype, q.shape[-1])
    kernel = flash_attention_tc_cuda if route == "tc" \
        else flash_attention_tf32x3_cuda
    before = kernel.launches
    out = kernel(q, k, v, window=window)
    flash_attention_cuda.launches += kernel.launches - before
    return out


#: Kernel launches since the count was last set to 0 (the backwards: one a
#: call of the wrapper, which launches the pre-pass, the main kernel and,
#: for B5-bwd, the dq cast).
flash_attention_tc_cuda.launches = 0
flash_attention_bwd_tc_cuda.launches = 0
flash_attention_tf32x3_cuda.launches = 0
flash_attention_bwd_tf32x3_cuda.launches = 0
#: Launches of the f32 backward's mma.sync kernel (D 256) since the count
#: was last set to 0; `launches` counts the wgmma design's.
flash_attention_bwd_tf32x3_cuda.mma_sync_launches = 0
flash_attention_fma_cuda.launches = 0
#: Launches of either kernel made through the route.
flash_attention_cuda.launches = 0
