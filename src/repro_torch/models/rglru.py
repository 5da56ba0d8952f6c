"""RG-LRU recurrent unit (RecurrentGemma / Griffin).

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)              (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)              (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)    (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The port of the JAX package's `models/rglru.py`. The reference scans
(a, b) pairs with `jax.lax.associative_scan`; here the two dense products
stay on cuBLAS and everything after them — the gates and the scan over T
— is one wrapper, `rglru_scan`: on CUDA tensors the hand-written kernel
(``csrc/rglru_scan.cu``: one pass over tiles of `KERNEL_CHUNK` steps by
`KERNEL_CHANNELS` channels, each tile's incoming h found by a decoupled
look-back over the tiles before it), on CPU tensors its plain version
`rglru_scan_plain` (`_gates`, then a loop over T). Decode is the
single-step update with h carried in the layer cache (`rglru_step`,
plain tensor ops: one step, no loop).

The surrounding Griffin recurrent block is in blocks.py (conv1d + gating).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.models import layers

_C = 8.0

#: dtype -> the kernel's type code (activations; Lambda may differ).
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Time steps, channels and warps of one tile of the kernel (its TILE_
#: constants; the kernel's note says why this tile).
KERNEL_CHUNK = 96
KERNEL_CHANNELS = 128
KERNEL_WARPS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int


def rglru_init(gen, dim: int, dtype=torch.float32, *, lead=()):
    # Lambda uniform in [0.01, 0.5] (the reference's Griffin init).
    lam = torch.empty((*lead, dim), dtype=dtype, device=gen.device)
    lam.uniform_(0.01, 0.5, generator=gen)
    return {
        "wa": layers.dense_init(gen, dim, dim, bias=True, dtype=dtype,
                                lead=lead),
        "wx": layers.dense_init(gen, dim, dim, bias=True, dtype=dtype,
                                lead=lead),
        "lam": lam,
    }


def _gate_values(wa, wx, x, lam):
    """(a, b) in f32 from the two dense outputs, x and Lambda."""
    r = torch.sigmoid(wa.float())
    i = torch.sigmoid(wx.float())
    log_a = -_C * F.softplus(lam.float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * x.float())
    return a, b


def _gates(p, x):
    return _gate_values(layers.dense_apply(p["wa"], x),
                        layers.dense_apply(p["wx"], x), x, p["lam"])


def rglru_scan_plain(wa, wx, x, lam, h0=None):
    """Plain PyTorch version of the B6 kernel: `_gates`' elementwise part,
    then h_t = a_t h_{t-1} + b_t step by step. wa, wx, x: (B, T, D) in one
    dtype; lam (D,); h0 (B, D) f32 or None (zeros). Returns (y (B, T, D)
    in x's dtype, h_last (B, D) f32)."""
    build.count(rglru_scan_plain, "calls")
    a, b = _gate_values(wa, wx, x, lam)
    B, T, D = x.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        ys[:, t] = h
    return ys.to(x.dtype), h


#: Calls of the plain version since the count was last set to 0.
rglru_scan_plain.calls = 0


def _lib():
    lib = build.load("rglru_scan")
    fn, size = lib.rglru_scan_launch, lib.rglru_scan_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        fn.restype = _I
        size.argtypes = [_I] * 3
        size.restype = ctypes.c_int64
    return fn, size


def rglru_scan_cuda(wa, wx, x, lam, h0=None):
    """Launch the B6 kernel on CUDA tensors: wa, wx, x (B, T, D)
    contiguous in one dtype of `KERNEL_DTYPES`, lam (D,) f32 or bf16, h0
    (B, D) f32 or None. Returns (y in x's dtype, h_last (B, D) f32), on
    the current stream, not synchronised. Raises on anything the kernel
    does not take."""
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError("rglru_scan_cuda takes CUDA tensors; the plain "
                         "version rglru_scan_plain runs anywhere")
    if x.dim() != 3 or wa.shape != x.shape or wx.shape != x.shape:
        raise ValueError(f"wa, wx, x must be one (B, T, D) shape; got "
                         f"{tuple(wa.shape)}, {tuple(wx.shape)}, "
                         f"{tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES or wa.dtype != x.dtype \
            or wx.dtype != x.dtype:
        raise ValueError(f"wa, wx, x must share one dtype of "
                         f"{list(KERNEL_DTYPES)}")
    B, T, D = x.shape
    if not x.numel():
        raise ValueError(f"rglru_scan_cuda takes a non-empty x; got "
                         f"{tuple(x.shape)}")
    if lam.shape != (D,) or lam.dtype not in KERNEL_DTYPES:
        raise ValueError(f"lam must be ({D},) in {list(KERNEL_DTYPES)}")
    if h0 is not None and (h0.shape != (B, D) or h0.dtype != torch.float32):
        raise ValueError(f"h0 must be ({B}, {D}) float32")
    tensors = [wa, wx, x, lam] + ([h0] if h0 is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru_scan_cuda takes contiguous tensors")
    build.refuse_grad("rglru_scan_cuda", *tensors)
    y = torch.empty_like(x)
    h_last = torch.empty((B, D), dtype=torch.float32, device=x.device)
    fn, size = _lib()
    # The look-back's values and flags; the launch zeroes the flags.
    scratch = torch.empty(size(B, T, D), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(wa.data_ptr(), wx.data_ptr(), x.data_ptr(), lam.data_ptr(),
                 h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                 h_last.data_ptr(), scratch.data_ptr(), B, T, D,
                 KERNEL_DTYPES[x.dtype], KERNEL_DTYPES[lam.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    build.count(rglru_scan_cuda)
    return y, h_last


#: Kernel launches since the count was last set to 0.
rglru_scan_cuda.launches = 0


def rglru_scan(wa, wx, x, lam, h0=None):
    """The gates and the scan where the tensors live: CPU tensors take
    `rglru_scan_plain`, CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return rglru_scan_plain(wa, wx, x, lam, h0)
    return rglru_scan_cuda(wa, wx, x, lam, h0)


def rglru_apply(p, x, h0=None):
    """x: (B, T, D). Returns (y in x's dtype, h_last (B, D) f32)."""
    wa = layers.dense_apply(p["wa"], x)
    wx = layers.dense_apply(p["wx"], x)
    lam = p["lam"]
    if h0 is not None:
        h0 = h0.float().contiguous()
    return rglru_scan(wa.contiguous(), wx.contiguous(), x.contiguous(),
                      lam.contiguous(), h0)


def rglru_step(p, x, h):
    """Single decode step. x: (B, 1, D); h: (B, D)."""
    a, b = _gates(p, x)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new[:, None].to(x.dtype), h_new
