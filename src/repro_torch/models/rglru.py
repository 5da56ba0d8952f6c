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

The backward (B6-bwd): `RGLRUScan`, a `torch.autograd.Function`, runs the
kernel keeping its scratch (each tile's inclusive h, which the look-back
wrote) and ``csrc/rglru_scan_bwd.cu`` (`rglru_scan_bwd_cuda`: the same
tiles, the gradient scanned from the end of T by a decoupled look-back
the other way, h recomputed inside each tile from the forward's inclusive
h of the tile before) on CUDA tensors, and `rglru_scan_plain` with
`rglru_scan_bwd_plain` on CPU tensors. `rglru_scan` and `rglru_scan_cuda`
go through it whenever autograd would record the call.

The surrounding Griffin recurrent block is in blocks.py (conv1d + gating).

"meta" tensors (the dry run's, `launch.dryrun`) take the CUDA tensors'
route (`build.kernel_side`): each kernel wrapper allocates what its launch
would, launches nothing and counts no launch; while a counter is active
(`build.WORK`) every call, launched or traced, reports its work by the
kernel table's formula (`kernels.work`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, work as kernel_work
from repro_torch.models import layers

_C = 8.0

#: dtype -> the kernel's type code (activations; Lambda may differ).
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Time steps, channels and warps of one tile of the kernel (its TILE_
#: constants; the kernel's note says why this tile).
KERNEL_CHUNK = 96
KERNEL_CHANNELS = 128
KERNEL_WARPS = 8
#: Warps of the backward's block over the same tile (its BWD_WARPS), each
#: walking KERNEL_CHUNK / BWD_WARPS steps.
BWD_WARPS = 16

_P, _I = ctypes.c_void_p, ctypes.c_int


def rglru_init(gen, dim: int, dtype=torch.float32, *, lead=(), device=None):
    # Lambda uniform in [0.01, 0.5] (the reference's Griffin init).
    lam = torch.empty((*lead, dim), dtype=dtype,
                      device=layers.init_device(gen, device))
    lam.uniform_(0.01, 0.5, generator=gen)
    kw = dict(bias=True, dtype=dtype, lead=lead, device=device)
    return {
        "wa": layers.dense_init(gen, dim, dim, **kw),
        "wx": layers.dense_init(gen, dim, dim, **kw),
        "lam": lam,
    }


def _ct(x):
    """The plain versions compute in f32, or in f64 for f64 inputs (the
    gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _gate_values(wa, wx, x, lam):
    """(a, b) in f32 (f64 for f64 x) from the two dense outputs, x and
    Lambda."""
    ct = _ct(x)
    r = torch.sigmoid(wa.to(ct))
    i = torch.sigmoid(wx.to(ct))
    log_a = -_C * F.softplus(lam.to(ct)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * x.to(ct))
    return a, b


def _gates(p, x):
    return _gate_values(layers.dense_apply(p["wa"], x),
                        layers.dense_apply(p["wx"], x), x, p["lam"])


def rglru_scan_plain(wa, wx, x, lam, h0=None):
    """Plain PyTorch version of the B6 kernel: `_gates`' elementwise part,
    then h_t = a_t h_{t-1} + b_t step by step. wa, wx, x: (B, T, D) in one
    dtype; lam (D,); h0 (B, D) f32 or None (zeros). Returns (y (B, T, D)
    in x's dtype, h_last (B, D) f32; f64 throughout for f64 x)."""
    build.count(rglru_scan_plain, "calls")
    a, b = _gate_values(wa, wx, x, lam)
    hs = _h_sequence(a, b, h0)
    return hs.to(x.dtype), hs[:, -1]


#: Calls of the plain version since the count was last set to 0.
rglru_scan_plain.calls = 0


def _h_sequence(a, b, h0):
    """h_t = a_t h_{t-1} + b_t for every t, (B, T, D) in a's dtype."""
    B, T, D = a.shape
    h = (torch.zeros((B, D), dtype=a.dtype, device=a.device)
         if h0 is None else h0.to(a.dtype))
    hs = torch.empty_like(a)
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs


def rglru_scan_bwd_plain(wa, wx, x, lam, h0, dy, dh_last):
    """Plain PyTorch version of B6-bwd, the backward of `rglru_scan_plain`:
    (a, b) and h recomputed from the inputs, then the gradient of h
    scanned from the end of T,

        g_T = dy_T + dh_last,  g_t = dy_t + a_{t+1} g_{t+1}
        da_t = g_t h_{t-1} + g_t i x d sqrt(max(1 - a^2, 1e-9)) / da,
        db_t = g_t  (h_0 the incoming h0),

    chained through b = sqrt(max(1 - a^2, 1e-9)) i x and a = exp(-8
    softplus(lam) r) to wa, wx, x and lam (summed over B and T); dh0 =
    a_1 g_1, since the reference folds h0 into b_1. Where the clamp binds
    (1 - a^2 < 1e-9, a = 1 in f32) the square root passes no gradient to
    a; i and x still get theirs. dy (B, T, D) in x's dtype, dh_last (B,
    D) f32 or None. Returns (dwa, dwx, dx in x's dtype, dlam in lam's,
    dh0 f32 or None); f32 math, f64 for f64 x."""
    build.count(rglru_scan_bwd_plain, "calls")
    dwa, dwx, dx, dk, dh0, ct = _bwd_terms(wa, wx, x, lam, h0, dy, dh_last)
    dlam = dk.sum((0, 1)) * (-_C * torch.sigmoid(lam.to(ct)))
    return dwa, dwx, dx, dlam.to(lam.dtype), dh0


#: Calls of the plain backward since the count was last set to 0.
rglru_scan_bwd_plain.calls = 0


def _bwd_terms(wa, wx, x, lam, h0, dy, dh_last):
    """`rglru_scan_bwd_plain`'s arithmetic up to dlam: (dwa, dwx, dx in
    x's dtype, the terms da a r (B, T, D) that dlam sums, dh0 or None, the
    compute dtype)."""
    ct = _ct(x)
    r = torch.sigmoid(wa.to(ct))
    i = torch.sigmoid(wx.to(ct))
    k = -_C * F.softplus(lam.to(ct))
    a = torch.exp(k * r)
    xf = x.to(ct)
    s2 = 1.0 - a * a
    s = torch.sqrt(torch.clamp(s2, min=1e-9))
    hs = _h_sequence(a, s * (i * xf), h0)
    B, T, D = x.shape
    h_prev = torch.cat([(torch.zeros((B, 1, D), dtype=ct, device=x.device)
                         if h0 is None else h0.to(ct)[:, None]),
                        hs[:, :-1]], 1)
    dyf = dy.to(ct)
    u = (torch.zeros((B, D), dtype=ct, device=x.device)
         if dh_last is None else dh_last.to(ct))
    g = torch.empty_like(a)
    for t in range(T - 1, -1, -1):
        g[:, t] = dyf[:, t] + u
        u = a[:, t] * g[:, t]
    ds = g * i * xf
    da = g * h_prev - torch.where(s2 >= 1e-9, ds * a / s, 0.0)
    dk = da * a * r
    dwa = dk * k * (1.0 - r)
    dwx = g * s * xf * i * (1.0 - i)
    dx = g * s * i
    return (dwa.to(x.dtype), dwx.to(x.dtype), dx.to(x.dtype), dk,
            None if h0 is None else u.to(h0.dtype), ct)


def rglru_scan_bwd_tiles_plain(wa, wx, x, lam, h0, dy, dh_last):
    """`rglru_scan_bwd_plain` with dlam summed in B6-bwd's order: per tile
    of KERNEL_CHUNK steps (steps past T adding 0), each of its BWD_WARPS
    warps adds its steps' da a r from the last, the warps' sums are added
    in order, times -8 sigmoid(lam) per tile; then the tiles (the kernel
    adds them by atomics, in an order that varies from launch to launch;
    here from the first tile of the first batch row on)."""
    dwa, dwx, dx, dk, dh0, ct = _bwd_terms(wa, wx, x, lam, h0, dy, dh_last)
    B, T, D = x.shape
    L, W = KERNEL_CHUNK, BWD_WARPS
    nt = -(-T // L)
    rows = F.pad(dk, (0, 0, 0, nt * L - T)).reshape(B, nt, W, L // W, D)
    warps = torch.zeros_like(rows[:, :, :, 0])
    for r in reversed(range(L // W)):
        warps = warps + rows[:, :, :, r]
    tiles = torch.zeros_like(warps[:, :, 0])
    for w in range(W):
        tiles = tiles + warps[:, :, w]
    lc = lam.to(ct)
    tiles = -_C * tiles / (1.0 + torch.exp(-lc))
    dlam = torch.zeros_like(lc)
    for b in range(B):
        for tt in range(nt):
            dlam = dlam + tiles[b, tt]
    return dwa, dwx, dx, dlam.to(lam.dtype), dh0


#: Pointer arguments of each library's launch entry (then B, T, D, the two
#: dtype codes and the stream).
_N_PTRS = {"rglru_scan": 8, "rglru_scan_bwd": 14}


def _lib(name="rglru_scan"):
    """(launch entry, scratch-size entry) of the kernel library `name`."""
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    size = getattr(lib, f"{name}_scratch_bytes")
    if fn.argtypes is None:
        fn.argtypes = [_P] * _N_PTRS[name] + [_I] * 5 + [_P]
        fn.restype = _I
        size.argtypes = [_I] * 3
        size.restype = ctypes.c_int64
    return fn, size


def scratch_bytes(B, T, D) -> int:
    """Bytes of B6's (and B6-bwd's) scratch, as the kernels' own
    `*_scratch_bytes` entry gives them: per tile of `KERNEL_CHUNK` steps x
    `KERNEL_CHANNELS` channels an aggregate (2 f32), an inclusive h (1
    f32) per channel and a flag (4 bytes), and 4 bytes more. The dry run
    sizes a meta scratch by it; a CUDA launch asks the library."""
    tiles = B * -(-T // KERNEL_CHUNK) * -(-D // KERNEL_CHANNELS)
    return tiles * (KERNEL_CHANNELS * 12 + 4) + 4


def _check_cuda(name, wa, wx, x, lam, h0):
    """The checks both kernels' wrappers make of the forward's inputs:
    CUDA tensors (or the dry run's meta ones: `build.kernel_side`)."""
    if not (isinstance(x, torch.Tensor) and build.kernel_side(x)):
        raise ValueError(f"{name} takes CUDA tensors; the plain version "
                         f"runs anywhere")
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
        raise ValueError(f"{name} takes a non-empty x; got "
                         f"{tuple(x.shape)}")
    if lam.shape != (D,) or lam.dtype not in KERNEL_DTYPES:
        raise ValueError(f"lam must be ({D},) in {list(KERNEL_DTYPES)}")
    if h0 is not None and (h0.shape != (B, D) or h0.dtype != torch.float32):
        raise ValueError(f"h0 must be ({B}, {D}) float32")
    tensors = [wa, wx, x, lam] + ([h0] if h0 is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return B, T, D


def _forward_cuda(wa, wx, x, lam, h0):
    """One launch of the B6 kernel: (y, h_last, scratch). The scratch
    holds, after the launch, each tile's aggregate and inclusive h (the
    look-back's values): B6-bwd reads the inclusive h."""
    B, T, D = _check_cuda("rglru_scan_cuda", wa, wx, x, lam, h0)
    y = torch.empty_like(x)
    h_last = torch.empty((B, D), dtype=torch.float32, device=x.device)
    fn, size = (None, scratch_bytes) if x.is_meta else _lib()
    # The look-back's values and flags; the launch zeroes the flags.
    scratch = torch.empty(size(B, T, D), dtype=torch.uint8, device=x.device)
    if not x.is_meta:
        with torch.cuda.device(x.device):
            err = fn(
                wa.data_ptr(), wx.data_ptr(), x.data_ptr(), lam.data_ptr(),
                h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                h_last.data_ptr(), scratch.data_ptr(), B, T, D,
                KERNEL_DTYPES[x.dtype], KERNEL_DTYPES[lam.dtype],
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"rglru_scan kernel launch failed: CUDA "
                               f"error {err}")
        build.count(rglru_scan_cuda)
    if build.WORK is not None:
        build.WORK.kernel("rglru_scan", kernel_work.rglru(
            B, T, D, x.element_size(), lam.element_size(), h0 is not None))
    return y, h_last, scratch


def rglru_scan_cuda(wa, wx, x, lam, h0=None):
    """Launch the B6 kernel on CUDA tensors: wa, wx, x (B, T, D)
    contiguous in one dtype of `KERNEL_DTYPES`, lam (D,) f32 or bf16, h0
    (B, D) f32 or None. Returns (y in x's dtype, h_last (B, D) f32), on
    the current stream, not synchronised. Where autograd would record the
    call it goes through `RGLRUScan` (the same launch, its scratch kept,
    and B6-bwd behind it). Raises on anything the kernel does not take."""
    if build.records_grad(wa, wx, x, lam, h0):
        return RGLRUScan.apply(wa, wx, x, lam, h0)
    return _forward_cuda(wa, wx, x, lam, h0)[:2]


#: Kernel launches since the count was last set to 0.
rglru_scan_cuda.launches = 0


def rglru_scan_bwd_cuda(wa, wx, x, lam, h0, saved, dy, dh_last=None):
    """Launch B6-bwd (`csrc/rglru_scan_bwd.cu`) on CUDA tensors: the
    forward's inputs as `rglru_scan_cuda` takes them, `saved` the scratch
    of the forward's launch on the same inputs (each tile's inclusive h),
    dy (B, T, D) in x's dtype, dh_last (B, D) f32 or None. Returns (dwa,
    dwx, dx in x's dtype, dlam in lam's, dh0 f32 or None), on the current
    stream, not synchronised; dlam's f32 sums over B and T land by
    atomics, in an order that varies from call to call. Raises on
    anything the kernel does not take."""
    name = "rglru_scan_bwd_cuda"
    B, T, D = _check_cuda(name, wa, wx, x, lam, h0)
    fwd_size = (scratch_bytes if x.is_meta else _lib()[1])(B, T, D)
    if saved.dtype != torch.uint8 or saved.shape != (fwd_size,) \
            or not saved.is_contiguous():
        raise ValueError(f"{name}: saved must be the forward's scratch, "
                         f"({fwd_size},) uint8")
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"{name}: dy must be contiguous like x "
                         f"{tuple(x.shape)} {x.dtype}")
    if dh_last is not None and (dh_last.shape != (B, D)
                                or dh_last.dtype != torch.float32
                                or not dh_last.is_contiguous()):
        raise ValueError(f"{name}: dh_last must be contiguous ({B}, {D}) "
                         f"float32")
    if any(t.device != x.device for t in (saved, dy) + (
            () if dh_last is None else (dh_last,))):
        raise ValueError(f"{name}: all tensors must be on one device")
    dwa, dwx, dx = (torch.empty_like(x) for _ in range(3))
    dlam = torch.empty(D, dtype=torch.float32, device=x.device)
    dh0 = None if h0 is None else torch.empty_like(h0)
    fn, size = (None, scratch_bytes) if x.is_meta \
        else _lib("rglru_scan_bwd")
    scratch = torch.empty(size(B, T, D), dtype=torch.uint8, device=x.device)
    if not x.is_meta:
        with torch.cuda.device(x.device):
            err = fn(
                *(None if t is None else t.data_ptr() for t in (
                    wa, wx, x, lam, h0, saved, dy, dh_last, dwa, dwx, dx,
                    dlam, dh0, scratch)), B, T, D, KERNEL_DTYPES[x.dtype],
                KERNEL_DTYPES[lam.dtype],
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"rglru_scan_bwd kernel launch failed: CUDA "
                               f"error {err}")
        build.count(rglru_scan_bwd_cuda)
    if build.WORK is not None:
        build.WORK.kernel("rglru_scan_bwd", kernel_work.rglru_bwd(
            B, T, D, x.element_size(), lam.element_size(), h0 is not None,
            KERNEL_CHUNK, KERNEL_CHANNELS))
    return dwa, dwx, dx, dlam.to(lam.dtype), dh0


#: Kernel launches since the count was last set to 0.
rglru_scan_bwd_cuda.launches = 0


class RGLRUScan(torch.autograd.Function):
    """B6 with its backward: on CUDA tensors the kernel, its scratch kept,
    and B6-bwd; on CPU tensors `rglru_scan_plain` and
    `rglru_scan_bwd_plain`. Everything the backward reads goes through
    `ctx.save_for_backward` (the inputs and the forward's scratch), so a
    non-reentrant checkpoint may run the forward again. `apply(wa, wx, x,
    lam, h0) -> (y, h_last)`; h0 may be None."""

    @staticmethod
    def forward(ctx, wa, wx, x, lam, h0):
        if build.kernel_side(x):
            y, h_last, saved = _forward_cuda(wa, wx, x, lam, h0)
        else:
            (y, h_last), saved = rglru_scan_plain(wa, wx, x, lam, h0), None
        ctx.save_for_backward(wa, wx, x, lam, h0, saved)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        wa, wx, x, lam, h0, saved = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dy = dy.to(x.dtype).contiguous()
        if dh_last is not None:
            dh_last = dh_last.to(torch.float32 if build.kernel_side(x)
                                 else _ct(x)).contiguous()
        if build.kernel_side(x):
            grads = rglru_scan_bwd_cuda(wa, wx, x, lam, h0, saved, dy,
                                        dh_last)
        else:
            grads = rglru_scan_bwd_plain(wa, wx, x, lam, h0, dy, dh_last)
        return grads


def rglru_scan(wa, wx, x, lam, h0=None):
    """The gates and the scan where the tensors live: where autograd
    records the call, `RGLRUScan` (kernel or plain version, with its
    backward); elsewhere CPU tensors take `rglru_scan_plain`, CUDA tensors
    the kernel."""
    if build.records_grad(wa, wx, x, lam, h0):
        return RGLRUScan.apply(wa, wx, x, lam, h0)
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
