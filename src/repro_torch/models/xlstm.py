"""xLSTM mixers: chunkwise-parallel mLSTM and recurrent sLSTM.

The port of the JAX package's `models/xlstm.py`. mLSTM (matrix-memory
LSTM) is a linear-attention-style recurrence

    m_t = max(f~_t + m_{t-1}, i~_t)                      (stabiliser)
    f'_t = exp(f~_t + m_{t-1} - m_t);  i'_t = exp(i~_t - m_t)
    C_t = f'_t C_{t-1} + i'_t k_t v_t^T                  (dk x dv state)
    n_t = f'_t n_{t-1} + i'_t k_t
    h_t = C_t^T q_t / max(|n_t . q_t|, exp(-m_t))

two ways, as the reference:
  * `mlstm_recurrent` — a step loop over time: the oracle, and the decode
    step (T = 1: plain tensor ops).
  * `mlstm_chunkwise` — within a chunk of length c a masked attention-like
    product, across chunks a carried (C, n, m). On CUDA tensors the chunk
    loop is the hand-written B7 (``csrc/mlstm_chunk.cu``): three kernels —
    every chunk's own state contribution in parallel, a cheap serial scan
    over chunks, every chunk's output in parallel — each with a plain
    version below; on CPU tensors `mlstm_chunk_scan_plain` (the
    reference's chunk step in einsums). With b_r = cumsum(f~),
    w_s = i~_s - b_s, g_r = runmax(w), M_r = max(m_0, g_r):
        weight(r,s) = exp(w_s - M_r)  (s <= r)
        inter scale = exp(m_0 - M_r)
        m_{u,r} = b_r + M_r, and the chunk-end state uses M_c.

sLSTM keeps the true nonlinear recurrence (R h_{t-1} feeds the gates), so
it steps over time by construction — per-head block-diagonal recurrence.
On CUDA tensors the whole step loop is the hand-written kernel B8
(``csrc/slstm.cu``: one thread-block cluster per (batch row, head), R in
registers, h handed one way between the blocks each step), on CPU tensors
its plain version `slstm_scan_plain` (the reference's step). Both serve
prefill and the one-token decode step.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.models import layers

#: dtype -> the kernels' type code.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Longest chunk the mLSTM kernel takes (its tiles are 64 rows).
MAX_KERNEL_CHUNK = 64
#: Largest head sizes the kernels take: B7 keeps q, k tiles of D columns
#: in shared memory; B8 keeps at most 32 rows of R a thread (8 warps).
MLSTM_MAX_HEAD_DIM = 256
SLSTM_MAX_HEAD_DIM = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_GATES = ("z", "i", "f", "o")


def _check_cuda(name, *tensors):
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors; its plain version runs "
                         f"anywhere")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    build.refuse_grad(name, *tensors)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, d_model: int, n_heads: int, head_dim: int,
               dtype=torch.float32, *, lead=()):
    H, D = n_heads, head_dim

    def dense(i, o, bias=False):
        return layers.dense_init(gen, i, o, bias=bias, dtype=dtype, lead=lead)
    return {
        "wq": dense(d_model, H * D),
        "wk": dense(d_model, H * D),
        "wv": dense(d_model, H * D),
        "wi": dense(d_model, H, bias=True),
        "wf": dense(d_model, H, bias=True),
        "wo": dense(H * D, d_model),
    }


def _mlstm_qkv_gates(p, x, n_heads, head_dim):
    """q, k, v (B, H, T, D) f32 — views of (B, T, H, D) products, not
    copies — and the gate pre-activations i~, f~ (B, H, T) f32; k scaled
    by 1/sqrt(D) in x's dtype, f~ = log_sigmoid(W_f x + 1)."""
    B, T, _ = x.shape
    H, D = n_heads, head_dim

    def heads(name):
        return layers.dense_apply(p[name], x).reshape(B, T, H, D)
    q, k, v = heads("wq"), heads("wk"), heads("wv")
    k = k / (D ** 0.5)
    it = layers.dense_apply(p["wi"], x).float().transpose(1, 2)
    ft = F.logsigmoid(layers.dense_apply(p["wf"], x).float() + 1.0) \
        .transpose(1, 2)
    return (q.float().transpose(1, 2), k.float().transpose(1, 2),
            v.float().transpose(1, 2), it, ft)


def mlstm_state_init(batch, n_heads, head_dim, dtype=torch.float32, *,
                     device="cpu", lead=()):
    H, D = n_heads, head_dim
    return {
        "C": torch.zeros((*lead, batch, H, D, D), dtype=dtype, device=device),
        "n": torch.zeros((*lead, batch, H, D), dtype=dtype, device=device),
        "m": torch.zeros((*lead, batch, H), dtype=dtype, device=device),
    }


def mlstm_step(state, q, k, v, it, ft):
    """One recurrent step. q/k/v: (B,H,D); it/ft: (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(ft + m, it)
    fp = torch.exp(ft + m - m_new)
    ip = torch.exp(it - m_new)
    C_new = fp[..., None, None] * C + ip[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = fp[..., None] * n + ip[..., None] * k
    h_tilde = torch.einsum("bhkv,bhk->bhv", C_new, q)
    denom = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, q).abs(),
                          torch.exp(-m_new))
    h = h_tilde / denom[..., None]
    return {"C": C_new, "n": n_new, "m": m_new}, h


def _state_or_zeros(state, B, H, D, device):
    if state is None:
        return mlstm_state_init(B, H, D, device=device)
    return {key: state[key].float() for key in ("C", "n", "m")}


def mlstm_recurrent(p, x, n_heads, head_dim, state=None):
    """Oracle / decode path: a loop over T. Returns (y (B, T, d), state)."""
    B, T, _ = x.shape
    H, D = n_heads, head_dim
    q, k, v, it, ft = _mlstm_qkv_gates(p, x, H, D)
    state = _state_or_zeros(state, B, H, D, x.device)
    hs = []
    for t in range(T):
        state, h = mlstm_step(state, q[:, :, t], k[:, :, t], v[:, :, t],
                              it[:, :, t], ft[:, :, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, T, H * D)
    return layers.dense_apply(p["wo"], h.to(x.dtype)), state


def mlstm_chunk_scan_plain(q, k, v, it, ft, state, chunk: int):
    """Plain PyTorch version of the B7 kernel: the reference's chunk step
    in einsums. q, k, v (B, H, T, D) f32, it, ft (B, H, T) f32, state
    {C (B,H,D,D), n (B,H,D), m (B,H)} f32, T % chunk == 0. Returns
    (h (B, T, H*D) f32, state)."""
    build.count(mlstm_chunk_scan_plain, "calls")
    B, H, T, D = q.shape
    nc = T // chunk
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    C0, n0, m0 = state["C"], state["n"], state["m"]
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qu, ku, vu, iu, fu = q[:, :, sl], k[:, :, sl], v[:, :, sl], \
            it[:, :, sl], ft[:, :, sl]
        b = torch.cumsum(fu, dim=-1)
        w = iu - b
        g = torch.cummax(w, dim=-1).values
        M = torch.maximum(m0[..., None], g)
        Dw = torch.exp(w[..., None, :] - M[..., :, None])
        Dw = torch.where(mask, Dw, 0.0)
        S = torch.einsum("bhrd,bhsd->bhrs", qu, ku)
        intra = torch.einsum("bhrs,bhsd->bhrd", Dw * S, vu)
        inter_scale = torch.exp(m0[..., None] - M)
        inter = torch.einsum("bhrd,bhdv->bhrv", qu, C0) \
            * inter_scale[..., None]
        h_tilde = inter + intra
        n_intra = torch.einsum("bhrs,bhsd->bhrd", Dw, ku)
        n_r = n0[..., None, :] * inter_scale[..., None] + n_intra
        dot = torch.einsum("bhrd,bhrd->bhr", n_r, qu)
        m_ur = b + M
        denom = torch.maximum(dot.abs(), torch.exp(-m_ur))
        hs.append(h_tilde / denom[..., None])
        bc = b[..., -1:]
        Mc = M[..., -1]
        decay = torch.exp(w - Mc[..., None])
        C0 = (torch.exp(m0 - Mc)[..., None, None] * C0
              + torch.einsum("bhs,bhsk,bhsv->bhkv", decay, ku, vu))
        n0 = (torch.exp(m0 - Mc)[..., None] * n0
              + torch.einsum("bhs,bhsk->bhk", decay, ku))
        m0 = bc[..., 0] + Mc
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(B, T, H * D)
    return h, {"C": C0, "n": n0, "m": m0}


#: Calls of the plain version since the count was last set to 0.
mlstm_chunk_scan_plain.calls = 0


# B7 on CUDA tensors: three kernels (`csrc/mlstm_chunk.cu`) — chunk states,
# the inter-chunk scan, chunk outputs — through a scratch of per-chunk
# states, `work` (B, H, nc, D + 1, DP) f32 (rows < D: C, row D: n, zero
# past column D) and `scal` (B, H, nc, 4) f32 (b_last, G, incoming m, 0).
# Each pass has a plain version of the same arguments and results below;
# together they compute `mlstm_chunk_scan_plain`'s function.

def mlstm_work_cols(head_dim: int) -> int:
    """Columns DP of a scratch row: the head size rounded up to the 64
    columns of the passes' tiles."""
    return -(-head_dim // 64) * 64


def mlstm_work_shapes(B, H, T, D, chunk):
    """Shapes of the scratch pair (work, scal) for (B, H, T, D) inputs
    cut into chunks of `chunk` steps."""
    nc = T // chunk
    return (B, H, nc, D + 1, mlstm_work_cols(D)), (B, H, nc, 4)


def mlstm_work_bytes(B, H, T, D, chunk) -> int:
    """Bytes of the scratch pair of one B7 call."""
    a, b = mlstm_work_shapes(B, H, T, D, chunk)
    return 4 * (math.prod(a) + math.prod(b))


def _gate_scan(it, ft, chunk):
    """Per chunk: b = cumsum(f~), w = i~ - b, as (B, H, nc, L)."""
    B, H, T = it.shape
    fc = ft.reshape(B, H, T // chunk, chunk)
    b = torch.cumsum(fc, dim=-1)
    return b, it.reshape(B, H, T // chunk, chunk) - b


def mlstm_chunk_states_plain(k, v, it, ft, chunk: int):
    """Plain PyTorch version of B7's first pass: per (b, head, chunk) with
    G = max_s w_s, dC = sum_s exp(w_s - G) k_s v_s^T into work[..., :D,
    :D], dn = sum_s exp(w_s - G) k_s into work[..., D, :D], and b_last, G
    into scal[..., 0:2]. k, v (B, H, T, D) f32, it, ft (B, H, T) f32.
    Returns (work, scal)."""
    build.count(mlstm_chunk_states_plain, "calls")
    B, H, T, D = k.shape
    wshape, sshape = mlstm_work_shapes(B, H, T, D, chunk)
    nc = wshape[2]
    b, w = _gate_scan(it, ft, chunk)
    G = w.max(dim=-1).values
    a = torch.exp(w - G[..., None])
    kc = k.reshape(B, H, nc, chunk, D)
    vc = v.reshape(B, H, nc, chunk, D)
    work = torch.zeros(wshape, dtype=torch.float32, device=k.device)
    work[..., :D, :D] = torch.einsum("bhcs,bhcsk,bhcsv->bhckv", a, kc, vc)
    work[..., D, :D] = torch.einsum("bhcs,bhcsk->bhck", a, kc)
    scal = torch.zeros(sshape, dtype=torch.float32, device=k.device)
    scal[..., 0] = b[..., -1]
    scal[..., 1] = G
    return work, scal


mlstm_chunk_states_plain.calls = 0


def mlstm_state_scan_plain(work, scal, state):
    """Plain PyTorch version of B7's second pass, in place like the
    kernel: walks the chunks from `state` {C, n, m}, M_c = max(m, G_c),
    C = exp(m - M_c) C + exp(G_c - M_c) dC (n likewise), m = b_last +
    M_c, leaving in work / scal[..., 2] each chunk's incoming (C, n, m).
    Returns the final state."""
    build.count(mlstm_state_scan_plain, "calls")
    B, H, nc, D1, DP = work.shape
    D = D1 - 1
    C = torch.zeros((B, H, D1, DP), dtype=torch.float32, device=work.device)
    C[..., :D, :D] = state["C"]
    C[..., D, :D] = state["n"]
    m = state["m"].float().clone()
    for c in range(nc):
        G = scal[:, :, c, 1]
        M = torch.maximum(m, G)
        alpha = torch.exp(m - M)[..., None, None]
        beta = torch.exp(G - M)[..., None, None]
        dC = work[:, :, c].clone()
        work[:, :, c] = C
        scal[:, :, c, 2] = m
        C = alpha * C + beta * dC
        m = scal[:, :, c, 0] + M
    return {"C": C[..., :D, :D].contiguous(), "n": C[..., D, :D].contiguous(),
            "m": m}


mlstm_state_scan_plain.calls = 0


def mlstm_chunk_outputs_plain(q, k, v, it, ft, work, scal, chunk: int):
    """Plain PyTorch version of B7's third pass: every chunk's h from its
    q, k, v, gates and its incoming (C, n, m) in work / scal, the
    reference's chunk step (`mlstm_chunk_scan_plain`) over all chunks at
    once. Returns h (B, T, H*D) f32."""
    build.count(mlstm_chunk_outputs_plain, "calls")
    B, H, T, D = q.shape
    nc = T // chunk
    b, w = _gate_scan(it, ft, chunk)
    m0 = scal[..., 2]
    M = torch.maximum(m0[..., None], torch.cummax(w, dim=-1).values)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    Dw = torch.where(mask, torch.exp(w[..., None, :] - M[..., :, None]), 0.0)
    qc, kc, vc = (x.reshape(B, H, nc, chunk, D) for x in (q, k, v))
    S = torch.einsum("bhcrd,bhcsd->bhcrs", qc, kc)
    intra = torch.einsum("bhcrs,bhcsd->bhcrd", Dw * S, vc)
    scale = torch.exp(m0[..., None] - M)
    inter = torch.einsum("bhcrd,bhcdv->bhcrv", qc, work[..., :D, :D]) \
        * scale[..., None]
    n_r = work[..., None, D, :D] * scale[..., None] \
        + torch.einsum("bhcrs,bhcsd->bhcrd", Dw, kc)
    dot = torch.einsum("bhcrd,bhcrd->bhcr", n_r, qc)
    denom = torch.maximum(dot.abs(), torch.exp(-(b + M)))
    h = (inter + intra) / denom[..., None]
    return h.reshape(B, H, T, D).transpose(1, 2).reshape(B, T, H * D)


mlstm_chunk_outputs_plain.calls = 0


def _mlstm_fn(name, nargs):
    fn = getattr(build.load("mlstm_chunk"), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * nargs[0] + [_I] * nargs[1] + [_P]
        fn.restype = _I
    return fn


def _check_mlstm_inputs(name, tensors, it, ft, chunk):
    """The checks the passes share: tensors (k, v or q, k, v) f32 (B, H,
    T, D) with one set of strides and unit stride along D; it, ft f32 (B,
    H, T) with one set of strides; 1 <= chunk <= 64 dividing T; D <= 256.
    Returns (B, H, T, D)."""
    _check_cuda(name, *tensors, it, ft)
    B, H, T, D = tensors[0].shape
    if any(t.shape != (B, H, T, D) for t in tensors) \
            or it.shape != (B, H, T) or ft.shape != (B, H, T):
        raise ValueError("q, k, v must be (B, H, T, D) and it, ft (B, H, T)")
    if any(t.dtype != torch.float32 for t in (*tensors, it, ft)):
        raise ValueError(f"{name} takes float32 q, k, v, it, ft")
    if any(t.stride() != tensors[0].stride() for t in tensors) \
            or tensors[0].stride(3) != 1 or it.stride() != ft.stride():
        raise ValueError("q, k, v need one set of strides with unit stride "
                         "along D, and it, ft one set")
    if not B * H * T:
        raise ValueError(f"{name} takes non-empty inputs")
    if not 1 <= chunk <= MAX_KERNEL_CHUNK or T % chunk:
        raise ValueError(f"chunk={chunk} must be in 1..{MAX_KERNEL_CHUNK} "
                         f"and divide T={T}")
    if not 1 <= D <= MLSTM_MAX_HEAD_DIM:
        raise ValueError(f"head size {D} outside 1..{MLSTM_MAX_HEAD_DIM}")
    if max(tensors[0].stride() + it.stride()) >= 2 ** 31:
        raise ValueError("strides past 2^31 elements: the kernels take "
                         "32-bit strides")
    return B, H, T, D


def _check_work(name, work, scal, B, H, T, D, chunk):
    wshape, sshape = mlstm_work_shapes(B, H, T, D, chunk)
    _check_cuda(name, work, scal)
    if tuple(work.shape) != wshape or tuple(scal.shape) != sshape \
            or work.dtype != torch.float32 or scal.dtype != torch.float32 \
            or not (work.is_contiguous() and scal.is_contiguous()):
        raise ValueError(f"work / scal must be contiguous float32 {wshape} "
                         f"/ {sshape}")


def mlstm_chunk_states_cuda(k, v, it, ft, chunk: int):
    """Launch B7's first pass on CUDA tensors (as
    `mlstm_chunk_states_plain`). On the current stream, not
    synchronised."""
    B, H, T, D = _check_mlstm_inputs("mlstm_chunk_states_cuda", (k, v), it,
                                     ft, chunk)
    wshape, sshape = mlstm_work_shapes(B, H, T, D, chunk)
    work = torch.empty(wshape, dtype=torch.float32, device=k.device)
    scal = torch.empty(sshape, dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        err = _mlstm_fn("mlstm_chunk_states_launch", (6, 11))(
            k.data_ptr(), v.data_ptr(), it.data_ptr(), ft.data_ptr(),
            work.data_ptr(), scal.data_ptr(), B, H, T, D, chunk,
            *k.stride()[:3], *it.stride(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mlstm_chunk_states")
    build.count(mlstm_chunk_states_cuda)
    return work, scal


mlstm_chunk_states_cuda.launches = 0


def mlstm_state_scan_cuda(work, scal, state):
    """Launch B7's second pass on CUDA tensors (as `mlstm_state_scan_plain`:
    work and scal rewritten in place). Returns the final state. On the
    current stream, not synchronised."""
    B, H, nc, D1, _ = work.shape
    D = D1 - 1
    _check_work("mlstm_state_scan_cuda", work, scal, B, H, nc, D, 1)
    C0, n0, m0 = (state[key].float().contiguous() for key in ("C", "n", "m"))
    _check_cuda("mlstm_state_scan_cuda", work, C0, n0, m0)
    if C0.shape != (B, H, D, D) or n0.shape != (B, H, D) \
            or m0.shape != (B, H):
        raise ValueError("state must be C (B,H,D,D), n (B,H,D), m (B,H)")
    C1, n1, m1 = torch.empty_like(C0), torch.empty_like(n0), \
        torch.empty_like(m0)
    with torch.cuda.device(work.device):
        err = _mlstm_fn("mlstm_state_scan_launch", (8, 4))(
            work.data_ptr(), scal.data_ptr(), C0.data_ptr(), n0.data_ptr(),
            m0.data_ptr(), C1.data_ptr(), n1.data_ptr(), m1.data_ptr(),
            B, H, nc, D, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mlstm_state_scan")
    build.count(mlstm_state_scan_cuda)
    return {"C": C1, "n": n1, "m": m1}


mlstm_state_scan_cuda.launches = 0


def mlstm_chunk_outputs_cuda(q, k, v, it, ft, work, scal, chunk: int):
    """Launch B7's third pass on CUDA tensors (as
    `mlstm_chunk_outputs_plain`). On the current stream, not
    synchronised."""
    B, H, T, D = _check_mlstm_inputs("mlstm_chunk_outputs_cuda", (q, k, v),
                                     it, ft, chunk)
    _check_work("mlstm_chunk_outputs_cuda", work, scal, B, H, T, D, chunk)
    h = torch.empty((B, T, H * D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _mlstm_fn("mlstm_chunk_outputs_launch", (8, 11))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), it.data_ptr(),
            ft.data_ptr(), work.data_ptr(), scal.data_ptr(), h.data_ptr(),
            B, H, T, D, chunk, *q.stride()[:3], *it.stride(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mlstm_chunk_outputs")
    build.count(mlstm_chunk_outputs_cuda)
    return h


mlstm_chunk_outputs_cuda.launches = 0


def mlstm_chunk_scan_cuda(q, k, v, it, ft, state, chunk: int):
    """B7 on CUDA tensors, same arguments and results as
    `mlstm_chunk_scan_plain`: the three pass kernels in turn, through a
    scratch of `mlstm_work_bytes` bytes. q, k, v f32 (B, H, T, D) with unit
    stride along D and one set of strides for the three (the views
    `_mlstm_qkv_gates` makes qualify); it, ft f32 (B, H, T) with one set
    of strides; state f32; 1 <= chunk <= 64 dividing T; D <= 256. On the
    current stream, not synchronised."""
    _check_cuda("mlstm_chunk_scan_cuda", q, k, v, it, ft,
                *(state[key] for key in ("C", "n", "m")))
    _check_mlstm_inputs("mlstm_chunk_scan_cuda", (q, k, v), it, ft, chunk)
    work, scal = mlstm_chunk_states_cuda(k, v, it, ft, chunk)
    state = mlstm_state_scan_cuda(work, scal, state)
    return mlstm_chunk_outputs_cuda(q, k, v, it, ft, work, scal,
                                    chunk), state


def mlstm_chunk_scan(q, k, v, it, ft, state, chunk: int):
    """The chunk loop where the tensors live: CPU tensors take
    `mlstm_chunk_scan_plain`, CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return mlstm_chunk_scan_plain(q, k, v, it, ft, state, chunk)
    return mlstm_chunk_scan_cuda(q, k, v, it, ft, state, chunk)


def mlstm_chunkwise(p, x, n_heads, head_dim, state=None, chunk: int = 64):
    """Chunk-parallel mLSTM (see module docstring). Returns (y, state)."""
    B, T, _ = x.shape
    H, D = n_heads, head_dim
    if T % chunk:
        raise ValueError(f"T={T} must be divisible by chunk={chunk}")
    q, k, v, it, ft = _mlstm_qkv_gates(p, x, H, D)
    state = _state_or_zeros(state, B, H, D, x.device)
    h, state = mlstm_chunk_scan(q, k, v, it, ft, state, chunk)
    return layers.dense_apply(p["wo"], h.to(x.dtype)), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen, d_model: int, n_heads: int, dtype=torch.float32, *,
               lead=()):
    if d_model % n_heads:
        raise ValueError("d_model must divide n_heads")
    Dh = d_model // n_heads
    # As in the reference, the output gate's input weights "wo" (with
    # bias) are also the block's output projection (`slstm_apply`): its
    # loop over the gates overwrites the projection it made first.
    p = {}
    for gate in _GATES:
        p[f"w{gate}"] = layers.dense_init(gen, d_model, d_model, bias=True,
                                          dtype=dtype, lead=lead)
        p[f"r{gate}"] = layers._trunc_normal(gen, (*lead, n_heads, Dh, Dh),
                                             dtype, Dh ** -0.5)
    return p


def slstm_state_init(batch, n_heads, head_dim, dtype=torch.float32, *,
                     device="cpu", lead=()):
    shape = (*lead, batch, n_heads, head_dim)
    return {"h": torch.zeros(shape, dtype=dtype, device=device),
            "c": torch.zeros(shape, dtype=dtype, device=device),
            "n": torch.ones(shape, dtype=dtype, device=device),
            "m": torch.zeros(shape, dtype=dtype, device=device)}


def slstm_step(p, state, wx, n_heads, head_dim):
    """wx: dict gate -> (B, H*Dh) precomputed W x_t contributions."""
    H, Dh = n_heads, head_dim
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]

    def gate(name):
        rec = torch.einsum("bhd,hde->bhe", h, p[f"r{name}"].float())
        return wx[name].reshape(-1, H, Dh).float() + rec

    z = torch.tanh(gate("z"))
    it = gate("i")
    ft = gate("f") + 1.0
    o = torch.sigmoid(gate("o"))
    m_new = torch.maximum(F.logsigmoid(ft) + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(F.logsigmoid(ft) + m - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def slstm_scan_plain(wx, r, state):
    """Plain PyTorch version of the B8 kernel: the reference's step loop.
    wx: dict gate -> (B, T, H*Dh); r: dict gate -> (H, Dh, Dh); state
    {h, c, n, m} (B, H, Dh). Returns (h (B, T, H*Dh) f32, state)."""
    build.count(slstm_scan_plain, "calls")
    B, T, d = wx["z"].shape
    H, Dh = r["z"].shape[0], r["z"].shape[1]
    p = {f"r{g}": r[g] for g in _GATES}
    state = {key: state[key].float() for key in ("h", "c", "n", "m")}
    hs = []
    for t in range(T):
        state = slstm_step(p, state, {g: wx[g][:, t] for g in _GATES}, H, Dh)
        hs.append(state["h"])
    return torch.stack(hs, dim=1).reshape(B, T, d), state


#: Calls of the plain version since the count was last set to 0.
slstm_scan_plain.calls = 0


#: Most units a block of the B8 kernel takes (one per lane of a warp).
SLSTM_MAX_UNITS = 32


def slstm_cluster(head_dim: int) -> int:
    """Blocks per (batch row, head) of B8: the fewest that keep a block at
    <= `SLSTM_MAX_UNITS` units (6 at xlstm-125m's Dh 192, at most 8).
    Fewer ranks mean fewer stores a step and a faster exchange; the
    measurements behind the choice are in `csrc/slstm.cu`'s note."""
    return -(-head_dim // SLSTM_MAX_UNITS)


def _slstm_fn(name, nints):
    fn = getattr(build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [_P] * 17 + [_I] * nints + [_P]
        fn.restype = _I
    return fn


def _slstm_args(name, wx, r, state):
    """Checks B8's arguments; returns (wxs, rs, state tensors, B, T, H, Dh,
    dtype code)."""
    wxs = [wx[g] for g in _GATES]
    rs = [r[g] for g in _GATES]
    st = [state[key] for key in ("h", "c", "n", "m")]
    _check_cuda(name, *wxs, *rs, *st)
    B, T, d = wxs[0].shape
    H, Dh = rs[0].shape[0], rs[0].shape[1]
    if any(t.shape != (B, T, d) for t in wxs) or H * Dh != d \
            or any(t.shape != (H, Dh, Dh) for t in rs):
        raise ValueError("wx must be (B, T, H*Dh) and r (H, Dh, Dh), one "
                         "shape each")
    if wxs[0].dtype not in KERNEL_DTYPES \
            or any(t.dtype != wxs[0].dtype for t in wxs) \
            or rs[0].dtype not in KERNEL_DTYPES \
            or any(t.dtype != rs[0].dtype for t in rs):
        raise ValueError(f"wx and r must each have one dtype of "
                         f"{list(KERNEL_DTYPES)}")
    if not all(t.is_contiguous() for t in (*wxs, *rs)):
        raise ValueError(f"{name} takes contiguous wx and r")
    if not 1 <= Dh <= SLSTM_MAX_HEAD_DIM:
        raise ValueError(f"head size {Dh} outside 1..{SLSTM_MAX_HEAD_DIM}")
    if not B * T:
        raise ValueError(f"{name} takes non-empty inputs")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} clusters past the grid's 65,535")
    st = [t.float().contiguous() for t in st]
    if any(t.shape != (B, H, Dh) for t in st):
        raise ValueError(f"state tensors must be ({B}, {H}, {Dh})")
    code = KERNEL_DTYPES[wxs[0].dtype] * 2 + KERNEL_DTYPES[rs[0].dtype]
    return wxs, rs, st, B, T, H, Dh, code


def slstm_scan_cuda(wx, r, state):
    """Launch the B8 kernel on CUDA tensors, same arguments and results as
    `slstm_scan_plain`: the four wx contiguous (B, T, H*Dh) in one dtype
    of `KERNEL_DTYPES`, the four r contiguous (H, Dh, Dh) in one dtype of
    `KERNEL_DTYPES`, state f32; Dh <= 256. One cluster of
    `slstm_cluster(Dh)` blocks per (batch row, head). On the current
    stream, not synchronised."""
    wxs, rs, st, B, T, H, Dh, code = _slstm_args("slstm_scan_cuda", wx, r,
                                                 state)
    h = torch.empty((B, T, H * Dh), dtype=torch.float32,
                    device=wxs[0].device)
    out = [torch.empty_like(t) for t in st]
    with torch.cuda.device(h.device):
        err = _slstm_fn("slstm", 6)(
            *(t.data_ptr() for t in (*wxs, *rs, *st, h, *out)),
            B, T, H, Dh, code, slstm_cluster(Dh),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "slstm")
    build.count(slstm_scan_cuda)
    return h, dict(zip(("h", "c", "n", "m"), out))


#: Kernel launches since the count was last set to 0.
slstm_scan_cuda.launches = 0


def slstm_scan(wx, r, state):
    """The step loop where the tensors live: CPU tensors take
    `slstm_scan_plain`, CUDA tensors the kernel."""
    if wx["z"].device.type == "cpu":
        return slstm_scan_plain(wx, r, state)
    return slstm_scan_cuda(wx, r, state)


def slstm_apply(p, x, n_heads, state=None):
    """x: (B, T, d). True recurrence over T. Returns (y, state)."""
    B, T, d = x.shape
    H = n_heads
    Dh = d // H
    wx = {g: layers.dense_apply(p[f"w{g}"], x).contiguous() for g in _GATES}
    if state is None:
        state = slstm_state_init(B, H, Dh, device=x.device)
    h, state = slstm_scan(wx, {g: p[f"r{g}"].contiguous() for g in _GATES},
                          state)
    return layers.dense_apply(p["wo"], h.to(x.dtype)), state
