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

Both scans train: where autograd records a call, it goes through an
autograd Function — `MLSTMChunkScan` (B7 keeping each row's normaliser,
then B7-bwd, ``csrc/mlstm_chunk_bwd.cu``: three passes that mirror the
forward's) and `SLSTMScan` (B8 writing a per-step record, then B8-bwd,
``csrc/slstm_bwd.cu``: the cluster per head, stepping backwards, dh
reduce-scattered one way) — on CPU tensors through the plain passes and
the plain backwards (`mlstm_chunk_scan_bwd_plain`, `slstm_scan_bwd_plain`).
The backwards hold the stabilisers constant (see their notes below).

"meta" tensors (the dry run's, `launch.dryrun`) take the CUDA tensors'
route (`build.kernel_side`): each kernel wrapper allocates what its launch
would, launches nothing and counts no launch; while a counter is active
(`build.WORK`) every call, launched or traced, reports its work by the
kernel table's formula (`kernels.work`).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, work as kernel_work
from repro_torch.kernels.local_attention.local_attention import split3_plain
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
    """CUDA tensors (or the dry run's meta ones: `build.kernel_side`) on
    one device, none that autograd would record."""
    if not all(isinstance(t, torch.Tensor) and build.kernel_side(t)
               for t in tensors):
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
               dtype=torch.float32, *, lead=(), device=None):
    H, D = n_heads, head_dim

    def dense(i, o, bias=False):
        return layers.dense_init(gen, i, o, bias=bias, dtype=dtype, lead=lead,
                                 device=device)
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
    work = torch.zeros(wshape, dtype=k.dtype, device=k.device)
    work[..., :D, :D] = torch.einsum("bhcs,bhcsk,bhcsv->bhckv", a, kc, vc)
    work[..., D, :D] = torch.einsum("bhcs,bhcsk->bhck", a, kc)
    scal = torch.zeros(sshape, dtype=k.dtype, device=k.device)
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
    C = torch.zeros((B, H, D1, DP), dtype=work.dtype, device=work.device)
    C[..., :D, :D] = state["C"]
    C[..., D, :D] = state["n"]
    m = state["m"].to(work.dtype).clone()
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


def mlstm_chunk_outputs_plain(q, k, v, it, ft, work, scal, chunk: int, *,
                              with_dot: bool = False):
    """Plain PyTorch version of B7's third pass: every chunk's h from its
    q, k, v, gates and its incoming (C, n, m) in work / scal, the
    reference's chunk step (`mlstm_chunk_scan_plain`) over all chunks at
    once. Returns h (B, T, H*D) f32 and, `with_dot`, each row's normaliser
    dot_r = n_r . q_r (B, H, T) f32, what B7-bwd reads of the forward."""
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
    h = h.reshape(B, H, T, D).transpose(1, 2).reshape(B, T, H * D)
    return (h, dot.reshape(B, H, T)) if with_dot else h


mlstm_chunk_outputs_plain.calls = 0


def _ptr(t):
    """A tensor's address, or 0 (a null pointer: "not given") for None."""
    return 0 if t is None else t.data_ptr()


def _mlstm_fn(name, nargs, lib="mlstm_chunk"):
    fn = getattr(build.load(lib), name)
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
    if not k.is_meta:
        with torch.cuda.device(k.device):
            err = _mlstm_fn("mlstm_chunk_states_launch", (6, 11))(
                k.data_ptr(), v.data_ptr(), it.data_ptr(), ft.data_ptr(),
                work.data_ptr(), scal.data_ptr(), B, H, T, D, chunk,
                *k.stride()[:3], *it.stride(),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "mlstm_chunk_states")
        build.count(mlstm_chunk_states_cuda)
    if build.WORK is not None:
        build.WORK.kernel("mlstm_chunk_states", kernel_work.mlstm(
            B, H, T, D, chunk)["mlstm_chunk_states"])
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
    if not work.is_meta:
        with torch.cuda.device(work.device):
            err = _mlstm_fn("mlstm_state_scan_launch", (8, 4))(
                work.data_ptr(), scal.data_ptr(), C0.data_ptr(),
                n0.data_ptr(), m0.data_ptr(), C1.data_ptr(), n1.data_ptr(),
                m1.data_ptr(), B, H, nc, D,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "mlstm_state_scan")
        build.count(mlstm_state_scan_cuda)
    if build.WORK is not None:       # the pass's work is nc chunks' states
        build.WORK.kernel("mlstm_state_scan", kernel_work.mlstm(
            B, H, nc, D, 1)["mlstm_state_scan"])
    return {"C": C1, "n": n1, "m": m1}


mlstm_state_scan_cuda.launches = 0


def mlstm_chunk_outputs_cuda(q, k, v, it, ft, work, scal, chunk: int, *,
                             with_dot: bool = False):
    """Launch B7's third pass on CUDA tensors (as
    `mlstm_chunk_outputs_plain`; `with_dot` also writes each row's
    normaliser, for B7-bwd, and without it the launch is the serving
    paths' own). On the current stream, not synchronised."""
    B, H, T, D = _check_mlstm_inputs("mlstm_chunk_outputs_cuda", (q, k, v),
                                     it, ft, chunk)
    _check_work("mlstm_chunk_outputs_cuda", work, scal, B, H, T, D, chunk)
    h = torch.empty((B, T, H * D), dtype=torch.float32, device=q.device)
    dot = torch.empty((B, H, T), dtype=torch.float32, device=q.device) \
        if with_dot else None
    if not q.is_meta:
        with torch.cuda.device(q.device):
            err = _mlstm_fn("mlstm_chunk_outputs_launch", (9, 11))(
                *(t.data_ptr() for t in (q, k, v, it, ft, work, scal, h)),
                _ptr(dot), B, H, T, D, chunk, *q.stride()[:3],
                *it.stride(), torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "mlstm_chunk_outputs")
        build.count(mlstm_chunk_outputs_cuda)
    if build.WORK is not None:
        build.WORK.kernel("mlstm_chunk_outputs", kernel_work.mlstm(
            B, H, T, D, chunk)["mlstm_chunk_outputs"])
    return (h, dot) if with_dot else h


mlstm_chunk_outputs_cuda.launches = 0


def mlstm_chunk_scan_cuda(q, k, v, it, ft, state, chunk: int):
    """B7 on CUDA tensors, same arguments and results as
    `mlstm_chunk_scan_plain`: the three pass kernels in turn, through a
    scratch of `mlstm_work_bytes` bytes. q, k, v f32 (B, H, T, D) with unit
    stride along D and one set of strides for the three (the views
    `_mlstm_qkv_gates` makes qualify); it, ft f32 (B, H, T) with one set
    of strides; state f32; 1 <= chunk <= 64 dividing T; D <= 256. Where
    autograd records the call it goes through `MLSTMChunkScan` (the passes
    with each row's normaliser kept, and B7-bwd). On the current stream,
    not synchronised."""
    if build.records_grad(q, k, v, it, ft, *state.values()):
        return _mlstm_apply(q, k, v, it, ft, state, chunk)
    _check_cuda("mlstm_chunk_scan_cuda", q, k, v, it, ft,
                *(state[key] for key in ("C", "n", "m")))
    _check_mlstm_inputs("mlstm_chunk_scan_cuda", (q, k, v), it, ft, chunk)
    work, scal = mlstm_chunk_states_cuda(k, v, it, ft, chunk)
    state = mlstm_state_scan_cuda(work, scal, state)
    return mlstm_chunk_outputs_cuda(q, k, v, it, ft, work, scal,
                                    chunk), state


# ---------------------------------------------------------------------------
# B7-bwd: the chunkwise mLSTM's backward, three passes that mirror the
# forward's (`csrc/mlstm_chunk_bwd.cu`), each with a plain version below.
#
# The stabiliser carries no gradient. With the carried state read as
# C~ = C e^m, n~ = n e^m, every row's output is h_r = X_r / max(|Y_r|,
# e^{-b_r}), where X_r = h~_r e^{M_r} and Y_r = dot_r e^{M_r} do not
# depend on M_r: no output depends on the value a max picks. So the
# backward holds every max output (M_r, M_c) constant and keeps every
# other path: the carried m' = b_last + M_c passes its gradient to the
# chunk's f~ through b_last; the incoming m enters sigma_r = exp(m - M_r)
# and alpha = exp(m - M_c); the denominator's branch exp(-(b_r + M_r))
# gives b_r a gradient on the rows where it wins. The one path this drops
# that can carry a gradient is a gradient of the final state itself:
# shifting the state's gauge, (C, n, m) -> (C e^-d, n e^-d, m + d),
# changes no output but moves (C1, n1, m1) unless their gradient has no
# gauge part g = dm1 - <dC1, C1> - <dn1, n1>. That part is added back
# through the chunks' M_c: chunk c's free derivative along M_c is g_c,
# with g_{nc-1} = g and g_{c-1} = g_c where the carried m wins M_c =
# max(m, G_c) (else 0), and it goes to m where m wins and to w at argmax
# G_c where G_c does. The sum is the exact gradient; a tie of a max (of
# measure zero) goes to m, and to the denominator's |dot| branch. In
# training the final state has no gradient and g = 0.
#
# Scratch: the forward's (work, scal) with each chunk's incoming (C, n, m)
# and each row's dot_r (B, H, T); `dwork` (laid out like work: chunk c's
# own state gradient dC_own, dn_own from its outputs, then, after the
# reverse scan, the gradient at chunk c's end state dC_out, dn_out) and
# `dscal` (B, H, nc, 4): dm_own, X_c = <dC_out, C_in> + <dn_out, n_in>,
# g_c, 0.
# ---------------------------------------------------------------------------

def _rows(x, B, H, nc, L, D):
    """(B, T, H*D) -> (B, H, nc, L, D)."""
    return x.reshape(B, nc * L, H, D).transpose(1, 2).reshape(B, H, nc, L, D)


def _bwd_rows(dot, it, ft, scal, chunk):
    """What both chunk-parallel backward passes recompute per row: b, w,
    M_r, sigma_r, dot_r, the denominator and whether |dot_r| won it."""
    b, w = _gate_scan(it, ft, chunk)
    m0 = scal[..., 2]
    M = torch.maximum(m0[..., None], torch.cummax(w, dim=-1).values)
    sig = torch.exp(m0[..., None] - M)
    dot = dot.reshape(b.shape)
    floor = torch.exp(-(b + M))
    return b, w, M, sig, dot, torch.maximum(dot.abs(), floor), \
        dot.abs() >= floor


def _bwd_out_side(dh, h, dot, on_dot, den, B, H, nc, L, D):
    """dh~_r = dh_r / den_r; d den_r = -<dh~_r, h_r>, routed to dot_r
    (times sign(dot_r)) or, on the floor branch, to b_r as <dh_r, h_r>."""
    dht = _rows(dh, B, H, nc, L, D) / den[..., None]
    dden = -(dht * _rows(h, B, H, nc, L, D)).sum(-1)
    ddot = torch.where(on_dot, dden * torch.sign(dot), 0.0)
    dbden = torch.where(on_dot, 0.0, -dden * den)
    return dht, ddot, dbden


def mlstm_bwd_outputs_plain(q, dh, h, dot, it, ft, work, scal, chunk: int):
    """Plain PyTorch version of B7-bwd's first pass: per (b, head, chunk),
    from dh, h and dot_r, the gradient of the chunk's incoming state
    through the chunk's own outputs — dC_own = sum_r sigma_r q_r dh~_r^T
    and dn_own = sum_r sigma_r ddot_r q_r into dwork (laid out like work,
    zero past column D), dm_own = sum_r sigma_r dsigma_r into dscal[...,
    0] (dscal[..., 1:] = 0), where dsigma_r = <dh~_r, q_r C_in> + ddot_r
    (n_in . q_r), so that dm_own = <C_in, dC_own> + <n_in, dn_own>. dh
    (B, T, H*D); h, dot as the forward left them. Returns (dwork,
    dscal)."""
    build.count(mlstm_bwd_outputs_plain, "calls")
    B, H, T, D = q.shape
    nc, L = T // chunk, chunk
    _, _, _, sig, dot, den, on_dot = _bwd_rows(dot, it, ft, scal, chunk)
    dht, ddot, _ = _bwd_out_side(dh, h, dot, on_dot, den, B, H, nc, L, D)
    qc = q.reshape(B, H, nc, L, D)
    sq = sig[..., None] * qc
    dwork = torch.zeros_like(work)
    dwork[..., :D, :D] = torch.einsum("bhcrd,bhcrv->bhcdv", sq, dht)
    dwork[..., D, :D] = torch.einsum("bhcr,bhcrd->bhcd", ddot, sq)
    dscal = torch.zeros_like(scal)
    dscal[..., 0] = (work[..., :D + 1, :D] * dwork[..., :D + 1, :D]).sum(
        (-2, -1))
    return dwork, dscal


mlstm_bwd_outputs_plain.calls = 0


def mlstm_bwd_scan_plain(dwork, dscal, work, scal, dC1, dn1, gauge):
    """Plain PyTorch version of B7-bwd's second pass, in place like the
    kernel: walks the chunks from the last to the first from the final
    state's gradient (dC1, dn1; None counts as zero), dC_in(c) =
    exp(m_c - M_c) dC_out(c) + dC_own(c), leaving dC_out(c), dn_out(c) in
    dwork, X_c in dscal[..., 1] and the gauge gradient g_c (from `gauge`
    (B, H) at the last chunk; None counts as zero) in dscal[..., 2].
    Returns the initial state's (dC0, dn0)."""
    build.count(mlstm_bwd_scan_plain, "calls")
    B, H, nc, D1, DP = dwork.shape
    D = D1 - 1
    dC = torch.zeros((B, H, D1, DP), dtype=dwork.dtype, device=dwork.device)
    if dC1 is not None:
        dC[..., :D, :D] = dC1
    if dn1 is not None:
        dC[..., D, :D] = dn1
    g = torch.zeros((B, H), dtype=dwork.dtype, device=dwork.device) \
        if gauge is None else gauge.to(dwork.dtype).clone()
    for c in reversed(range(nc)):
        G, m = scal[:, :, c, 1], scal[:, :, c, 2]
        alpha = torch.exp(m - torch.maximum(m, G))[..., None, None]
        own = dwork[:, :, c].clone()
        dwork[:, :, c] = dC
        dscal[:, :, c, 1] = (dC * work[:, :, c]).sum((-2, -1))
        dscal[:, :, c, 2] = g
        dC = alpha * dC + own
        g = torch.where(m >= G, g, 0.0)
    return dC[..., :D, :D].contiguous(), dC[..., D, :D].contiguous()


mlstm_bwd_scan_plain.calls = 0


def mlstm_bwd_inputs_plain(q, k, v, it, ft, dh, h, dot, work, scal, dwork,
                           dscal, dm1, chunk: int):
    """Plain PyTorch version of B7-bwd's third pass: per (b, head, chunk),
    dq, dk, dv from the intra-chunk products (S = q k^T recomputed, dP =
    dh~ v^T + ddot_r) and the state terms (C_in, n_in for dq; the
    chunk-end gradient dC_out, dn_out for dk, dv); di_s = dw_s, and df the
    reverse cumsum of db_s = -dw_s (plus the floor branch's gradient, and
    on the last row the next chunk's m-gradient, through b_last); and the
    initial m's gradient. dm1 (B, H) or None. Returns (dq, dk, dv (B, H,
    T, D), dit, dft (B, H, T), dm0 (B, H))."""
    build.count(mlstm_bwd_inputs_plain, "calls")
    B, H, T, D = q.shape
    nc, L = T // chunk, chunk
    _, w, M, sig, dot, den, on_dot = _bwd_rows(dot, it, ft, scal, chunk)
    dht, ddot, dbden = _bwd_out_side(dh, h, dot, on_dot, den, B, H, nc, L,
                                     D)
    qc, kc, vc = (x.reshape(B, H, nc, L, D) for x in (q, k, v))
    a, Dw = _bwd_decays(w, M, scal, L)
    P = Dw * torch.einsum("bhcrd,bhcsd->bhcrs", qc, kc)
    dP = torch.einsum("bhcrd,bhcsd->bhcrs", dht, vc) + ddot[..., None]
    dS = dP * Dw
    dCo, dno = dwork[..., :D, :D], dwork[..., D, :D]
    u = torch.einsum("bhcde,bhcse->bhcsd", dCo, vc) + dno[..., None, :]
    dv = torch.einsum("bhcrs,bhcrd->bhcsd", P, dht) \
        + a[..., None] * torch.einsum("bhcsd,bhcdv->bhcsv", kc, dCo)
    dk = torch.einsum("bhcrs,bhcrd->bhcsd", dS, qc) + a[..., None] * u
    dq = torch.einsum("bhcrs,bhcsd->bhcrd", dS, kc) + sig[..., None] * (
        torch.einsum("bhcrv,bhcdv->bhcrd", dht, work[..., :D, :D])
        + ddot[..., None] * work[..., None, D, :D])
    return (dq.reshape(B, H, T, D), dk.reshape(B, H, T, D),
            dv.reshape(B, H, T, D),
            *_bwd_gates((dP * P).sum(-2), a * (u * kc).sum(-1), w, dbden,
                        scal, dscal, dm1))


def _bwd_decays(w, M, scal, L):
    """a_s = exp(w_s - M_c) and the masked weights exp(w_s - M_r) (s <=
    r; 0 above the diagonal), (B, H, nc, L) and (B, H, nc, L, L)."""
    Mc = torch.maximum(scal[..., 2], scal[..., 1])
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=w.device))
    return torch.exp(w - Mc[..., None]), \
        torch.where(mask, torch.exp(w[..., None, :] - M[..., :, None]), 0.0)


def _bwd_gates(dPP, ada, w, dbden, scal, dscal, dm1):
    """The gate gradients from the intra-chunk term sum_r dP P (dPP, P
    zero above the diagonal) and a_s da_s (ada), each (B, H, nc, L): dw
    (+ the gauge gradient at argmax G where G wins M_c), df the reverse
    cumsum of dbden - dw with the next chunk's dm_in on the last row, and
    the initial m's gradient. Returns (dit, dft (B, H, T), dm0 (B, H))."""
    B, H, nc, L = w.shape
    G, m0 = scal[..., 1], scal[..., 2]
    Mc = torch.maximum(m0, G)
    g = dscal[..., 2]
    mwin = m0 >= G
    dw = dPP + ada + torch.where(mwin, 0.0, g)[..., None] \
        * F.one_hot(w.argmax(-1), L).to(w.dtype)
    dm_in = torch.exp(m0 - Mc) * dscal[..., 1] + dscal[..., 0] \
        + torch.where(mwin, g, 0.0)
    last = torch.zeros_like(dm_in[..., :1]) if dm1 is None \
        else dm1[..., None].to(dm_in.dtype)
    db = dbden - dw
    db[..., -1] += torch.cat([dm_in[..., 1:], last], dim=-1)
    df = torch.flip(torch.cumsum(torch.flip(db, (-1,)), -1), (-1,))
    return dw.reshape(B, H, nc * L), df.reshape(B, H, nc * L), dm_in[..., 0]


mlstm_bwd_inputs_plain.calls = 0


def mlstm_gauge(dC1, dn1, dm1, C1, n1):
    """The gauge part of the final state's gradient, dm1 - <dC1, C1> -
    <dn1, n1> (B, H), each None counting as zero; None when all three
    are."""
    if dC1 is None and dn1 is None and dm1 is None:
        return None
    g = torch.zeros_like(C1[..., 0, 0]) if dm1 is None else dm1.clone()
    if dC1 is not None:
        g -= (dC1 * C1).sum((-2, -1))
    if dn1 is not None:
        g -= (dn1 * n1).sum(-1)
    return g


def mlstm_chunk_scan_bwd_plain(q, k, v, it, ft, h, dot, work, scal, C1, n1,
                               dh, dC1, dn1, dm1, chunk: int):
    """B7-bwd's plain version: the three plain passes in turn. The
    forward's q, k, v, it, ft, its outputs h and final (C1, n1), the dot
    and (work, scal) its passes left; dh (B, T, H*D) and the final state's
    gradients (each None or a tensor). Returns (dq, dk, dv, dit, dft, dC0,
    dn0, dm0)."""
    dwork, dscal = mlstm_bwd_outputs_plain(q, dh, h, dot, it, ft, work,
                                           scal, chunk)
    dC0, dn0 = mlstm_bwd_scan_plain(dwork, dscal, work, scal, dC1, dn1,
                                    mlstm_gauge(dC1, dn1, dm1, C1, n1))
    dq, dk, dv, dit, dft, dm0 = mlstm_bwd_inputs_plain(
        q, k, v, it, ft, dh, h, dot, work, scal, dwork, dscal, dm1, chunk)
    return dq, dk, dv, dit, dft, dC0, dn0, dm0


# B7's and B7-bwd's kernels form the products of their passes 1 and 3 on
# the tensor cores at f32 accuracy: every f32 operand cut into three bf16
# pieces, each product the six piece products a_i b_j with i + j <= 2 of 16
# rows of K at a time, added to one f32 accumulator (`csrc/mlstm_chunk.cu`
# on wgmma, `csrc/mlstm_chunk_bwd.cu` on mma.sync). The plain versions
# below repeat that arithmetic in the kernels' order, so that the CPU tests
# can hold it against the reference.

#: The piece products the kernels keep, (a_i, b_j) in the order they are
#: added: the small terms first.
PIECE_PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def pieces3_matmul_plain(a, b, acc=None):
    """acc + a @ b ((..., M, K) x (..., K, N), f32) as B7-bwd's kernels
    form it: both operands cut into three bf16 pieces (`split3_plain`),
    and for each 16 rows of K the six kept piece products (`PIECE_PAIRS`,
    each exact in f32) added in that order to the f32 accumulator (zero
    when `acc` is None)."""
    ap = [x.float() for x in split3_plain(a.float())]
    bp = [x.float() for x in split3_plain(b.float())]
    out = torch.zeros(torch.broadcast_shapes(a.shape[:-1] + (1,),
                                             b.shape[:-2] + (1, b.shape[-1])),
                      dtype=torch.float32, device=a.device) \
        if acc is None else acc
    for k0 in range(0, a.shape[-1], 16):
        ks = slice(k0, k0 + 16)
        for i, j in PIECE_PAIRS:
            out = out + ap[i][..., ks] @ bp[j][..., ks, :]
    return out


def mlstm_chunk_states_split_plain(k, v, it, ft, chunk: int):
    """B7's first pass as its kernel computes it (arguments and results of
    `mlstm_chunk_states_plain`): a_s k_s with a_s = exp(w_s - G) in f32,
    dC = (a k)^T v by `pieces3_matmul_plain`, dn = sum_s a_s k_s on the
    FMA units."""
    B, H, T, D = k.shape
    wshape, sshape = mlstm_work_shapes(B, H, T, D, chunk)
    nc = wshape[2]
    b, w = _gate_scan(it, ft, chunk)
    G = w.max(dim=-1).values
    ak = torch.exp(w - G[..., None])[..., None] \
        * k.reshape(B, H, nc, chunk, D)
    work = torch.zeros(wshape, dtype=k.dtype, device=k.device)
    work[..., :D, :D] = pieces3_matmul_plain(
        ak.transpose(-1, -2), v.reshape(B, H, nc, chunk, D))
    work[..., D, :D] = ak.sum(-2)
    scal = torch.zeros(sshape, dtype=k.dtype, device=k.device)
    scal[..., 0] = b[..., -1]
    scal[..., 1] = G
    return work, scal


def mlstm_chunk_outputs_split_plain(q, k, v, it, ft, work, scal, chunk: int,
                                    *, with_dot: bool = False):
    """B7's third pass as its kernel computes it (arguments and results of
    `mlstm_chunk_outputs_plain`): S = q k^T and q C_in by
    `pieces3_matmul_plain`, P = mask exp(w_s - M_r) S, P v added by it to
    the accumulator scale_r (q C_in); dot_r = scale_r (n_in . q_r) +
    sum_s P[r, s], the denominator's reciprocal and h = h~ times it on the
    FMA units."""
    B, H, T, D = q.shape
    nc = T // chunk
    b, w = _gate_scan(it, ft, chunk)
    m0 = scal[..., 2]
    M = torch.maximum(m0[..., None], torch.cummax(w, dim=-1).values)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    Dw = torch.where(mask, torch.exp(w[..., None, :] - M[..., :, None]), 0.0)
    qc, kc, vc = (x.reshape(B, H, nc, chunk, D) for x in (q, k, v))
    P = Dw * pieces3_matmul_plain(qc, kc.transpose(-1, -2))
    scale = torch.exp(m0[..., None] - M)
    inter = pieces3_matmul_plain(qc, work[..., :D, :D]) * scale[..., None]
    h_tilde = pieces3_matmul_plain(P, vc, inter)
    dot = scale * torch.einsum("bhcrd,bhcd->bhcr", qc, work[..., D, :D]) \
        + P.sum(-1)
    rden = 1.0 / torch.maximum(dot.abs(), torch.exp(-(b + M)))
    h = (h_tilde * rden[..., None]).reshape(B, H, T, D).transpose(1, 2) \
        .reshape(B, T, H * D)
    return (h, dot.reshape(B, H, T)) if with_dot else h


def mlstm_bwd_outputs_split_plain(q, dh, h, dot, it, ft, work, scal,
                                  chunk: int):
    """B7-bwd's first pass as its kernel computes it (arguments and
    results of `mlstm_bwd_outputs_plain`): dC_own = (sigma_r / den_r .
    q)^T dh by `pieces3_matmul_plain`, dn_own = sum_r sigma_r ddot_r q_r
    on the FMA units."""
    B, H, T, D = q.shape
    nc, L = T // chunk, chunk
    _, _, _, sig, dot, den, on_dot = _bwd_rows(dot, it, ft, scal, chunk)
    dhr = _rows(dh, B, H, nc, L, D)
    hh = (dhr * _rows(h, B, H, nc, L, D)).sum(-1)
    rden = 1.0 / den
    ddot = torch.where(on_dot, -hh * rden * torch.sign(dot), 0.0)
    qc = q.reshape(B, H, nc, L, D)
    dwork = torch.zeros_like(work)
    dwork[..., :D, :D] = pieces3_matmul_plain(
        ((sig * rden)[..., None] * qc).transpose(-1, -2), dhr)
    dwork[..., D, :D] = torch.einsum("bhcr,bhcrd->bhcd", sig * ddot, qc)
    dscal = torch.zeros_like(scal)
    dscal[..., 0] = (work[..., :D + 1, :D] * dwork[..., :D + 1, :D]).sum(
        (-2, -1))
    return dwork, dscal


def mlstm_bwd_inputs_split_plain(q, k, v, it, ft, dh, h, dot, work, scal,
                                 dwork, dscal, dm1, chunk: int):
    """B7-bwd's third pass as its kernel computes it (arguments and
    results of `mlstm_bwd_inputs_plain`), every product by
    `pieces3_matmul_plain`: S = q k^T and dh v^T; dP = that / den_r +
    ddot_r; dv = a_s (k dC_out) then + (P / den)^T dh into the same
    accumulator; dk: u = v dC_out^T + dn_out, da_s = <u_s, k_s>, a_s u
    then + dS^T q; dq: sigma_r (dh C_in^T / den_r + ddot_r n_in) then +
    dS k."""
    B, H, T, D = q.shape
    nc, L = T // chunk, chunk
    _, w, M, sig, dot, den, on_dot = _bwd_rows(dot, it, ft, scal, chunk)
    dhr = _rows(dh, B, H, nc, L, D)
    hh = (dhr * _rows(h, B, H, nc, L, D)).sum(-1)
    rden = 1.0 / den
    ddot = torch.where(on_dot, -hh / den * torch.sign(dot), 0.0)
    dbden = torch.where(on_dot, 0.0, hh)
    qc, kc, vc = (x.reshape(B, H, nc, L, D) for x in (q, k, v))
    a, Dw = _bwd_decays(w, M, scal, L)
    S = pieces3_matmul_plain(qc, kc.transpose(-1, -2))
    dP = rden[..., None] * pieces3_matmul_plain(dhr, vc.transpose(-1, -2)) \
        + ddot[..., None]
    P = Dw * S
    dS = dP * Dw
    dCo, dno = dwork[..., :D, :D], dwork[..., D, :D]
    dv = pieces3_matmul_plain((P * rden[..., None]).transpose(-1, -2), dhr,
                              a[..., None] * pieces3_matmul_plain(kc, dCo))
    u = pieces3_matmul_plain(vc, dCo.transpose(-1, -2)) + dno[..., None, :]
    dk = pieces3_matmul_plain(dS.transpose(-1, -2), qc, a[..., None] * u)
    dq = pieces3_matmul_plain(dS, kc, sig[..., None] * (
        rden[..., None] * pieces3_matmul_plain(
            dhr, work[..., :D, :D].transpose(-1, -2))
        + ddot[..., None] * work[..., None, D, :D]))
    return (dq.reshape(B, H, T, D), dk.reshape(B, H, T, D),
            dv.reshape(B, H, T, D),
            *_bwd_gates((dP * P).sum(-2), a * (u * kc).sum(-1), w, dbden,
                        scal, dscal, dm1))


def mlstm_chunk_scan_bwd_split_plain(q, k, v, it, ft, h, dot, work, scal,
                                     C1, n1, dh, dC1, dn1, dm1, chunk: int):
    """B7-bwd's arithmetic as its kernels compute it (arguments and
    results of `mlstm_chunk_scan_bwd_plain`): the two split passes around
    the plain reverse scan."""
    dwork, dscal = mlstm_bwd_outputs_split_plain(q, dh, h, dot, it, ft,
                                                 work, scal, chunk)
    dC0, dn0 = mlstm_bwd_scan_plain(dwork, dscal, work, scal, dC1, dn1,
                                    mlstm_gauge(dC1, dn1, dm1, C1, n1))
    dq, dk, dv, dit, dft, dm0 = mlstm_bwd_inputs_split_plain(
        q, k, v, it, ft, dh, h, dot, work, scal, dwork, dscal, dm1, chunk)
    return dq, dk, dv, dit, dft, dC0, dn0, dm0


def _check_bwd(name, q, dh, h, dot, it, ft, work, scal, chunk):
    """B7-bwd's shared checks: q, it, ft, work, scal as the forward's
    passes take them; dh, h contiguous f32 (B, T, H*D), dot (B, H, T)."""
    B, H, T, D = _check_mlstm_inputs(name, (q,), it, ft, chunk)
    _check_work(name, work, scal, B, H, T, D, chunk)
    _check_cuda(name, q, dh, h, dot)
    if dh.shape != (B, T, H * D) or h.shape != dh.shape \
            or dot.shape != (B, H, T) \
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   for t in (dh, h, dot)):
        raise ValueError(f"{name}: dh and h must be contiguous float32 "
                         f"({B}, {T}, {H * D}) and dot ({B}, {H}, {T})")
    return B, H, T, D


def mlstm_bwd_outputs_cuda(q, dh, h, dot, it, ft, work, scal, chunk: int):
    """Launch B7-bwd's first pass on CUDA tensors (as
    `mlstm_bwd_outputs_plain`). On the current stream, not
    synchronised."""
    name = "mlstm_bwd_outputs_cuda"
    B, H, T, D = _check_bwd(name, q, dh, h, dot, it, ft, work, scal, chunk)
    dwork, dscal = torch.empty_like(work), torch.empty_like(scal)
    if not q.is_meta:
        with torch.cuda.device(q.device):
            err = _mlstm_fn("mlstm_bwd_outputs_launch", (10, 11),
                            "mlstm_chunk_bwd")(
                q.data_ptr(), dh.data_ptr(), h.data_ptr(), dot.data_ptr(),
                it.data_ptr(), ft.data_ptr(), work.data_ptr(),
                scal.data_ptr(), dwork.data_ptr(), dscal.data_ptr(), B, H,
                T, D, chunk, *q.stride()[:3], *it.stride(),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "mlstm_bwd_outputs")
        build.count(mlstm_bwd_outputs_cuda)
    if build.WORK is not None:
        build.WORK.kernel("mlstm_bwd_outputs", kernel_work.mlstm_bwd(
            B, H, T, D, chunk)["mlstm_bwd_outputs"])
    return dwork, dscal


mlstm_bwd_outputs_cuda.launches = 0


def mlstm_bwd_scan_cuda(dwork, dscal, work, scal, dC1, dn1, gauge):
    """Launch B7-bwd's second pass on CUDA tensors (as
    `mlstm_bwd_scan_plain`: dwork and dscal rewritten in place; X_c summed
    with float atomics, in an order that varies from call to call).
    Returns (dC0, dn0). On the current stream, not synchronised."""
    name = "mlstm_bwd_scan_cuda"
    B, H, nc, D1, _ = work.shape
    D = D1 - 1
    _check_work(name, work, scal, B, H, nc, D, 1)
    _check_work(name, dwork, dscal, B, H, nc, D, 1)
    given = [t.float().contiguous() if t is not None else None
             for t in (dC1, dn1, gauge)]
    for t, shape in zip(given, ((B, H, D, D), (B, H, D), (B, H))):
        if t is not None:
            _check_cuda(name, work, t)
            if t.shape != shape:
                raise ValueError(f"{name}: dC1, dn1, gauge must be "
                                 f"({B}, {H}, {D}, {D}), ({B}, {H}, {D}), "
                                 f"({B}, {H})")
    dC0 = torch.empty((B, H, D, D), dtype=torch.float32, device=work.device)
    dn0 = torch.empty((B, H, D), dtype=torch.float32, device=work.device)
    if not work.is_meta:
        with torch.cuda.device(work.device):
            err = _mlstm_fn("mlstm_bwd_scan_launch", (9, 4),
                            "mlstm_chunk_bwd")(
                dwork.data_ptr(), dscal.data_ptr(), work.data_ptr(),
                scal.data_ptr(), *(_ptr(t) for t in given), dC0.data_ptr(),
                dn0.data_ptr(), B, H, nc, D,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "mlstm_bwd_scan")
        build.count(mlstm_bwd_scan_cuda)
    if build.WORK is not None:       # the pass's work is nc chunks' states
        build.WORK.kernel("mlstm_bwd_scan", kernel_work.mlstm_bwd(
            B, H, nc, D, 1)["mlstm_bwd_scan"])
    return dC0, dn0


mlstm_bwd_scan_cuda.launches = 0


def mlstm_bwd_inputs_cuda(q, k, v, it, ft, dh, h, dot, work, scal, dwork,
                          dscal, dm1, chunk: int):
    """Launch B7-bwd's third pass on CUDA tensors (as
    `mlstm_bwd_inputs_plain`); dq, dk, dv come out with q's strides, dit,
    dft with it's. On the current stream, not synchronised."""
    name = "mlstm_bwd_inputs_cuda"
    B, H, T, D = _check_mlstm_inputs(name, (q, k, v), it, ft, chunk)
    _check_bwd(name, q, dh, h, dot, it, ft, work, scal, chunk)
    _check_work(name, dwork, dscal, B, H, T, D, chunk)
    if dm1 is not None:
        dm1 = dm1.float().contiguous()
        _check_cuda(name, q, dm1)
        if dm1.shape != (B, H):
            raise ValueError(f"{name}: dm1 must be ({B}, {H})")
    dq, dk, dv = (torch.empty_strided(q.shape, q.stride(),
                                      dtype=torch.float32, device=q.device)
                  for _ in range(3))
    dit, dft = (torch.empty_strided(it.shape, it.stride(),
                                    dtype=torch.float32, device=q.device)
                for _ in range(2))
    dm0 = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if not q.is_meta:
        with torch.cuda.device(q.device):
            err = _mlstm_fn("mlstm_bwd_inputs_launch", (19, 11),
                            "mlstm_chunk_bwd")(
                *(t.data_ptr() for t in (q, k, v, it, ft, dh, h, dot, work,
                                         scal, dwork, dscal)), _ptr(dm1),
                *(t.data_ptr() for t in (dq, dk, dv, dit, dft, dm0)),
                B, H, T, D, chunk, *q.stride()[:3], *it.stride(),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "mlstm_bwd_inputs")
        build.count(mlstm_bwd_inputs_cuda)
    if build.WORK is not None:
        build.WORK.kernel("mlstm_bwd_inputs", kernel_work.mlstm_bwd(
            B, H, T, D, chunk)["mlstm_bwd_inputs"])
    return dq, dk, dv, dit, dft, dm0


mlstm_bwd_inputs_cuda.launches = 0


def mlstm_chunk_scan_bwd_cuda(q, k, v, it, ft, h, dot, work, scal, C1, n1,
                              dh, dC1, dn1, dm1, chunk: int):
    """B7-bwd on CUDA tensors, same arguments and results as
    `mlstm_chunk_scan_bwd_plain`: the three pass kernels in turn, through
    a scratch like the forward's (work, scal). On the current stream, not
    synchronised."""
    dh = dh.float().contiguous()
    dwork, dscal = mlstm_bwd_outputs_cuda(q, dh, h, dot, it, ft, work, scal,
                                          chunk)
    dC0, dn0 = mlstm_bwd_scan_cuda(dwork, dscal, work, scal, dC1, dn1,
                                   mlstm_gauge(dC1, dn1, dm1, C1, n1))
    dq, dk, dv, dit, dft, dm0 = mlstm_bwd_inputs_cuda(
        q, k, v, it, ft, dh, h, dot, work, scal, dwork, dscal, dm1, chunk)
    return dq, dk, dv, dit, dft, dC0, dn0, dm0


class MLSTMChunkScan(torch.autograd.Function):
    """B7 with its backward: on CUDA tensors the three pass kernels (the
    outputs pass keeping each row's dot_r) and B7-bwd, on CPU tensors the
    plain passes and `mlstm_chunk_scan_bwd_plain`. Everything the backward
    reads goes through `ctx.save_for_backward` (q, k, v, it, ft, h, dot,
    the scratch (work, scal) with each chunk's incoming state, and the
    final C1, n1), so a non-reentrant checkpoint may run the forward
    again. `apply(q, k, v, it, ft, C0, n0, m0, chunk) -> (h, C1, n1,
    m1)`."""

    @staticmethod
    def forward(ctx, q, k, v, it, ft, C0, n0, m0, chunk):
        state = {"C": C0, "n": n0, "m": m0}
        if build.kernel_side(q):
            work, scal = mlstm_chunk_states_cuda(k, v, it, ft, chunk)
            st = mlstm_state_scan_cuda(work, scal, state)
            h, dot = mlstm_chunk_outputs_cuda(q, k, v, it, ft, work, scal,
                                              chunk, with_dot=True)
        else:
            work, scal = mlstm_chunk_states_plain(k, v, it, ft, chunk)
            st = mlstm_state_scan_plain(work, scal, state)
            h, dot = mlstm_chunk_outputs_plain(q, k, v, it, ft, work, scal,
                                               chunk, with_dot=True)
        ctx.save_for_backward(q, k, v, it, ft, h, dot, work, scal, st["C"],
                              st["n"])
        ctx.chunk = chunk
        # An output nobody differentiates keeps a None gradient (no zeros
        # made, and no gauge term).
        ctx.set_materialize_grads(False)
        return h, st["C"], st["n"], st["m"]

    @staticmethod
    def backward(ctx, dh, dC1, dn1, dm1):
        q, k, v, it, ft, h, dot, work, scal, C1, n1 = ctx.saved_tensors
        bwd = mlstm_chunk_scan_bwd_cuda if build.kernel_side(q) \
            else mlstm_chunk_scan_bwd_plain
        if dh is None:
            dh = torch.zeros_like(h)
        grads = bwd(q, k, v, it, ft, h, dot, work, scal, C1, n1, dh, dC1,
                    dn1, dm1, ctx.chunk)
        return (*grads, None)


def _mlstm_apply(q, k, v, it, ft, state, chunk):
    h, C1, n1, m1 = MLSTMChunkScan.apply(
        q, k, v, it, ft, *(state[key] for key in ("C", "n", "m")), chunk)
    return h, {"C": C1, "n": n1, "m": m1}


def mlstm_chunk_scan(q, k, v, it, ft, state, chunk: int):
    """The chunk loop where the tensors live: where autograd records the
    call, `MLSTMChunkScan` (kernels or plain passes, with their backward);
    elsewhere CPU tensors take `mlstm_chunk_scan_plain`, CUDA tensors the
    kernel."""
    if build.records_grad(q, k, v, it, ft, *state.values()):
        return _mlstm_apply(q, k, v, it, ft, state, chunk)
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
               lead=(), device=None):
    if d_model % n_heads:
        raise ValueError("d_model must divide n_heads")
    Dh = d_model // n_heads
    # As in the reference, the output gate's input weights "wo" (with
    # bias) are also the block's output projection (`slstm_apply`): its
    # loop over the gates overwrites the projection it made first.
    p = {}
    for gate in _GATES:
        p[f"w{gate}"] = layers.dense_init(gen, d_model, d_model, bias=True,
                                          dtype=dtype, lead=lead,
                                          device=device)
        p[f"r{gate}"] = layers._trunc_normal(gen, (*lead, n_heads, Dh, Dh),
                                             dtype, Dh ** -0.5, device)
    return p


def slstm_state_init(batch, n_heads, head_dim, dtype=torch.float32, *,
                     device="cpu", lead=()):
    shape = (*lead, batch, n_heads, head_dim)
    return {"h": torch.zeros(shape, dtype=dtype, device=device),
            "c": torch.zeros(shape, dtype=dtype, device=device),
            "n": torch.ones(shape, dtype=dtype, device=device),
            "m": torch.zeros(shape, dtype=dtype, device=device)}


def _wide(x):
    """x in f32, or in f64 when it is f64 (the plain versions' f64
    witnesses)."""
    return x if x.dtype == torch.float64 else x.float()


def _slstm_cell(pz, pi, pf, po, c, n, m):
    """The sLSTM cell from its four pre-activations: (h, c, n, m) new."""
    z = torch.tanh(pz)
    it = pi
    ft = pf + 1.0
    o = torch.sigmoid(po)
    m_new = torch.maximum(F.logsigmoid(ft) + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(F.logsigmoid(ft) + m - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def _slstm_pre(p, h, wx, H, Dh):
    """The four pre-activations wx_g + h R_g (B, H, Dh)."""
    def gate(name):
        rec = torch.einsum("bhd,hde->bhe", h, _wide(p[f"r{name}"]))
        return _wide(wx[name].reshape(-1, H, Dh)) + rec
    return [gate(g) for g in _GATES]


def slstm_step(p, state, wx, n_heads, head_dim):
    """wx: dict gate -> (B, H*Dh) precomputed W x_t contributions."""
    h, c, n, m = _slstm_cell(*_slstm_pre(p, state["h"], wx, n_heads,
                                         head_dim),
                             state["c"], state["n"], state["m"])
    return {"h": h, "c": c, "n": n, "m": m}


#: Rows of B8's per-step record for its backward: the four pre-activations
#: (z, i, f before its + 1, o), then the new c, n, m.
SLSTM_SAVED = 7


def slstm_scan_plain(wx, r, state, *, with_saved: bool = False):
    """Plain PyTorch version of the B8 kernel: the reference's step loop.
    wx: dict gate -> (B, T, H*Dh); r: dict gate -> (H, Dh, Dh); state
    {h, c, n, m} (B, H, Dh). Returns (h (B, T, H*Dh) f32, state) and,
    `with_saved`, the record B8-bwd reads (B, T, `SLSTM_SAVED`, H*Dh)."""
    build.count(slstm_scan_plain, "calls")
    B, T, d = wx["z"].shape
    H, Dh = r["z"].shape[0], r["z"].shape[1]
    p = {f"r{g}": r[g] for g in _GATES}
    state = {key: _wide(state[key]) for key in ("h", "c", "n", "m")}
    hs, saved = [], []
    for t in range(T):
        pre = _slstm_pre(p, state["h"], {g: wx[g][:, t] for g in _GATES},
                         H, Dh)
        state = dict(zip(("h", "c", "n", "m"), _slstm_cell(
            *pre, state["c"], state["n"], state["m"])))
        hs.append(state["h"])
        if with_saved:
            saved.append(torch.stack(
                [*pre, state["c"], state["n"], state["m"]], 1)
                .reshape(B, SLSTM_SAVED, d))
    h = torch.stack(hs, dim=1).reshape(B, T, d)
    if with_saved:
        return h, state, torch.stack(saved, 1)
    return h, state


#: Calls of the plain version since the count was last set to 0.
slstm_scan_plain.calls = 0


#: Most units a block of the B8 kernel takes (one per lane of a warp).
SLSTM_MAX_UNITS = 32
#: Most blocks a cluster of B8 / B8-bwd holds (at Dh 256).
SLSTM_MAX_CL = SLSTM_MAX_HEAD_DIM // SLSTM_MAX_UNITS


def slstm_cluster(head_dim: int) -> int:
    """Blocks per (batch row, head) of B8: the fewest that keep a block at
    <= `SLSTM_MAX_UNITS` units (6 at xlstm-125m's Dh 192, at most 8).
    Fewer ranks mean fewer stores a step and a faster exchange; the
    measurements behind the choice are in `csrc/slstm.cu`'s note."""
    return -(-head_dim // SLSTM_MAX_UNITS)


def _slstm_fn(name, nints):
    fn = getattr(build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [_P] * 18 + [_I] * nints + [_P]
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


def slstm_scan_cuda(wx, r, state, *, with_saved: bool = False):
    """Launch the B8 kernel on CUDA tensors, same arguments and results as
    `slstm_scan_plain`: the four wx contiguous (B, T, H*Dh) in one dtype
    of `KERNEL_DTYPES`, the four r contiguous (H, Dh, Dh) in one dtype of
    `KERNEL_DTYPES`, state f32; Dh <= 256. One cluster of
    `slstm_cluster(Dh)` blocks per (batch row, head). `with_saved` also
    writes the record for B8-bwd; without it the launch is the serving
    paths' own. Where autograd
    records the call it goes through `SLSTMScan` (the kernel with its
    record, and B8-bwd). On the current stream, not synchronised."""
    if build.records_grad(*wx.values(), *r.values(), *state.values()):
        return _slstm_apply(wx, r, state)
    wxs, rs, st, B, T, H, Dh, code = _slstm_args("slstm_scan_cuda", wx, r,
                                                 state)
    h = torch.empty((B, T, H * Dh), dtype=torch.float32,
                    device=wxs[0].device)
    out = [torch.empty_like(t) for t in st]
    saved = torch.empty((B, T, SLSTM_SAVED, H * Dh), dtype=torch.float32,
                        device=h.device) if with_saved else None
    if not h.is_meta:
        with torch.cuda.device(h.device):
            err = _slstm_fn("slstm", 6)(
                *(t.data_ptr() for t in (*wxs, *rs, *st, h, *out)),
                _ptr(saved), B, T, H, Dh, code, slstm_cluster(Dh),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "slstm")
        build.count(slstm_scan_cuda)
    if build.WORK is not None:
        build.WORK.kernel("slstm", kernel_work.slstm(
            B, T, H, Dh, wxs[0].element_size(), rs[0].element_size()))
    state = dict(zip(("h", "c", "n", "m"), out))
    return (h, state, saved) if with_saved else (h, state)


#: Kernel launches since the count was last set to 0.
slstm_scan_cuda.launches = 0


# ---------------------------------------------------------------------------
# B8-bwd: the sLSTM recurrence's backward (`csrc/slstm_bwd.cu`), and its
# plain version.
#
# The stabiliser carries no gradient: with c~ = c e^m, n~ = n e^m the
# recurrence is c~_t = sigmoid(f~) c~_{t-1} + e^{i~} z, so h = o c~ / n~
# does not depend on m (the clamp max(n, 1e-6) never binds: n_t >=
# min(n_0, 1), since one of f', i' is 1 each step). The backward holds
# m_t constant and keeps every other path, as B7-bwd does; the gauge part
# of a final-state gradient, g = dm1 - dc1 c1 - dn1 n1 (per unit), is
# added back through the maxes: g_{t-1} = g_t where log_sigmoid(f~_t) +
# m_{t-1} wins m_t (and then it goes to that branch), else it goes to
# i~_t and stops. Per step, from dh_t (the output's gradient plus the
# recurrent part) and the carried dc, dn, the four pre-activation
# gradients delta_g; then dc_{t-1} = f' dc', dn_{t-1} = f' dn' and
# dh_{t-1}[d] = sum_g sum_e R_g[d, e] delta_g[e]. dR_g = sum_t h_{t-1}
# delta_g^T is one batched product after the scan.
# ---------------------------------------------------------------------------

def _slstm_prev(saved, t, c0, n0, m0):
    if t:
        return saved[:, t - 1, 4], saved[:, t - 1, 5], saved[:, t - 1, 6]
    return c0, n0, m0


def slstm_scan_bwd_plain(r, h0, c0, n0, m0, h, saved, dh, dh1, dc1, dn1,
                         dm1):
    """Plain PyTorch version of B8-bwd: the step loop backwards in time,
    with the kernel's arithmetic. r: the four (H, Dh, Dh); h0, c0, n0, m0
    (B, H, Dh) the initial state; h (B, T, H*Dh) and the record `saved`
    (B, T, 7, H*Dh) from the forward; dh (B, T, H*Dh) and the final
    state's gradients (each None or (B, H, Dh)). Returns (delta (B, T, 4,
    H*Dh) — the pre-activation gradients, which are dwx — dR (four (H,
    Dh, Dh), f32), dh0, dc0, dn0, dm0)."""
    build.count(slstm_scan_bwd_plain, "calls")
    B, T, d = h.shape
    H, Dh = r[0].shape[0], r[0].shape[1]
    saved = _wide(saved)
    dt = saved.dtype
    R = torch.stack([_wide(x) for x in r]).to(dt)    # (4, H, Dh, Dh)

    def flat(x):
        return torch.zeros((B, d), dtype=dt, device=h.device) if x is None \
            else x.reshape(B, d).to(dt)
    c_init, n_init, m_init = flat(c0), flat(n0), flat(m0)
    dc, dn, dhr = flat(dc1), flat(dn1), flat(dh1)
    g = flat(dm1) - dc * saved[:, T - 1, 4] - dn * saved[:, T - 1, 5]
    dm = torch.zeros_like(dc)
    delta = torch.empty((B, T, 4, d), dtype=dt, device=h.device)
    for t in reversed(range(T)):
        cp, np_, mp = _slstm_prev(saved, t, c_init, n_init, m_init)
        pz, pi, pf, po = saved[:, t, 0], saved[:, t, 1], saved[:, t, 2], \
            saved[:, t, 3]
        ft = pf + 1.0
        lsf = F.logsigmoid(ft)
        mn = torch.maximum(lsf + mp, pi)
        ip = torch.exp(pi - mn)
        fp = torch.exp(lsf + mp - mn)
        z = torch.tanh(pz)
        o = torch.sigmoid(po)
        cn = fp * cp + ip * z
        nn = fp * np_ + ip
        den = torch.clamp(nn, min=1e-6)
        dht = dh[:, t].to(dt) + dhr
        do = dht * cn / den
        dcn = dc + dht * o / den
        dnn = dn - torch.where(nn >= 1e-6, dht * o * cn / (den * den), 0.0)
        dz = dcn * ip
        dpi = (dcn * z + dnn) * ip
        dlsf = (dcn * cp + dnn * np_) * fp
        dc, dn = dcn * fp, dnn * fp
        lsf_wins = lsf + mp >= pi
        dm = dlsf + torch.where(lsf_wins, g, 0.0)
        dlsf = dm
        dpi = dpi + torch.where(lsf_wins, 0.0, g)
        g = torch.where(lsf_wins, g, 0.0)
        dg = torch.stack([dz * (1.0 - z * z), dpi,
                          dlsf * torch.sigmoid(-ft), do * o * (1.0 - o)], 1)
        delta[:, t] = dg
        dhr = torch.einsum("bghe,ghde->bhd", dg.reshape(B, 4, H, Dh),
                           R).reshape(B, d)
    hprev = torch.cat([_wide(h0).to(dt).reshape(B, 1, d), h[:, :-1].to(dt)],
                      1)
    dR = torch.einsum("bthd,btghe->ghde", hprev.reshape(B, T, H, Dh),
                      delta.reshape(B, T, 4, H, Dh))
    shape = (B, H, Dh)
    return (delta, list(dR), dhr.reshape(shape), dc.reshape(shape),
            dn.reshape(shape), dm.reshape(shape))


slstm_scan_bwd_plain.calls = 0


#: B8-bwd's per-step coefficients (`csrc/slstm_bwd.cu`, struct Coef), in
#: the kernel's order: what the linear update of a step needs of its
#: record and of the gauge term, formed off the step chain.
SLSTM_BWD_COEFS = ("dh", "kdc", "kdn", "kdo", "kz", "kzi", "ip", "kc", "kn",
                   "kf", "fp", "gi", "gf")


def slstm_lsf_wins(saved, m0):
    """Whether log_sigmoid(f~) + m (not i~) wins each step's max, (B, T,
    H*Dh), from the forward's record `saved` (B, T, 7, H*Dh) and the
    initial m0: the branch B8-bwd's gauge term follows."""
    B, T, _, d = saved.shape
    mp = torch.cat([m0.reshape(B, 1, d).to(saved.dtype), saved[:, :-1, 6]],
                   1)
    return F.logsigmoid(saved[:, :, 2] + 1.0) + mp >= saved[:, :, 1]


def slstm_bwd_coefficients_plain(saved, dh, c0, n0, m0, g1):
    """Plain version of B8-bwd's off-chain arithmetic: from the forward's
    record `saved` (B, T, 7, H*Dh), the output's gradient dh (B, T, H*Dh),
    the initial state c0, n0, m0 and the gauge term of the final state
    g1 = dm1 - dc1 c1 - dn1 n1 (each (B, H*Dh)), every step's
    coefficients (B, T, len(`SLSTM_BWD_COEFS`), H*Dh) and whether
    log_sigmoid(f~) + m wins the step's max (`slstm_lsf_wins`). The gauge
    term reaches step t while log_sigmoid(f~) + m won every later step,
    and there goes to the branch that wins: gf where it wins again, gi
    where i~ does."""
    B, T, _, d = saved.shape
    cp = torch.cat([c0.reshape(B, 1, d), saved[:, :-1, 4]], 1)
    np_ = torch.cat([n0.reshape(B, 1, d), saved[:, :-1, 5]], 1)
    mp = torch.cat([m0.reshape(B, 1, d), saved[:, :-1, 6]], 1)
    pz, pi, pf, po = saved[:, :, 0], saved[:, :, 1], saved[:, :, 2], \
        saved[:, :, 3]
    ft = pf + 1.0
    lsf = F.logsigmoid(ft)
    mn = torch.maximum(lsf + mp, pi)
    ip = torch.exp(pi - mn)
    fp = torch.exp(lsf + mp - mn)
    z = torch.tanh(pz)
    o = torch.sigmoid(po)
    cn = fp * cp + ip * z
    nn = fp * np_ + ip
    rd = 1.0 / torch.clamp(nn, min=1e-6)
    wins = slstm_lsf_wins(saved, m0)
    # g_t: g1 times "log_sigmoid(f~) + m won every step after t".
    later = torch.flip(torch.cumprod(torch.flip(wins.to(saved.dtype), [1]),
                                     1), [1])
    reach = torch.cat([later[:, 1:], torch.ones_like(later[:, :1])], 1) \
        * g1.reshape(B, 1, d)
    coef = [dh.to(saved.dtype), o * rd,
            torch.where(nn >= 1e-6, o * cn * rd * rd, 0.0),
            cn * rd * o * (1.0 - o), ip * (1.0 - z * z), z * ip, ip,
            cp * fp, np_ * fp, torch.sigmoid(-ft), fp,
            torch.where(wins, 0.0, reach), torch.where(wins, reach, 0.0)]
    return torch.stack(coef, 2), wins


def slstm_bwd_partials_plain(dg, R, CL):
    """dh_rec (B, H*Dh) as B8-bwd forms it from the step's four deltas dg
    (B, 4, H, Dh) and R (4, H, Dh, Dh): block r of the head's cluster of
    `CL` sums its own units [r U, (r + 1) U) (U = ceil(Dh / CL)) for
    every row, and the owner of a row sums the CL partials as a tree over
    8 slots (empty slots 0)."""
    B, _, H, Dh = dg.shape
    U = -(-Dh // CL)
    pad = CL * U - Dh
    dgp = F.pad(dg, (0, pad)).reshape(B, 4, H, CL, U)
    Rp = F.pad(R, (0, pad)).reshape(4, H, Dh, CL, U)
    part = torch.einsum("bghru,ghdru->rbhd", dgp, Rp)
    slots = list(part) + [torch.zeros_like(part[0])] * (SLSTM_MAX_CL - CL)
    return (((slots[0] + slots[1]) + (slots[2] + slots[3]))
            + ((slots[4] + slots[5]) + (slots[6] + slots[7]))).reshape(B, -1)


def slstm_scan_bwd_split_plain(r, h0, c0, n0, m0, h, saved, dh, dh1, dc1,
                               dn1, dm1):
    """B8-bwd's arithmetic in its order, same arguments and results as
    `slstm_scan_bwd_plain`: every step's coefficients first
    (`slstm_bwd_coefficients_plain`), then the step loop with only the
    linear update on the chain — dht = dh + dh_rec, dc' = dc + dht kdc,
    dn' = dn - dht kdn, the four deltas and dm from dc', dn' and the
    gauge terms — and dh_rec from the deltas by blocks and slots
    (`slstm_bwd_partials_plain`)."""
    B, T, d = h.shape
    H, Dh = r[0].shape[0], r[0].shape[1]
    saved = _wide(saved)
    dt = saved.dtype
    R = torch.stack([_wide(x) for x in r]).to(dt)

    def flat(x):
        return torch.zeros((B, d), dtype=dt, device=h.device) if x is None \
            else x.reshape(B, d).to(dt)
    dc, dn, dhr = flat(dc1), flat(dn1), flat(dh1)
    g1 = flat(dm1) - dc * saved[:, T - 1, 4] - dn * saved[:, T - 1, 5]
    coef, _ = slstm_bwd_coefficients_plain(saved, dh, flat(c0), flat(n0),
                                           flat(m0), g1)
    CL = slstm_cluster(Dh)
    dm = torch.zeros_like(dc)
    delta = torch.empty((B, T, 4, d), dtype=dt, device=h.device)
    for t in reversed(range(T)):
        k = dict(zip(SLSTM_BWD_COEFS, coef[:, t].unbind(1)))
        dht = k["dh"] + dhr
        dcn = dc + dht * k["kdc"]
        dnn = dn - dht * k["kdn"]
        dm = dcn * k["kc"] + (dnn * k["kn"] + k["gf"])
        dg = torch.stack([dcn * k["kz"],
                          dcn * k["kzi"] + (dnn * k["ip"] + k["gi"]),
                          dm * k["kf"], dht * k["kdo"]], 1)
        dc, dn = dcn * k["fp"], dnn * k["fp"]
        delta[:, t] = dg
        dhr = slstm_bwd_partials_plain(dg.reshape(B, 4, H, Dh), R, CL)
    hprev = torch.cat([_wide(h0).to(dt).reshape(B, 1, d), h[:, :-1].to(dt)],
                      1)
    dR = torch.einsum("bthd,btghe->ghde", hprev.reshape(B, T, H, Dh),
                      delta.reshape(B, T, 4, H, Dh))
    shape = (B, H, Dh)
    return (delta, list(dR), dhr.reshape(shape), dc.reshape(shape),
            dn.reshape(shape), dm.reshape(shape))


def slstm_bwd_max_clusters(head_dim: int) -> int:
    """How many of B8-bwd's clusters (`slstm_cluster(head_dim)` blocks
    each) the card holds at once (`cudaOccupancyMaxActiveClusters`): a
    grid of more (b, head) clusters runs in waves, each a whole chain."""
    fn = build.load("slstm_bwd").slstm_bwd_max_clusters
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
        fn.restype = _I
    out = ctypes.c_int(0)
    _raise_on(fn(head_dim, slstm_cluster(head_dim), ctypes.byref(out)),
              "slstm_bwd_max_clusters")
    return out.value


def slstm_bwd_dr(h0, h, delta):
    """dR_g = sum_t h_{t-1} delta_g^T (four (H, Dh, Dh), f32) as one
    batched `torch.matmul`: B8-bwd's product after its kernel. h0 (B, H,
    Dh), h (B, T, H*Dh) f32, delta (B, T, 4, H*Dh) f32."""
    B, T, d = h.shape
    H, Dh = h0.shape[1], h0.shape[2]
    hprev = torch.cat([h0.float().reshape(B, 1, d), h[:, :-1]], 1)
    dR = torch.matmul(hprev.reshape(B * T, H, Dh).permute(1, 2, 0),
                      delta.reshape(B * T, 4, H, Dh).permute(2, 0, 1, 3)
                      .reshape(H, B * T, 4 * Dh))     # (H, Dh, 4 Dh)
    return [dR[:, :, g * Dh:(g + 1) * Dh] for g in range(4)]


def slstm_scan_bwd_cuda(r, h0, c0, n0, m0, h, saved, dh, dh1, dc1, dn1,
                        dm1):
    """B8-bwd on CUDA tensors, same arguments and results as
    `slstm_scan_bwd_plain`: the kernel (`slstm_bwd_cells_cuda`: one
    cluster of `slstm_cluster(Dh)` blocks per (batch row, head), R's
    columns of a block's units in registers, the partial sums of dh_{t-1}
    handed one way between the blocks each step, only the linear part of
    the cell on the step chain) writes delta and the initial state's
    gradients; dR is one batched `torch.matmul` after it
    (`slstm_bwd_dr`). r in one dtype of `KERNEL_DTYPES`; everything else
    f32. On the current stream, not synchronised."""
    delta, *out = slstm_bwd_cells_cuda(r, c0, n0, m0, h, saved, dh, dh1,
                                       dc1, dn1, dm1)
    return (delta, slstm_bwd_dr(h0, h, delta), *out)


#: Kernel launches since the count was last set to 0.
slstm_scan_bwd_cuda.launches = 0


def slstm_bwd_cells_cuda(r, c0, n0, m0, h, saved, dh, dh1, dc1, dn1, dm1):
    """B8-bwd's kernel alone, the arguments of `slstm_scan_bwd_cuda` but
    h0: (delta, dh0, dc0, dn0, dm0). Each launch counts in
    `slstm_scan_bwd_cuda.launches`."""
    name = "slstm_scan_bwd_cuda"
    B, T, d = h.shape
    H, Dh = r[0].shape[0], r[0].shape[1]
    given = [None if t is None else t.float().contiguous()
             for t in (dh1, dc1, dn1, dm1)]
    init = [t.float().contiguous() for t in (c0, n0, m0)]
    dh = dh.float().contiguous()
    _check_cuda(name, *r, *init, h, saved, dh,
                *(t for t in given if t is not None))
    if r[0].dtype not in KERNEL_DTYPES \
            or any(t.dtype != r[0].dtype or t.shape != (H, Dh, Dh)
                   or not t.is_contiguous() for t in r) \
            or H * Dh != d or not 1 <= Dh <= SLSTM_MAX_HEAD_DIM \
            or B * H > 65535 or not B * T:
        raise ValueError(f"{name}: r must be four contiguous (H, Dh, Dh) "
                         f"of one dtype of {list(KERNEL_DTYPES)}, Dh <= "
                         f"{SLSTM_MAX_HEAD_DIM}, H*Dh = {d}")
    if saved.shape != (B, T, SLSTM_SAVED, d) \
            or saved.dtype != torch.float32 or not saved.is_contiguous() \
            or h.dtype != torch.float32 or dh.shape != h.shape \
            or any(t.shape != (B, H, Dh) for t in (*init, *(
                x for x in given if x is not None))):
        raise ValueError(f"{name}: saved must be contiguous float32 "
                         f"({B}, {T}, {SLSTM_SAVED}, {d}), dh like h, the "
                         f"states ({B}, {H}, {Dh})")
    delta = torch.empty((B, T, 4, d), dtype=torch.float32, device=h.device)
    out = [torch.empty_like(init[0]) for _ in range(4)]
    if not h.is_meta:
        with torch.cuda.device(h.device):
            err = _slstm_fn("slstm_bwd", 6)(
                *(t.data_ptr() for t in (*r, *init, saved, dh)),
                *(_ptr(t) for t in given),
                *(t.data_ptr() for t in (delta, *out)),
                B, T, H, Dh, KERNEL_DTYPES[r[0].dtype], slstm_cluster(Dh),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "slstm_bwd")
        build.count(slstm_scan_bwd_cuda)
    if build.WORK is not None:       # the kernel alone: dR is an aten matmul
        build.WORK.kernel("slstm_bwd", kernel_work.slstm_bwd(
            B, T, H, Dh, r[0].element_size(), SLSTM_SAVED, False))
    return (delta, *out)


class SLSTMScan(torch.autograd.Function):
    """B8 with its backward: on CUDA tensors the kernel writing its
    per-step record and B8-bwd, on CPU tensors `slstm_scan_plain(...,
    with_saved=True)` and `slstm_scan_bwd_plain`. Everything the backward
    reads goes through `ctx.save_for_backward` (r, the initial state, h
    and the record), so a non-reentrant checkpoint may run the forward
    again. `apply(wx_z, wx_i, wx_f, wx_o, r_z, r_i, r_f, r_o, h0, c0, n0,
    m0) -> (h, h1, c1, n1, m1)`; dwx comes back in wx's dtype, dR in
    r's."""

    @staticmethod
    def forward(ctx, wz, wi, wf, wo, rz, ri, rf, ro, h0, c0, n0, m0):
        wx = dict(zip(_GATES, (wz, wi, wf, wo)))
        r = dict(zip(_GATES, (rz, ri, rf, ro)))
        state = {"h": h0, "c": c0, "n": n0, "m": m0}
        scan = slstm_scan_cuda if build.kernel_side(wz) \
            else slstm_scan_plain
        h, st, saved = scan(wx, r, state, with_saved=True)
        ctx.save_for_backward(rz, ri, rf, ro, h0, c0, n0, m0, h, saved)
        ctx.wx_dtype = wz.dtype
        ctx.set_materialize_grads(False)
        return h, st["h"], st["c"], st["n"], st["m"]

    @staticmethod
    def backward(ctx, dh, dh1, dc1, dn1, dm1):
        rz, ri, rf, ro, h0, c0, n0, m0, h, saved = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        bwd = slstm_scan_bwd_cuda if build.kernel_side(rz) \
            else slstm_scan_bwd_plain
        delta, dR, dh0, dc0, dn0, dm0 = bwd(
            (rz, ri, rf, ro), h0, c0, n0, m0, h, saved, dh, dh1, dc1, dn1,
            dm1)
        dwx = [delta[:, :, g].to(ctx.wx_dtype) for g in range(4)]
        dR = [x.to(rz.dtype) for x in dR]
        return (*dwx, *dR, dh0, dc0, dn0, dm0)


def _slstm_apply(wx, r, state):
    h, h1, c1, n1, m1 = SLSTMScan.apply(
        *(wx[g] for g in _GATES), *(r[g] for g in _GATES),
        *(state[key] for key in ("h", "c", "n", "m")))
    return h, {"h": h1, "c": c1, "n": n1, "m": m1}


def slstm_scan(wx, r, state):
    """The step loop where the tensors live: where autograd records the
    call, `SLSTMScan` (kernel or plain version, with its backward);
    elsewhere CPU tensors take `slstm_scan_plain`, CUDA tensors the
    kernel."""
    if build.records_grad(*wx.values(), *r.values(), *state.values()):
        return _slstm_apply(wx, r, state)
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
