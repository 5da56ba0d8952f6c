"""On-device traceback decode (paper §V-C3, the peripheral walk).

RAPIDx never ships the flag planes across the memory interface: dedicated
peripheral logic *next to the arrays* walks the path and only the tiny
CIGAR stream leaves. This module is that peripheral logic on the
accelerator side: a walker that consumes the packed
``(N, T, ceil(B/2))`` traceback plane and the ``los`` band offsets **while
they are still device tensors** and emits fixed-width run-length-encoded
CIGARs. Only the RLE arrays —

    cig_ops   (N, K) uint8   op codes (1 = M, 2 = I, 3 = D; 0 = unused)
    cig_runs  (N, K) int32   run lengths
    cig_len   (N,)   int32   number of RLE segments per pair

with ``K = T`` (the trimmed sweep length bounds the path length, since
every traceback step consumes at least one wavefront step) — ever become
host-fetch candidates, and the engine additionally trims the fetch to the
longest CIGAR actually present, collapsing per-pair host traffic from
``ceil(B/2) * t_max`` plane bytes to ``O(path segments)``.

`decode_packed_tb` is the wrapper. On CUDA tensors it launches the
hand-written walker kernel (``csrc/traceback.cu``, one warp per pair, RLE
while walking) or raises; on CPU tensors it takes the plain version
`decode_packed_tb_plain`, a lockstep loop of tensor ops with the same
flag semantics, band-escape diagonal fallback and forced boundary gaps as
the host oracle `banded.traceback_banded_batch` (entering a gap run and
emitting its first op are fused into one step, so every iteration emits
exactly one op per still-active pair and the walk needs at most ``T``
iterations). Both give the same three arrays bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.banded import _OP_CHARS, _OP_D, _OP_I, _OP_M, \
    select_tb_nibble
from repro_torch.kernels import build

#: Steps between two tests of the plain walker's early exit (one host
#: sync each): the loop stops once every pair has reached (0, 0).
WALK_CHUNK = 64

_P, _I = ctypes.c_void_p, ctypes.c_int


def decode_packed_tb_plain(tb, los, start_i, start_j, *, band: int):
    """Plain PyTorch version of the walker: every pair in lockstep.

    Same arguments and results as `decode_packed_tb`; runs on the device
    the tensors live on.
    """
    decode_packed_tb_plain.calls += 1
    dev = tb.device
    N, T, _ = tb.shape
    idx = torch.arange(N, device=dev)
    i = start_i.to(torch.int32).clone()
    j = start_j.to(torch.int32).clone()
    st = torch.zeros(N, dtype=torch.int32, device=dev)
    emitted = torch.zeros((N, T), dtype=torch.uint8, device=dev)
    if T == 0:
        z = torch.zeros((N, 0), dtype=torch.int32, device=dev)
        return emitted, z, torch.zeros(N, dtype=torch.int32, device=dev)

    def lookup(ii, jj):
        """Flags at (ii, jj) per pair + in-band validity. One byte gather
        from the packed plane, then the shared nibble select."""
        t = ii + jj
        lo = los[idx, torch.clamp(t, 0, T).long()]
        k = ii - lo
        ok = (t >= 1) & (k >= 0) & (k < band)
        kc = torch.clamp(k, 0, band - 1)
        byte = tb[idx, torch.clamp(t - 1, 0, T - 1).long(), (kc >> 1).long()]
        return select_tb_nibble(byte.to(torch.int32), kc), ok

    for step in range(T):
        if step % WALK_CHUNK == 0 and not bool(((i > 0) | (j > 0)).any()):
            break
        active = (i > 0) | (j > 0)
        c, in_band = lookup(i, j)
        cu, up_ok = lookup(i - 1, j)
        cl, left_ok = lookup(i, j - 1)
        d = c & 3

        # Branch masks — the same case split as the host walker. Entering
        # a gap run (state 0, d != 0) is fused with emitting its first op.
        b_del = active & (i == 0)
        b_ins = active & (i > 0) & (j == 0)
        interior = active & (i > 0) & (j > 0)
        esc = interior & ~in_band          # band escape: diagonal fallback
        core = interior & in_band
        diag = core & (st == 0) & (d == 0)
        ins = core & ((st == 1) | ((st == 0) & (d == 1)))
        dele = core & ((st == 2) | ((st == 0) & (d >= 2)))

        # Gap-extend bits live on the *next* cell of the run (Eq. (4)
        # regrouping): E reads (i-1, j), F reads (i, j-1).
        ext_e = up_ok & (i - 1 >= 1) & (j >= 1) & ((cu & 4) != 0)
        ext_f = left_ok & (j - 1 >= 1) & (i >= 1) & ((cl & 8) != 0)

        emit = (_OP_I * (b_ins | ins).to(torch.uint8)
                + _OP_D * (b_del | dele).to(torch.uint8)
                + _OP_M * (diag | esc).to(torch.uint8))
        emitted[:, step] = emit
        i = i - (diag | esc | b_ins | ins).to(torch.int32)
        j = j - (diag | esc | b_del | dele).to(torch.int32)
        st = torch.where(ins, ext_e.to(torch.int32),
                         torch.where(dele, 2 * ext_f.to(torch.int32), st))

    # ---- fixed-width RLE of the reversed (path-order) op stream ----
    # Every active iteration emits exactly one op, so pair p's stream is
    # the nonzero prefix emitted[p, :path_len].
    path_len = (emitted != 0).sum(dim=1).to(torch.int32)
    s = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    rev = path_len[:, None] - 1 - s
    valid = rev >= 0
    cig = torch.gather(emitted, 1, torch.clamp(rev, 0, T - 1).long())
    cig = torch.where(valid, cig, 0)
    prev = torch.cat([torch.zeros((N, 1), dtype=cig.dtype, device=dev),
                      cig[:, :-1]], dim=1)
    newseg = valid & (cig != prev)
    seg = torch.cumsum(newseg.to(torch.int32), dim=1) - 1
    segc = torch.clamp(seg, 0, T - 1).long()
    cig_len = newseg.sum(dim=1).to(torch.int32)
    cig_runs = torch.zeros((N, T), dtype=torch.int32, device=dev)
    cig_runs.scatter_add_(1, segc, valid.to(torch.int32))
    cig_ops = torch.zeros((N, T), dtype=torch.int32, device=dev)
    cig_ops.scatter_reduce_(1, segc, cig.to(torch.int32), reduce="amax")
    return cig_ops.to(torch.uint8), cig_runs, cig_len


#: Calls of the plain walker since the count was last set to 0.
decode_packed_tb_plain.calls = 0


def _lib():
    lib = build.load("traceback")
    fn = lib.traceback_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        fn.restype = _I
    return lib


def decode_packed_tb_cuda(tb, los, start_i, start_j, *, band: int):
    """Launch the walker kernel on CUDA tensors (current stream, no
    synchronisation). Raises on anything the kernel does not take."""
    if not tb.is_cuda:
        raise ValueError("decode_packed_tb_cuda takes CUDA tensors")
    dev = tb.device
    if tb.dtype != torch.uint8 or tb.dim() != 3:
        raise ValueError("tb must be an (N, T, ceil(band/2)) uint8 tensor")
    N, T, Bp = tb.shape
    if Bp != (int(band) + 1) // 2:
        raise ValueError(f"tb is {Bp} bytes wide, band={band} needs "
                         f"{(int(band) + 1) // 2}")
    if tuple(los.shape) != (N, T + 1) or los.dtype != torch.int32:
        raise ValueError("los must be an (N, T+1) int32 tensor")
    tb = tb.contiguous()
    los = los.contiguous()
    si = start_i.to(device=dev, dtype=torch.int32).contiguous()
    sj = start_j.to(device=dev, dtype=torch.int32).contiguous()
    if si.shape != (N,) or sj.shape != (N,):
        raise ValueError("start_i, start_j must be (N,) tensors")
    cig_ops = torch.empty((N, T), dtype=torch.uint8, device=dev)
    cig_runs = torch.empty((N, T), dtype=torch.int32, device=dev)
    if N == 0 or T == 0:
        return cig_ops, cig_runs, torch.zeros(N, dtype=torch.int32,
                                              device=dev)
    cig_len = torch.empty(N, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.traceback_launch(
            tb.data_ptr(), los.data_ptr(), si.data_ptr(), sj.data_ptr(),
            cig_ops.data_ptr(), cig_runs.data_ptr(), cig_len.data_ptr(),
            N, T, Bp, int(band), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"traceback kernel launch failed: CUDA error "
                           f"{err}")
    decode_packed_tb_cuda.launches += 1
    return cig_ops, cig_runs, cig_len


#: Kernel launches since the count was last set to 0.
decode_packed_tb_cuda.launches = 0


def decode_packed_tb(tb, los, start_i, start_j, *, band: int, device=None):
    """Walk every pair's packed flag plane where it lives.

    Args:
      tb: (N, T, ceil(band/2)) uint8 packed flag planes (`pack_tb_lanes`
        layout).
      los: (N, T+1) int32 band offsets.
      start_i, start_j: (N,) int32 traceback start cells — (n, m) for
        global mode, the tracked best cell for semiglobal/extension
        (paper §III-A2: "traceback starts from the max cell").
      band: band width B.
      device: where numpy inputs are placed; tensors stay where they are
        when None.

    Returns (cig_ops, cig_runs, cig_len) tensors on that device — the
    fixed-width RLE CIGAR layout above, runs in path order (start of the
    alignment first, exactly like the host decoder's output). CUDA
    tensors go through the kernel, CPU tensors through the plain version.
    """
    tb = torch.as_tensor(tb, device=device)
    dev = tb.device
    los = torch.as_tensor(los, device=dev)
    start_i = torch.as_tensor(start_i, device=dev)
    start_j = torch.as_tensor(start_j, device=dev)
    if dev.type == "cpu":
        return decode_packed_tb_plain(tb, los, start_i, start_j, band=band)
    return decode_packed_tb_cuda(tb, los, start_i, start_j, band=band)


def device_decode_result(out: dict, n, m, *, band: int,
                         mode: str = "global", walker=None) -> dict:
    """Fuse the decode stage onto a backend result: consume ``tb``/``los``
    (still device tensors) and return the result dict with the RLE CIGAR
    arrays in their place.

    Start-cell selection happens on-device: global mode walks from
    (n, m), semiglobal from the tracked best cell on the last read row —
    no host round-trip for ``best_i``/``best_j``.

    Pairs the xdrop rule retired ('status' != 0) never completed their
    sweep: their start cell is zeroed, which makes the walk a no-op and
    their CIGAR empty (the engine maps it to None).

    `walker` overrides the decode function (default `decode_packed_tb`,
    which picks kernel or plain version by the tensors' device); the
    reference backend passes the plain version.
    """
    out = dict(out)
    tb = out.pop("tb")
    los = out.pop("los")
    dev = tb.device
    if mode == "semiglobal":
        start_i, start_j = out["best_i"], out["best_j"]
    else:
        start_i = torch.as_tensor(n, device=dev).to(torch.int32)
        start_j = torch.as_tensor(m, device=dev).to(torch.int32)
    status = out.get("status")
    if status is not None:
        keep = (status == 0).to(torch.int32)
        start_i = start_i * keep
        start_j = start_j * keep
    walker = decode_packed_tb if walker is None else walker
    ops, runs, lens = walker(tb, los, start_i, start_j, band=band)
    out["cig_ops"] = ops
    out["cig_runs"] = runs
    out["cig_len"] = lens
    return out


def fetch_rle(out: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Materialise a device-decoded result's RLE arrays on the host,
    trimmed to the longest CIGAR actually present.

    Fetches ``cig_len`` first (N x 4 bytes), slices the op/run planes on
    the device to ``K_used = max(cig_len)`` columns, and only then copies
    them — so host traffic per pair is ``5 * K_used + 4`` bytes, O(path
    segments), never the static K = t_max bound.
    """
    lens = out["cig_len"].cpu().numpy()
    k_used = max(int(lens.max(initial=0)), 1)
    ops = out["cig_ops"][:, :k_used].cpu().numpy()
    runs = out["cig_runs"][:, :k_used].cpu().numpy()
    return ops, runs, lens


def rle_to_cigars(ops: np.ndarray, runs: np.ndarray,
                  lens: np.ndarray) -> list[list[tuple[str, int]]]:
    """Join host-fetched RLE arrays into the list-of-(op, run) CIGAR
    format shared with the host decoder. O(total segments) host work —
    the only per-pair loop left on the traceback path."""
    ops_l = ops.tolist()
    runs_l = runs.tolist()
    return [[(_OP_CHARS[o], r)
             for o, r in zip(ops_l[p][:k], runs_l[p][:k])]
            for p, k in enumerate(lens.tolist())]
