"""Launch wrapper of the CUDA wavefront kernel (`csrc/banded_dp.cu`).

The kernel replaces the TPU kernel `_wavefront_kernel` of the JAX
package's `kernels/banded_dp/banded_dp.py`; its design note is at the top
of the ``.cu`` source. This module checks the arguments, allocates the
outputs, launches on PyTorch's current stream and counts launches. It
never synchronises and never falls back: on anything the kernel does not
take it raises. The plain PyTorch version of the same function is
`core.banded.banded_align_batch`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.banded import packed_tb_width
from repro_torch.core.scoring import ScoringConfig
from repro_torch.kernels import build

#: Result rows of the kernel's (6, N) stats plane, in order.
STAT_KEYS = ("score", "final_lo", "best_score", "best_i", "best_j", "status")

#: Widest band one launch takes (one band lane per thread of a block).
MAX_BAND = 1024

#: Longest sweep (Lq + Lr) the kernel's int32 step arithmetic is held to.
MAX_SWEEP = 32768

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = build.load("banded_dp")
    fn = lib.banded_dp_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 13 + [_P]
        fn.restype = _I
    return lib


def banded_align_cuda(q_pad, r_pad, n, m, *, sc: ScoringConfig, band: int,
                      adaptive: bool = True, collect_tb: bool = True,
                      mode: str = "global", t_max: int | None = None,
                      cell_dtype: str = "int32", xdrop: int | None = None):
    """Run the wavefront kernel on CUDA tensors.

    Args:
      q_pad: (N, Lq) encoded queries on a CUDA device (any integer type;
        bases 0..3, padding 4), r_pad: (N, Lr), n, m: (N,) true lengths.
      band, t_max, sc, xdrop: run-time arguments of the kernel — no
        rebuild per dispatch signature. ``cell_dtype="narrow"`` runs on
        the kernel's int32 path (identical results by construction).

    Returns the result dict of `core.banded.banded_align_batch` as CUDA
    tensors; the six scalars are rows of one (6, N) int32 plane.
    """
    if not (isinstance(q_pad, torch.Tensor) and q_pad.is_cuda):
        raise ValueError("banded_align_cuda takes CUDA tensors; the plain "
                         "version core.banded.banded_align_batch runs "
                         "anywhere")
    if mode not in ("global", "semiglobal"):
        raise ValueError(f"unknown mode {mode!r}")
    if cell_dtype not in ("int32", "narrow"):
        raise ValueError(f"unknown cell_dtype {cell_dtype!r}")
    B = int(band)
    if not 1 <= B <= MAX_BAND:
        raise ValueError(f"band={B} outside the kernel's range "
                         f"1..{MAX_BAND}")
    dev = q_pad.device
    q = q_pad.to(torch.int8).contiguous()
    r = r_pad.to(device=dev, dtype=torch.int8).contiguous()
    n = torch.as_tensor(n, device=dev).to(torch.int32).contiguous()
    m = torch.as_tensor(m, device=dev).to(torch.int32).contiguous()
    N, Lq = q.shape
    Lr = r.shape[1]
    if r.shape[0] != N or n.shape != (N,) or m.shape != (N,):
        raise ValueError("q_pad, r_pad, n, m disagree on the batch size")
    if Lq < 1 or Lr < 1:
        raise ValueError("empty sequence rows")
    T = int(t_max) if t_max is not None else Lq + Lr
    if not 0 <= T <= MAX_SWEEP:
        raise ValueError(f"sweep length {T} outside 0..{MAX_SWEEP}")
    if xdrop is not None and int(xdrop) < 0:
        raise ValueError("xdrop must be non-negative or None")

    stats = torch.empty((len(STAT_KEYS), N), dtype=torch.int32, device=dev)
    tb = los = None
    if collect_tb:
        tb = torch.empty((N, T, packed_tb_width(B)), dtype=torch.uint8,
                         device=dev)
        los = torch.empty((N, T + 1), dtype=torch.int32, device=dev)
    if N:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.banded_dp_launch(
                q.data_ptr(), r.data_ptr(), n.data_ptr(), m.data_ptr(),
                stats.data_ptr(),
                tb.data_ptr() if collect_tb else None,
                los.data_ptr() if collect_tb else None,
                N, Lq, Lr, T, B, sc.match, sc.mismatch, sc.gap_open,
                sc.gap_extend, -1 if xdrop is None else int(xdrop),
                int(mode == "semiglobal"), int(bool(adaptive)),
                int(bool(collect_tb)), stream)
        if err != 0:
            raise RuntimeError(f"banded_dp kernel launch failed: CUDA "
                               f"error {err}")
        banded_align_cuda.launches += 1
    out = {key: stats[i] for i, key in enumerate(STAT_KEYS)}
    if collect_tb:
        out["tb"] = tb
        out["los"] = los
    return out


#: Kernel launches since the count was last set to 0.
banded_align_cuda.launches = 0
