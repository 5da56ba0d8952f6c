"""Public wrapper of the banded DP wavefront.

Exposes the same result dict as `core.banded.banded_align_batch` so
callers can swap the plain path and the kernel path behind one API. The
choice is made by where the tensors live and by nothing else: CPU tensors
take the plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.core.banded import banded_align_batch
from repro_torch.core.scoring import ScoringConfig
from repro_torch.kernels.banded_dp.banded_dp import banded_align_cuda


def banded_align_kernel_batch(q_pad, r_pad, n, m, *, sc: ScoringConfig,
                              band: int, adaptive: bool = True,
                              collect_tb: bool = True, mode: str = "global",
                              t_max: int | None = None,
                              cell_dtype: str = "int32",
                              xdrop: int | None = None, device=None):
    """Kernel-path batched alignment.

    Returns the same result dict as `core.banded.banded_align_batch`:
    always 'score', 'final_lo', 'best_score', 'best_i', 'best_j', 'status'
    (each (N,) int32; status 0 = aligned, k > 0 = xdrop-retired at step
    k); with collect_tb also 'tb' ((N, T, ceil(B/2)) uint8 — 4-bit flags
    packed two lanes per byte, `core.banded.pack_tb_lanes` layout) and
    'los' ((N, T+1) int32), where T = t_max (the trimmed sweep length,
    >= max true n + m) or Lq + Lr. The batch needs no padding to a tile:
    one thread block owns one pair. `device` places numpy inputs; tensors
    stay where they are when it is None.
    """
    q_pad = torch.as_tensor(q_pad, device=device)
    dev = q_pad.device
    r_pad = torch.as_tensor(r_pad, device=dev)
    n = torch.as_tensor(n, device=dev)
    m = torch.as_tensor(m, device=dev)
    kw = dict(sc=sc, band=band, adaptive=adaptive, collect_tb=collect_tb,
              mode=mode, t_max=t_max, cell_dtype=cell_dtype, xdrop=xdrop)
    if dev.type == "cpu":
        return banded_align_batch(q_pad, r_pad, n, m, **kw)
    return banded_align_cuda(q_pad, r_pad, n, m, **kw)
