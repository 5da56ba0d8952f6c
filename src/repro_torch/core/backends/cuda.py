"""CUDA backend: the hand-written wavefront kernel (`kernels.banded_dp`)
followed, with ``decode="device"``, by the walker kernel of
`core.traceback_device`. Takes CUDA tensors (numpy inputs are placed on
the current CUDA device); queues both launches on the current stream and
returns without synchronising. There is no fallback: a failed build or
launch is an exception.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.backends import persistent_not_ported
from repro_torch.core.banded import validate_narrow_cells
from repro_torch.kernels.banded_dp.banded_dp import banded_align_cuda


@dataclasses.dataclass(frozen=True)
class CudaBackend:
    name = "cuda"

    def run(self, q_pad, r_pad, n, m, *, sc, band, adaptive=True,
            collect_tb=True, mode="global", t_max=None, decode="host",
            cell_dtype="int32", xdrop=None):
        if not isinstance(q_pad, torch.Tensor):
            q_pad = torch.as_tensor(q_pad, device="cuda")
        if cell_dtype == "narrow":
            validate_narrow_cells(sc, band)
        out = banded_align_cuda(q_pad, r_pad, n, m, sc=sc, band=band,
                                adaptive=adaptive, collect_tb=collect_tb,
                                mode=mode, t_max=t_max,
                                cell_dtype=cell_dtype, xdrop=xdrop)
        if collect_tb and decode == "device":
            # The packed plane stays in device memory; only the RLE CIGAR
            # arrays become host-fetch candidates.
            from repro_torch.core.traceback_device import \
                device_decode_result
            out = device_decode_result(out, n, m, band=band, mode=mode)
        return out

    def run_persistent(self, groups, **kwargs):
        persistent_not_ported()


BACKEND = CudaBackend
