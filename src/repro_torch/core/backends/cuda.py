"""CUDA backend: the hand-written wavefront kernel (`kernels.banded_dp`)
followed, with ``decode="device"``, by the walker kernel of
`core.traceback_device`; for persistent dispatch, the persistent kernel
and the table walker, one launch each per request. Takes CUDA tensors
(numpy inputs are placed on the current CUDA device); queues the launches
on the current stream and returns without synchronising. There is no
fallback: a failed build or launch is an exception.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.backends import run_persistent_program
from repro_torch.core.banded import validate_narrow_cells
from repro_torch.core.traceback_device import decode_packed_tb_table_cuda
from repro_torch.kernels.banded_dp.banded_dp import banded_align_cuda
from repro_torch.kernels.banded_dp.persistent import persistent_align_cuda


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

    def run_persistent(self, groups, *, sc, adaptive=True, collect_tb=True,
                       mode="global", decode="device", cell_dtype="int32",
                       xdrop=None, device="cuda"):
        """All dispatch groups in one persistent-kernel launch and one
        table-walker launch (contract in `core.backends`)."""
        if cell_dtype == "narrow":
            validate_narrow_cells(
                sc, max((int(g[4]) for g in groups), default=1))
        return run_persistent_program(
            groups, align=persistent_align_cuda,
            walker=decode_packed_tb_table_cuda, device=device, sc=sc,
            adaptive=adaptive, collect_tb=collect_tb, mode=mode,
            decode=decode, cell_dtype=cell_dtype, xdrop=xdrop)


BACKEND = CudaBackend
