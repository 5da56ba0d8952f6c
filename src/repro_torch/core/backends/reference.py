"""Reference backend: the plain PyTorch wavefront (`core.banded`) and the
plain lockstep walker, on whatever device the tensors live on.

The oracle the CUDA backend must match bit-exactly (integer DP), and the
only backend that runs on the CPU. Its `run_persistent` runs the plain
versions of the persistent kernel and of the table walker, so a
persistent request has the merged layout of the CUDA backend.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import banded
from repro_torch.core.backends import run_persistent_program
from repro_torch.core.traceback_device import decode_packed_tb_table_plain
from repro_torch.kernels.banded_dp.persistent import persistent_align_plain


@dataclasses.dataclass(frozen=True)
class ReferenceBackend:
    name = "reference"

    def run(self, q_pad, r_pad, n, m, *, sc, band, adaptive=True,
            collect_tb=True, mode="global", t_max=None, decode="host",
            cell_dtype="int32", xdrop=None):
        out = banded.banded_align_batch(q_pad, r_pad, n, m, sc=sc,
                                        band=band, adaptive=adaptive,
                                        collect_tb=collect_tb, mode=mode,
                                        t_max=t_max, cell_dtype=cell_dtype,
                                        xdrop=xdrop)
        if collect_tb and decode == "device":
            # tb/los are consumed while still device tensors.
            from repro_torch.core import traceback_device as tbd
            out = tbd.device_decode_result(
                out, n, m, band=band, mode=mode,
                walker=tbd.decode_packed_tb_plain)
        return out

    def run_persistent(self, groups, *, sc, adaptive=True, collect_tb=True,
                       mode="global", decode="device", cell_dtype="int32",
                       xdrop=None, device="cpu"):
        """All dispatch groups through the plain versions, merged
        (contract in `core.backends`)."""
        return run_persistent_program(
            groups, align=persistent_align_plain,
            walker=decode_packed_tb_table_plain, device=device, sc=sc,
            adaptive=adaptive, collect_tb=collect_tb, mode=mode,
            decode=decode, cell_dtype=cell_dtype, xdrop=xdrop)


BACKEND = ReferenceBackend
