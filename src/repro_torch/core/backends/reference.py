"""Reference backend: the plain PyTorch wavefront (`core.banded`) and the
plain lockstep walker, on whatever device the tensors live on.

The oracle the CUDA backend must match bit-exactly (integer DP), and the
only backend that runs on the CPU.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import banded
from repro_torch.core.backends import persistent_not_ported


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

    def run_persistent(self, groups, **kwargs):
        persistent_not_ported()


BACKEND = ReferenceBackend
