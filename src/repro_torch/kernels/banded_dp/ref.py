"""Plain-PyTorch oracle for the banded DP wavefront kernel.

The oracle *is* the paper-faithful `core.banded` loop — the kernel must
reproduce its scores and traceback planes bit-exactly (integer DP: exact
equality, not allclose).
"""

from __future__ import annotations

from repro_torch.core.banded import banded_align_batch


def banded_align_ref_batch(q_pad, r_pad, n, m, *, sc, band, adaptive=True,
                           collect_tb=True, device=None):
    """Reference result dict with 'score' (+ 'tb' (N, T, ceil(B/2)
    packed) and 'los' (N, T+1) when collect_tb)."""
    return banded_align_batch(q_pad, r_pad, n, m, sc=sc, band=band,
                              adaptive=adaptive, collect_tb=collect_tb,
                              device=device)
