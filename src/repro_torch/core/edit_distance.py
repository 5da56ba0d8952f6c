"""Edit-distance mode (paper §V-D2, Fig. 14).

Edit distance is alignment with the degenerate scoring (match 0,
mismatch 1, indel 1) run through the *same* data flow — the paper's
"reconfigurable design with dynamic precision": only the scoring constants
and the arithmetic precision change (5-bit -> 3-bit on ReRAM; here the
int8 invariant tightens). We expose distance-only (traceback disabled)
and full-traceback variants to reproduce both Fig. 14 curves.

`edit_distance_batch` and `edit_distance` run on the card by default,
through the engine's CUDA kernels (the wavefront and, with traceback, the
walker); pass ``device="cpu", backend="reference"`` for the plain versions
on the CPU.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.banded import banded_align, traceback_banded
from repro_torch.core.scoring import EDIT_DISTANCE, adaptive_bandwidth


def edit_distance_batch(q_pad, r_pad, n, m, *, band: int | None = None,
                        with_traceback: bool = False,
                        backend: str = "auto",
                        backend_opts: dict | None = None,
                        decode: str = "device", device="cuda"):
    """Banded edit distance for a padded batch.

    Runs the degenerate scoring through the full engine dispatch path
    (`AlignmentEngine.align_arrays`) on `device` (default the card, with
    backend "auto" = the CUDA kernels; raises without one): the sweep is
    trimmed to the true max n + m of the batch (`t_max`, §VI-F) and the
    traceback plane is the packed 2-flags-per-byte layout of the backend
    contract — the paper's reconfigurable data flow: same engine,
    different scoring constants. Returns dict with 'distance' ((N,)
    int32 numpy), 'band', and the trimmed 't_max'; with_traceback adds
    on-device-decoded 'cigars' (decode="device", the default everywhere
    in the stack — the packed plane never reaches the host) or, with
    decode="host", the raw packed planes ('tb'/'los', tensors on
    `device`) for the host-decoder oracle path.
    distance = -score under the EDIT_DISTANCE scoring.
    """
    from repro_torch.core.batch import trimmed_sweep
    from repro_torch.core.engine import AlignmentEngine

    if band is None:
        band = adaptive_bandwidth(int(q_pad.shape[1]), base_bandwidth=10)
    t_max = trimmed_sweep(np.asarray(n), np.asarray(m),
                          int(q_pad.shape[1]), int(r_pad.shape[1]))
    eng = AlignmentEngine(backend=backend, device=device, sc=EDIT_DISTANCE,
                          backend_opts=backend_opts)
    out = eng.align_arrays(q_pad, r_pad, n, m, band=band,
                           collect_tb=with_traceback, t_max=t_max,
                           decode=decode)
    result = {"distance": -out["score"].cpu().numpy(), "band": band,
              "t_max": t_max}
    if with_traceback:
        if decode == "device":
            from repro_torch.core.traceback_device import (fetch_rle,
                                                           rle_to_cigars)
            result["cigars"] = rle_to_cigars(*fetch_rle(out))
        else:
            result["tb"] = out["tb"]
            result["los"] = out["los"]
    return result


def edit_distance(q, r, *, band: int | None = None,
                  with_traceback: bool = False, device="cuda",
                  backend: str = "auto"):
    """Single-pair convenience wrapper. Returns (distance, cigar|None).

    On a CUDA device (the default; raises without one), or with an
    explicit `backend`, the pair runs as a batch of one through
    `edit_distance_batch` — the engine's kernels and the device decoder,
    the run-length CIGAR fetched to the host. On the CPU with
    backend="auto" it runs the plain single-pair wavefront
    (`banded_align`) and the host decoder, as the reference does. Both
    routes give the same distance and CIGAR.
    """
    from repro_torch.core.batch import check_device

    q = np.asarray(q, dtype=np.int8)
    r = np.asarray(r, dtype=np.int8)
    if band is None:
        band = adaptive_bandwidth(max(len(q), len(r)), base_bandwidth=10)
    device = check_device(device)
    if device.type == "cuda" or backend != "auto":
        out = edit_distance_batch(q[None], r[None], [len(q)], [len(r)],
                                  band=band, with_traceback=with_traceback,
                                  backend=backend, device=device)
        return (int(out["distance"][0]),
                out["cigars"][0] if with_traceback else None)
    out = banded_align(q, r, len(q), len(r), sc=EDIT_DISTANCE, band=band,
                       adaptive=True, collect_tb=with_traceback,
                       device=device)
    dist = int(-out["score"])
    cigar = None
    if with_traceback:
        cigar = traceback_banded(out["tb"], out["los"], len(q), len(r), band)
    return dist, cigar


def levenshtein_reference(a, b) -> int:
    """Classic O(nm) Levenshtein oracle (numpy rows) for tests."""
    a = np.asarray(a)
    b = np.asarray(b)
    prev = np.arange(len(b) + 1, dtype=np.int64)
    for i in range(1, len(a) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub_cost = (b != a[i - 1]).astype(np.int64)
        # cur[j] = min(prev[j]+1, cur[j-1]+1, prev[j-1]+sub)
        base = np.minimum(prev[1:] + 1, prev[:-1] + sub_cost)
        # sequential dependence on cur[j-1] resolved with a running scan
        run = base[0] if len(base) else 0
        for j in range(1, len(b) + 1):
            run = min(base[j - 1], (cur[j - 1] + 1))
            cur[j] = run
        prev = cur
    return int(prev[-1])
