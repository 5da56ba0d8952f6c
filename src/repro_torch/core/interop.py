"""State carried across from the JAX package.

This system has no weights: what crosses between the two packages is the
scoring configuration and the result planes. The functions here take
numpy arrays and plain Python values only — neither package imports the
other — and give them the backend contract's dtypes
(`core.backends`). The parity tests use them to cross-feed: the
reference's ``tb``/``los`` into the port's walker, and the port's into
the reference's host decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scoring import ScoringConfig

#: dtype of every key of a backend result dict (the `run` contract).
RESULT_DTYPES = {
    "score": torch.int32, "final_lo": torch.int32,
    "best_score": torch.int32, "best_i": torch.int32,
    "best_j": torch.int32, "status": torch.int32,
    "tb": torch.uint8, "los": torch.int32,
    "cig_ops": torch.uint8, "cig_runs": torch.int32,
    "cig_len": torch.int32,
}


def scoring_from_fields(**fields) -> ScoringConfig:
    """The port's `ScoringConfig` from the fields of the reference's
    (``dataclasses.asdict(sc)``): match, mismatch, gap_open, gap_extend,
    name. Unknown fields raise, so a reference that grows a field is
    noticed."""
    return ScoringConfig(**fields)


def result_from_numpy(out: dict, device) -> dict:
    """A backend result dict of numpy arrays (any integer dtype) as the
    port's tensors on `device`, each key in its contract dtype."""
    res = {}
    for key, val in out.items():
        if key not in RESULT_DTYPES:
            raise KeyError(f"not a backend result key: {key!r}")
        arr = np.array(val)  # a writable copy: the tensor owns its data
        res[key] = torch.from_numpy(arr).to(device=device,
                                            dtype=RESULT_DTYPES[key])
    return res


def result_to_numpy(out: dict) -> dict:
    """A backend result dict of the port's tensors as numpy arrays (this
    synchronises with the device)."""
    res = {}
    for key, val in out.items():
        if key not in RESULT_DTYPES:
            raise KeyError(f"not a backend result key: {key!r}")
        res[key] = val.detach().cpu().numpy()
    return res
