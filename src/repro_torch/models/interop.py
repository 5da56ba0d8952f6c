"""Parameters and caches carried across from the JAX package.

The JAX package's trees are nested dicts whose leaves are arrays (and,
in a decode cache, its `KVCache` named tuples). `params_from_jax` takes
such a tree with numpy leaves — neither package imports the other — and
gives the port's tree: the same keys, the same layouts (dense weights
stay ``(in, out)``, period stacks keep their leading dimension), so the
carry is a copy. A train-state tree ({"params", "opt": {"m", "v",
"step"}} and the compressed step's "err") carries the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache


def params_from_jax(tree, *, device="cpu"):
    """Numpy-leaved reference tree -> the port's tensors on `device`, each
    leaf in its own dtype. A leaf with fields k, v, length becomes a
    `KVCache`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if hasattr(tree, "_fields") and set(tree._fields) == {"k", "v",
                                                          "length"}:
        return KVCache(*(params_from_jax(getattr(tree, f), device=device)
                         for f in ("k", "v", "length")))
    arr = np.array(tree)  # a writable copy: the tensor owns its data
    return torch.from_numpy(arr).to(device)
