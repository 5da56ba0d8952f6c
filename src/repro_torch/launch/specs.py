"""Abstract input specs and the train cells' microbatch policy: the port
of the JAX package's `launch/specs.py`.

An abstract tree is made of tensors on PyTorch's "meta" device: they carry
shape and dtype and allocate nothing, as `jax.eval_shape`'s
`ShapeDtypeStruct`s do. The models' inits build them directly
(`init_params(..., device="meta")` draws from a CPU generator into
storage-less tensors).

input_specs(cfg, shape) returns the abstract inputs each step kind
consumes:
  train   -> {tokens/embeds/patch_embeds, labels}
  prefill -> the same minus labels
  decode  -> a one-token batch; the KV / recurrent caches come from
             `abstract_cache`
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import init_cache, init_params
from repro_torch.train.train_step import init_train_state

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        if cfg.input_mode == "embeds":
            return {"embeds": _spec((B, 1, cfg.d_model), torch.bfloat16)}
        return {"tokens": _spec((B, 1), torch.int32)}
    out = {}
    if cfg.input_mode == "tokens":
        out["tokens"] = _spec((B, S), torch.int32)
    elif cfg.input_mode == "embeds":
        out["embeds"] = _spec((B, S, cfg.d_model), torch.bfloat16)
    elif cfg.input_mode == "patch_prefix":
        out["patch_embeds"] = _spec((B, cfg.num_prefix, cfg.d_model),
                                    torch.bfloat16)
        out["tokens"] = _spec((B, S - cfg.num_prefix), torch.int32)
    if shape.kind == "train":
        t_out = S - (cfg.num_prefix if cfg.input_mode == "patch_prefix"
                     else 0)
        out["labels"] = _spec((B, t_out), torch.int32)
    return out


def abstract_state(cfg: ArchConfig):
    """Abstract train state (params + AdamW moments + step).

    Archs >= 50B params use bf16 moments (memory policy; see optim.adamw).
    """
    md = torch.bfloat16 if cfg.param_count() >= 50e9 else None
    return init_train_state(cfg, 0, moments_dtype=md, device=META).tree()


def abstract_params(cfg: ArchConfig):
    return init_params(cfg, 0, device=META)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int):
    return init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=META)


def microbatches_for(cfg: ArchConfig, shape: ShapeSpec, dp_total: int,
                     budget_bytes: float = 6e9) -> int:
    """Gradient-accumulation factor for train cells.

    The reference's policy, unchanged: per-device activation memory ~=
    tokens_per_device x n_layers x d_model x C bytes with C ~ 12
    (remat-saved period residuals, flash-attention carries, f32 softmax
    state, layer-local temporaries), against a 6e9-byte budget. Both
    constants are the reference's, calibrated on its own compiled
    footprints; neither was measured on an H100. The factor must divide
    the global batch and keep each microbatch >= 1 sample per DP shard.
    """
    if shape.kind != "train":
        return 1
    tokens_per_device = shape.global_batch * shape.seq_len / dp_total
    est = tokens_per_device * cfg.n_layers * cfg.d_model * 12
    nm = max(1, math.ceil(est / budget_bytes))
    nm = 1 << (nm - 1).bit_length()  # next power of two
    nm = min(nm, shape.global_batch // dp_total)  # micro-batch >= 1/shard
    return max(nm, 1)
