"""Serving steps of the language models: prefill and one-token decode.

The port of the JAX package's `train/train_step.py` as far as serving
needs it: `_cast_params`, `make_prefill_step`, `make_serve_step`. The
loss, the train step and microbatching wait for the training slice
(ROADMAP A11c). Both steps run eagerly; neither records autograd state.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as model_lib


def _cast_params(params, dtype):
    """Floating leaves in `dtype`. `Tensor.to` returns the same tensor
    where the dtype already matches, so a bf16 model is not copied per
    call."""
    return model_lib.tree_map(
        lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def make_prefill_step(cfg, *, compute_dtype=torch.bfloat16,
                      last_only: bool = True):
    """Inference prefill: full-sequence forward -> f32 logits.

    last_only=True returns only the final position's logits (what a
    serving engine needs to start decoding); last_only=False keeps all
    positions (scoring).
    """
    cfg = dataclasses.replace(cfg, remat=False)

    @torch.no_grad()
    def prefill(params, batch):
        cparams = _cast_params(params, compute_dtype)
        hidden = model_lib.model_hidden(cparams, cfg, batch,
                                        compute_dtype=compute_dtype)
        if last_only:
            hidden = hidden[:, -1:]
        return model_lib.head_logits(cparams, hidden)

    return prefill


def make_serve_step(cfg, *, compute_dtype=torch.bfloat16,
                    masked_cache_write: bool = False):
    """One-token decode: (params, token_batch, cache) -> (logits, cache),
    the cache updated in place.

    masked_cache_write: write the new KV entry by an elementwise select
    (see models.attention.attention_decode) instead of an indexed copy.
    """

    @torch.no_grad()
    def serve(params, batch, cache):
        cparams = _cast_params(params, compute_dtype)
        return model_lib.model_decode(
            cparams, cfg, batch, cache, compute_dtype=compute_dtype,
            masked_cache_write=masked_cache_write)

    return serve
