"""Training, prefill and decode steps of the language models: the port
of the JAX package's `train/train_step.py`.

train_step features (as the reference's):
  * microbatch gradient accumulation (a loop over pre-split microbatches,
    gradients summed in `accum_dtype` or the parameter dtype, then
    divided by the count);
  * compute in `compute_dtype` with f32 params and optimiser state (cast
    at use; gradients reach the f32 leaves through the casts);
  * per-period and per-block activation checkpointing (`cfg.remat`, in
    `models.model.model_hidden`) and a token-chunked cross entropy that
    never holds the (tokens, vocab) logits;
  * global-norm clipping + AdamW + cosine schedule, the update in place.

Every step runs eagerly; the serving steps record no autograd state. The
cross-pod int8-compressed DP variant lives in `train.compressed`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import model as model_lib
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.schedules import cosine_schedule


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any

    def tree(self):
        return {"params": self.params, "opt": self.opt}


def init_train_state(cfg, key, dtype=torch.float32, moments_dtype=None, *,
                     device="cuda") -> TrainState:
    """Random params from `key` (as `models.init_params`) on `device`, and
    zeroed AdamW state."""
    params = model_lib.init_params(cfg, key, dtype, device=device)
    return TrainState(params=params, opt=adamw_init(params, moments_dtype))


def _cast_params(params, dtype):
    """Floating leaves in `dtype`. `Tensor.to` returns the same tensor
    where the dtype already matches, so a bf16 model is not copied per
    call."""
    return model_lib.tree_map(
        lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def _block_nll(head_params, xc, lc, mc):
    logits = model_lib.head_logits(head_params, xc)       # (chunk, V) f32
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[:, None].long())[:, 0]
    return torch.sum((lse - gold) * mc)


def chunked_softmax_xent(head_params, x, labels, *, chunk: int = 1024):
    """Memory-efficient cross entropy: logits are formed per token chunk,
    each chunk under an activation checkpoint (under grad mode), so the
    (tokens, vocab) tensor is never held; padded rows are masked.

    x: (B, T, d) final hidden states; labels: (B, T). Returns the mean
    NLL over the B * T tokens (0-d f32)."""
    B, T, d = x.shape
    N = B * T
    xf = x.reshape(N, d)
    lf = labels.reshape(N)
    chunk = min(chunk, N)
    pad = (-N) % chunk
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))])
        lf = torch.cat([lf, lf.new_zeros((pad,))])
    mask = (torch.arange(N + pad, device=x.device) < N).float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, N + pad, chunk):
        args = (head_params, xf[lo:lo + chunk], lf[lo:lo + chunk],
                mask[lo:lo + chunk])
        total = total + (checkpoint(_block_nll, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _block_nll(*args))
    return total / N


def loss_fn(params, cfg, batch, *, compute_dtype=torch.bfloat16,
            xent_chunk: int = 1024):
    """Next-token cross entropy. batch must carry 'labels' (B, T_out)."""
    cparams = _cast_params(params, compute_dtype)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    hidden = model_lib.model_hidden(cparams, cfg, inputs,
                                    compute_dtype=compute_dtype)
    labels = batch["labels"]
    # Align lengths: with a patch prefix the hidden states cover
    # prefix+tokens; labels only cover the token tail.
    T_out = labels.shape[1]
    hidden = hidden[:, -T_out:]
    head_params = {k: cparams[k] for k in ("lm_head", "embed")
                   if k in cparams}
    return chunked_softmax_xent(head_params, hidden, labels,
                                chunk=xent_chunk)


def value_and_grad(params, cfg, batch, compute_dtype):
    """(loss, grads tree) of `loss_fn`, every leaf of `params` set to
    require grad; a leaf the loss does not reach gets zeros, as `jax.grad`
    gives."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, cfg, batch, compute_dtype=compute_dtype)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def take(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g
    return loss.detach(), tree_map(take, params)


def make_train_step(cfg, *, num_microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000,
                    compute_dtype=torch.bfloat16, accum_dtype=None):
    """Returns train_step(state_tree, batch) -> (state_tree, metrics),
    metrics {"loss", "lr", "grad_norm"} (0-d tensors). The state's params
    and optimiser trees are updated in place and returned.

    When num_microbatches > 1 the batch must arrive PRE-SPLIT as
    (nm, B/nm, ...), as in the reference (`split_microbatches`)."""

    def step(state, batch):
        params, opt = state["params"], state["opt"]
        nm = num_microbatches
        if nm == 1:
            loss, grads = value_and_grad(params, cfg, batch, compute_dtype)
        else:
            adt = accum_dtype
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=adt or p.dtype, device=p.device), params)
            loss = 0.0
            for i in range(nm):
                mb = {k: v[i] for k, v in batch.items()}
                l_i, g_i = value_and_grad(params, cfg, mb, compute_dtype)
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                    acc.add_(g.to(adt) if adt is not None else g)
                del g_i
                loss = loss + l_i
            grads = tree_map(lambda g: g.float() / nm, grads)
            loss = loss / nm
        lr = cosine_schedule(opt["step"], peak_lr=peak_lr,
                             warmup_steps=warmup_steps,
                             total_steps=total_steps)
        params, opt, om = adamw_update(params, grads, opt, lr=lr)
        return {"params": params, "opt": opt}, {"loss": loss, "lr": lr,
                                                 **om}

    return step


def split_microbatches(batch, nm: int):
    """Host-side microbatch split: (B, ...) -> (nm, B/nm, ...), strided so
    every microbatch spans all DP shards (sample k -> micro k % nm)."""
    if nm == 1:
        return batch
    return {k: x.reshape((x.shape[0] // nm, nm) + tuple(x.shape[1:]))
            .transpose(0, 1).contiguous() for k, x in batch.items()}


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
