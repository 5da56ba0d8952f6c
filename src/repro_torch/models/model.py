"""The decoder model: embeddings + pattern stack + head.

As in the JAX package's `models/model.py`, the layers of a heterogeneous
pattern (gemma3's 5:1 local:global) are *period stacked*: parameters of
each pattern position carry a leading ``n_periods`` dimension and one
pass through the pattern runs per period; layers left over when
n_layers % len(pattern) != 0 run after it ("remainder", `rem{i}`). The
reference scans the stack; here a Python loop indexes it (views, no
copies).

Three modality frontends: tokens (embedding table, tied or untied
readout), embeds (precomputed frame embeddings), patch_prefix (patch
embeddings through a linear connector, prefixed to the token embeds).

API:
  init_params(cfg, key, dtype, device=)     -> params dict
  model_apply(params, cfg, batch)           -> (B, T, vocab) f32 logits
  init_cache(cfg, batch, max_len, device=)  -> decode cache dict
  model_decode(params, cfg, batch, cache)   -> (logits, cache)
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.batch import check_device
from repro_torch.models import blocks, layers


class LanguageModel:
    """Thin holder of (cfg, params)."""

    def __init__(self, cfg, params):
        self.cfg = cfg
        self.params = params

    @classmethod
    def create(cls, cfg, key, dtype=torch.float32, *, device="cuda"):
        return cls(cfg, init_params(cfg, key, dtype, device=device))

    def __call__(self, batch):
        return model_apply(self.params, self.cfg, batch)


def _children(tree):
    """(name, child) pairs of a tree node, or None for a leaf: a dict's
    items, a named tuple's (a KVCache's) fields. Any other value — a
    tensor, a `sharding.PartitionSpec` — is a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    return None


def tree_leaves_with_path(tree, path=()) -> list:
    """[(path, leaf)] in the tree's order; a path is the tuple of the
    names from the root (`jax.tree_util`'s key names)."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [item for k, c in kids
            for item in tree_leaves_with_path(c, path + (str(k),))]


def tree_map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` on every leaf, the tree's structure kept."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    vals = [tree_map_with_path(fn, c, path + (str(k),)) for k, c in kids]
    if isinstance(tree, dict):
        return dict(zip(tree, vals))
    return type(tree)(*vals)


def tree_map(fn, tree):
    """`fn` on every tensor of a params or cache tree (dicts, KVCaches)."""
    return tree_map_with_path(lambda _, t: fn(t), tree)


def _generator(key, device) -> torch.Generator:
    """The generator the inits draw from: `key` itself, or one seeded with
    it on `device` — on the CPU for "meta", which has no generator of its
    own (a meta tensor's draw reads and allocates nothing)."""
    gen_type = "cpu" if device.type == "meta" else device.type
    if isinstance(key, torch.Generator):
        if key.device.type != gen_type:
            raise ValueError(f"generator on {key.device}, params asked on "
                             f"{device}")
        return key
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(int(key))
    return gen


def init_params(cfg, key, dtype=torch.float32, *, device="cuda"):
    """Random parameters from `key` (an int seed or a `torch.Generator`),
    made on `device` directly in `dtype`: a bf16 model never passes
    through an f32 copy. Same tree as the reference's `init_params`.
    ``device="meta"`` gives the tree's shapes and dtypes and allocates
    nothing (`launch.specs.abstract_params`)."""
    dev = check_device(device)
    gen = _generator(key, dev)
    params = {}
    if cfg.input_mode in ("tokens", "patch_prefix"):
        params["embed"] = layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            dtype, device=dev)
    if cfg.input_mode == "patch_prefix":
        params["vision_proj"] = layers.dense_init(gen, cfg.d_model,
                                                  cfg.d_model, dtype=dtype,
                                                  device=dev)
    if cfg.input_mode == "embeds" or not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                              cfg.vocab_size, dtype=dtype,
                                              device=dev)
    params["final_norm"] = layers.rmsnorm_init(cfg.d_model, dtype, device=dev)

    n_p = cfg.n_periods
    if n_p > 0:
        params["periods"] = {
            f"pos{pos}": blocks.block_init(gen, cfg, kind, dtype, lead=(n_p,),
                                           device=dev)
            for pos, kind in enumerate(cfg.pattern)}
    for ridx, kind in enumerate(cfg.remainder):
        params[f"rem{ridx}"] = blocks.block_init(gen, cfg, kind, dtype,
                                                 device=dev)
    return params


def _embed_scale(cfg, x):
    """x * sqrt(d) with the factor rounded to x's dtype first (73.5, not
    73.32, for gemma3 in bf16), as the reference's constant is."""
    if not cfg.embed_scale:
        return x
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                            device=x.device)


def _inputs_to_x(params, cfg, batch, compute_dtype):
    """Returns (x (B,T,d), positions (B,T))."""
    if cfg.input_mode == "tokens":
        x = layers.embed_apply(params["embed"], batch["tokens"],
                               compute_dtype)
    elif cfg.input_mode == "embeds":
        x = batch["embeds"].to(compute_dtype)
    elif cfg.input_mode == "patch_prefix":
        patches = layers.dense_apply(params["vision_proj"],
                                     batch["patch_embeds"].to(compute_dtype))
        toks = layers.embed_apply(params["embed"], batch["tokens"],
                                  compute_dtype)
        x = torch.cat([patches, toks], dim=1)
    else:
        raise ValueError(cfg.input_mode)
    x = _embed_scale(cfg, x)
    B, T = x.shape[0], x.shape[1]
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)
    return x, positions


def _period(tree, i):
    return tree_map(lambda a: a[i], tree)


def _remat(fn):
    """`fn` under a non-reentrant activation checkpoint: its forward saves
    only its inputs and runs again in the backward."""
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _apply_period(pp, x, *, cfg, positions, rope, remat_blocks):
    for pos, kind in enumerate(cfg.pattern):
        fn = functools.partial(blocks.block_apply, cfg=cfg, kind=kind,
                               positions=positions, rope=rope)
        if remat_blocks:
            # Nested remat, as the reference's: the period's checkpoint
            # replays the whole period in the backward; a checkpoint per
            # block bounds the live set of that replay to one block.
            fn = _remat(fn)
        x = fn(pp[f"pos{pos}"], x=x)
    return x


def model_hidden(params, cfg, batch, *, compute_dtype=torch.float32):
    """Forward pass up to the final norm -> hidden states (B, T, d).

    With `cfg.remat` and grad mode on, each period runs under an
    activation checkpoint with a nested checkpoint per block
    (`torch.utils.checkpoint`, non-reentrant), as the reference's
    `jax.checkpoint`s; the values are the same either way."""
    x, positions = _inputs_to_x(params, cfg, batch, compute_dtype)
    # One RoPE table for every layer.
    rope = layers.rope_tables(positions[:, None, :], cfg.head_dim,
                              cfg.rope_theta, dtype=compute_dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    period_fn = functools.partial(_apply_period, cfg=cfg,
                                  positions=positions, rope=rope,
                                  remat_blocks=remat)
    if remat:
        period_fn = _remat(period_fn)
    for i in range(cfg.n_periods):
        x = period_fn(_period(params["periods"], i), x)
    for ridx, kind in enumerate(cfg.remainder):
        x = blocks.block_apply(params[f"rem{ridx}"], cfg, kind, x, positions,
                               rope=rope)
    return layers.rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)


def head_logits(params, x):
    """The LM head (untied dense or tied embedding), formed in x's dtype
    and then cast -> f32 logits."""
    if "lm_head" in params:
        logits = layers.dense_apply(params["lm_head"], x)
    else:
        logits = layers.embed_attend(params["embed"], x)
    return logits.float()


def model_apply(params, cfg, batch, *, compute_dtype=torch.float32):
    """Prefill forward pass -> f32 logits (B, T, vocab)."""
    x = model_hidden(params, cfg, batch, compute_dtype=compute_dtype)
    return head_logits(params, x)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """Empty decode caches, period-stacked (a leading n_periods dimension)
    plus one per remainder layer: KVCaches (lengths (n_periods,)) for the
    attention kinds, dicts of state tensors for the recurrent kinds."""
    device = check_device(device)
    cache = {}
    if cfg.n_periods > 0:
        cache["periods"] = {
            f"pos{pos}": blocks.block_cache_init(
                cfg, kind, batch, max_len, dtype, device=device,
                lead=(cfg.n_periods,))
            for pos, kind in enumerate(cfg.pattern)}
    for ridx, kind in enumerate(cfg.remainder):
        cache[f"rem{ridx}"] = blocks.block_cache_init(
            cfg, kind, batch, max_len, dtype, device=device)
    return cache


def model_decode(params, cfg, batch, cache, *, compute_dtype=torch.float32,
                 masked_cache_write=False):
    """One-token decode step.

    batch: {"tokens": (B, 1)} (or {"embeds": (B, 1, d)}).
    Returns (logits (B, 1, vocab) f32, cache) — the cache updated in
    place, through views of its period stacks (`blocks.block_decode`
    writes every KV entry and recurrent state into the cache's own
    tensors), so the caches the blocks return are not gathered.
    """
    if cfg.input_mode in ("tokens", "patch_prefix"):
        x = layers.embed_apply(params["embed"], batch["tokens"],
                               compute_dtype)
    else:
        x = batch["embeds"].to(compute_dtype)
    x = _embed_scale(cfg, x)

    for i in range(cfg.n_periods):
        pp = _period(params["periods"], i)
        cc = _period(cache["periods"], i)
        for pos, kind in enumerate(cfg.pattern):
            x, _ = blocks.block_decode(pp[f"pos{pos}"], cfg, kind, x,
                                       cc[f"pos{pos}"],
                                       masked_write=masked_cache_write)
    for ridx, kind in enumerate(cfg.remainder):
        x, _ = blocks.block_decode(params[f"rem{ridx}"], cfg, kind, x,
                                   cache[f"rem{ridx}"],
                                   masked_write=masked_cache_write)

    x = layers.rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    return head_logits(params, x), cache
