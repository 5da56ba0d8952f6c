"""Closed-form roofline cost model per (arch x shape x mesh) cell: the
port of the JAX package's `roofline/analytic.py`.

The reference's own bound for a record, computed from first principles
and the same for whatever implements the work. Two halves:

  * the alignment workload (``arch == "rapidx-align"``,
    `alignment_roofline`), on the H100's int32 record by default
    (`analysis.H100_INT32`: the DP is int32 work outside the tensor
    cores);
  * the language models, on the H100's dense bf16 record by default
    (`analysis.H100`), with the train step's microbatch count from
    `launch.specs.microbatches_for`.

Accounting conventions of the LM half (the reference's; flops = 2 x MACs):
  * train pass multiplier: forward 1x + backward 2x + remat re-forward 1x.
  * causal attention context: (S+1)/2 average; windowed: min(W, that).
  * weights are read in bf16 once per pass per microbatch; MoE reads ALL
    experts (every expert is activated by some token in the batch).
  * TP all-reduce: 2 per layer on the (tokens_local, d) activations
    (attention out + FFN out), bf16, x2 ring factor, per pass.
  * gradient reduce-scatter over data: ~P x 4B per device.
  * decode with masked cache write rewrites the cache (3x traffic vs 1x).
"""

from __future__ import annotations

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.specs import microbatches_for
from repro_torch.roofline.analysis import (H100, H100_INT32, Hardware,
                                           roofline_terms)


def _layer_kinds(cfg):
    for li in range(cfg.n_layers):
        yield cfg.pattern[li % len(cfg.pattern)]


def _per_token_layer_flops(cfg, kind, l_ctx):
    d, f = cfg.d_model, cfg.d_ff
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    glu = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    attn_proj = 2 * d * (Hq * Dh * 2 + Hkv * Dh * 2)
    attn_score = 2 * 2 * l_ctx * Hq * Dh
    mlp = 2 * glu * d * f
    moe = (2 * 3 * d * cfg.moe_d_ff * cfg.moe_top_k
           + 2 * d * cfg.moe_num_experts
           + (2 * 3 * d * cfg.moe_shared_d_ff + 2 * d
              if cfg.moe_shared_d_ff else 0))
    if kind in ("attn", "local"):
        return attn_proj + attn_score + mlp
    if kind in ("moe", "moe_swa"):
        return attn_proj + attn_score + moe
    if kind == "rglru":
        return 2 * 5 * d * d + 2 * 4 * d + mlp
    if kind == "mlstm":
        c = cfg.mlstm_chunk
        proj = 2 * 4 * d * Hq * Dh
        intra = 2 * 2 * c * Hq * Dh          # chunk-local attention
        state = 2 * 2 * Dh * Dh * Hq / max(c, 1)  # amortised state update
        return proj + intra + state
    if kind == "slstm":
        Dh_s = d // Hq
        return 2 * (4 * d * d + 4 * d * Dh_s) + 2 * d * d
    raise ValueError(kind)


def _weight_bytes(cfg, active_only: bool, dtype_bytes: int = 2) -> float:
    p = (cfg.active_param_count() if active_only else cfg.param_count())
    return p * dtype_bytes


#: Divergence rate assumed for the RLE host-fetch estimate: one op-run
#: boundary per ~20 bases (read error + true-variant events), i.e. each
#: event ends an M run and opens/closes a gap or mismatch context.
ALIGN_DIVERGENCE = 0.05

#: Fixed cost charged per device dispatch: launch plus host mediation of
#: one group boundary (Python driver, argument staging, the fetch). An
#: assumed model charge, the reference's figure, not a measurement of this
#: package: the pipelined scheduler pays it once per dispatch group, the
#: persistent dispatch once per request.
DISPATCH_OVERHEAD_S = 100e-6

#: Band-state bytes per lane touched per wavefront step, by storage
#: precision: int32 keeps u/v/x/y/H at 4 B each; narrow packs the four
#: difference planes to int8 and H to a band-relative int16 (paper §IV
#: bit-width reduction) — 4 x 1 + 2 bytes.
CELL_STATE_BYTES = {"int32": 5 * 4, "narrow": 4 * 1 + 2}


def alignment_roofline(record: dict, hw: Hardware = H100_INT32) -> dict:
    """Roofline for the rapidx-align cells (the paper's own workload).

    Per wavefront step each lane does ~15 int32 operations (Eq. 4 update +
    masks + traceback encode); a pair of length L runs 2L steps over B
    lanes (equal-length pairs: the trimmed sweep t_max equals the true
    n + m = 2L). Traceback streams the *packed* plane — two 4-bit flags
    per byte, (2L x ceil(B/2)) uint8 per pair (DESIGN.md §5) — to HBM,
    where the on-device walker reads it back and reduces it to RLE
    CIGARs; sequences stream in once. The host-interface fetch is
    therefore charged with the **RLE bytes** (5 bytes per CIGAR segment
    + the per-pair length), not the packed plane — the plane never
    crosses the host interface (DESIGN.md §5). Collectives are zero by
    construction (tile independence).

    X-drop-aware trip counting: the record may carry ``reject_fraction``
    (share of pairs the xdrop rule retires, 0.0 = off) and
    ``reject_step_frac`` (the mean retiring step as a fraction of the
    full 2L sweep, default 0.5). The model then charges each pair its
    *expected surviving steps* — compute and tb traffic scale by
    ``1 - reject_fraction * (1 - reject_step_frac)`` — and drops the RLE
    fetch for retired pairs (they return only scalars). Defaults
    reproduce the xdrop-off numbers exactly.

    Dispatch-mode-aware launch charging: the record may carry
    ``dispatch`` ("pipelined"/"persistent"), ``n_groups`` and
    ``cell_dtype``. The pipelined scheduler pays `DISPATCH_OVERHEAD_S`
    once per dispatch group; the persistent dispatch pays it once per
    request (`core.engine` dispatch="persistent") — `step_time_total_s`
    adds that charge to the overlap bound and the pairs/s bound uses it.
    `cell_state_bytes_per_pair` reports the band-state bytes the sweep
    touches under the chosen cell dtype (an on-chip working set, NOT HBM
    traffic).
    """
    L = record["length"]
    B_band = record["band"]
    batch = record["global_batch"]
    chips = 1
    for s in record.get("mesh_shape", [1]):
        chips *= s
    dp = chips  # alignment shards batch over every axis it can
    pairs_dev = batch / min(dp, batch)
    # Expected surviving step fraction under xdrop: a retired pair stops
    # sweeping (and storing tb) at its retiring step instead of 2L.
    reject_frac = float(record.get("reject_fraction", 0.0))
    reject_step_frac = float(record.get("reject_step_frac", 0.5))
    survive_steps = 1.0 - reject_frac * (1.0 - reject_step_frac)
    ops = 2 * L * B_band * 15 * survive_steps  # int ops per pair
    flops_dev = pairs_dev * ops
    # packed tb plane per pair (expected stored rows under xdrop)
    tb_bytes = 2 * L * ((B_band + 1) // 2) * survive_steps
    seq_bytes = 2 * L * 4
    # HBM traffic: TBM store by the compute + read-back by the on-device
    # decoder (the walk's gathers re-touch at most the plane once).
    bytes_dev = pairs_dev * (2 * tb_bytes + seq_bytes)
    # Host-interface fetch per pair: the trimmed RLE arrays. Segment
    # count ~ 2 boundaries per divergence event + 1 (DESIGN.md §4b),
    # over the ~L ops of a near-diagonal alignment path (the path is L
    # ops long, not the 2L wavefront sweeps it takes to compute it).
    # Retired pairs have no path — they fetch only the scalar row.
    rle_segments = 2 * ALIGN_DIVERGENCE * L + 1
    host_fetch_bytes = pairs_dev * (
        5 * rle_segments * (1.0 - reject_frac) + 4)
    terms = roofline_terms(flops_dev, bytes_dev, 0.0, hw)
    dispatch = record.get("dispatch", "pipelined")
    n_groups = int(record.get("n_groups", 1))
    launches = 1 if dispatch == "persistent" else n_groups
    dispatch_overhead_s = launches * DISPATCH_OVERHEAD_S
    step_time_total_s = terms["step_time_overlap_s"] + dispatch_overhead_s
    cell_dtype = record.get("cell_dtype", "int32")
    return {
        "cell": f"rapidx-align/{record['shape']}/{record.get('mesh', '?')}",
        "chips": chips,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": 0.0,
        "host_fetch_bytes_per_device": host_fetch_bytes,
        "tb_plane_bytes_per_pair": tb_bytes,
        "dispatch": dispatch,
        "reject_fraction": reject_frac,
        "surviving_step_fraction": survive_steps,
        "launches": launches,
        "dispatch_overhead_s": dispatch_overhead_s,
        "step_time_total_s": step_time_total_s,
        "cell_state_bytes_per_pair":
            2 * L * B_band * CELL_STATE_BYTES[cell_dtype],
        **terms,
        "pairs_per_s_per_chip_bound":
            1.0 / max(step_time_total_s / pairs_dev, 1e-30),
    }


def analytic_roofline(record: dict, hw: Hardware | None = None) -> dict:
    """record: arch/shape/mesh + mesh_shape (a dry-run record's keys).
    `hw` defaults to `H100_INT32` for the alignment workload and to
    `H100` (dense bf16) for the language models."""
    if record.get("arch") == "rapidx-align":
        return alignment_roofline(record, H100_INT32 if hw is None else hw)
    hw = H100 if hw is None else hw
    arch, shape_name = record["arch"], record["shape"]
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_shape = record.get("mesh_shape") or [16, 16]
    chips = 1
    for s in mesh_shape:
        chips *= s
    model_par = mesh_shape[-1]
    dp = chips // model_par
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (1 if shape.kind == "decode" else S)
    tokens_dev = tokens / dp

    # ---- FLOPs ----
    l_full = (S + 1) / 2 if shape.kind != "decode" else min(S, 10**12)
    flops_tok = 0.0
    for kind in _layer_kinds(cfg):
        w = cfg.window if kind in ("local", "moe_swa") else None
        if shape.kind == "decode":
            l_ctx = min(w, S) if w else S
        else:
            l_ctx = min(w, l_full) if w else l_full
        flops_tok += _per_token_layer_flops(cfg, kind, l_ctx)
    head = 2 * cfg.d_model * cfg.vocab_size
    embed = head if (cfg.vocab_size >= 8192
                     and cfg.input_mode != "embeds") else 0
    flops_tok += head + embed
    pass_mult = 4.0 if shape.kind == "train" else 1.0
    flops_total = flops_tok * tokens * pass_mult
    flops_dev = flops_total / chips

    # ---- memory bytes per device ----
    nm = (microbatches_for(cfg, shape, dp) if shape.kind == "train" else 1)
    passes = 3 if shape.kind == "train" else 1
    wbytes = _weight_bytes(cfg, active_only=(shape.kind == "decode"))
    weight_traffic = wbytes * passes * nm     # gathered per microbatch
    act_traffic = tokens_dev * cfg.d_model * cfg.n_layers * 8 * passes
    opt_traffic = (cfg.param_count() * (6 * 4) / chips
                   if shape.kind == "train" else 0)
    cache_traffic = 0.0
    if shape.kind == "decode":
        per_layer = 0.0
        for kind in _layer_kinds(cfg):
            if kind in ("attn", "moe"):
                sl = S
            elif kind in ("local", "moe_swa"):
                sl = min(cfg.window, S)
            else:
                sl = 0  # recurrent state, negligible
            per_layer += sl * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        rw = 3.0 if record.get("masked_cache_write") else 1.0
        cache_traffic = (B / dp) * per_layer * (1 + rw) / 2
    bytes_dev = weight_traffic + act_traffic + opt_traffic + cache_traffic

    # ---- collective bytes per device ----
    # The reference's collective model, calibrated by it against XLA's
    # compiled HLO for TPU meshes (there GSPMD contracts matmuls over the
    # FSDP-sharded dim in place, so no per-use weight all-gather is
    # charged). Not calibrated on the card: the port runs no sharded LM
    # step. Volumes: 2 TP activation reductions per layer (x2 ring
    # factor, bf16), the per-step gradient reduce-scatter, and the
    # embedding / cross-entropy reductions.
    coll = 0.0
    act_red = 2 * tokens_dev * cfg.d_model * 2 * 2 * cfg.n_layers
    if shape.kind == "train":
        coll += act_red * passes
        coll += cfg.param_count() * 4 / dp * 2   # grad reduce-scatter
        coll += tokens_dev * 4 * 2               # CE logsumexp reductions
    elif shape.kind == "prefill":
        coll += act_red
    else:  # decode
        coll += 2 * (B / dp) * cfg.d_model * 2 * 2 * cfg.n_layers
        # S- or head-sharded cache attention psum of scores/outputs.
        coll += (B / dp) * cfg.n_heads * cfg.head_dim * 4 * cfg.n_layers

    terms = roofline_terms(flops_dev, bytes_dev, coll, hw)
    out = {
        "cell": f"{arch}/{shape_name}/{record.get('mesh', '?')}",
        "chips": chips,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll,
        "microbatches": nm,
        **terms,
    }
    # Useful-flops ratio and MFU bound.
    n_active = cfg.active_param_count()
    model_fl = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    out["model_flops_total"] = model_fl
    out["useful_flops_ratio"] = model_fl / flops_total if flops_total else 0
    t = terms["step_time_overlap_s"]
    out["mfu_bound"] = (model_fl / t) / (chips * hw.peak_flops) if t else 0.0
    return out
