"""All architecture configs, registered in one place.

Each entry was originally a per-arch module under ``repro/configs/``;
they are consolidated here because the per-file layout was seed-template
scaffolding — nothing imported the modules individually, only this
registry. Sources and modelling notes are kept inline per entry.

Registered archs (10):
  dense:  gemma3-27b, qwen2.5-14b, qwen3-0.6b, stablelm-3b
  moe:    mixtral-8x22b, qwen2-moe-a2.7b
  hybrid: recurrentgemma-9b
  ssm:    xlstm-125m
  audio:  musicgen-medium
  vlm:    paligemma-3b
"""

from repro_torch.configs.base import ArchConfig, register

# gemma3-27b [dense] — 5:1 local:global interleaving, 128k context.
# 62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
# [hf:google/gemma-3 family; unverified]. Pattern: 5 sliding-window
# layers (W=1024) then 1 global layer; head_dim=128; GeGLU; sqrt(d)
# embed scale. long_500k RUNS: 5/6 of layers have ring-buffer caches.
GEMMA3_27B = register(ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    mlp_kind="geglu",
    rope_theta=1_000_000.0,
    embed_scale=True,
    qk_norm=True,
    tie_embeddings=True,
    subquadratic=True,
    source="hf:google/gemma-3-27b-pt geometry; 5:1 local:global",
))

# mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
# 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2
# [arXiv:2401.04088; hf]. SWA window 4096 -> bounded KV cache, so
# long_500k RUNS. Renormalised top-2 gates.
MIXTRAL_8X22B = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,          # == expert width (all FFNs are expert FFNs)
    vocab_size=32768,
    pattern=("moe_swa",),
    window=4096,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=16384,
    moe_renormalize=True,
    tie_embeddings=False,
    subquadratic=True,
    source="arXiv:2401.04088 (Mixtral), 8x22B geometry + SWA",
))

# musicgen-medium [audio] — decoder-only over EnCodec tokens.
# 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284;
# hf]. The EnCodec frontend is a STUB: input_specs() provides
# precomputed frame embeddings (B, T, d). GELU MLP, full attention,
# sinusoidal->RoPE simplification noted in DESIGN.md.
MUSICGEN_MEDIUM = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    pattern=("attn",),
    mlp_kind="gelu",
    rope_theta=10000.0,
    input_mode="embeds",
    tie_embeddings=False,
    subquadratic=False,
    source="arXiv:2306.05284 (MusicGen medium)",
))

# paligemma-3b [vlm] — SigLIP frontend stub + gemma decoder backbone.
# 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216
# [arXiv:2407.07726; hf]. The SigLIP vision tower is a STUB:
# input_specs() provides 256 precomputed patch embeddings prefixed to
# the token stream. Gemma-style: GeGLU MLP, sqrt(d) embedding scale,
# tied embeddings, full attention.
PALIGEMMA_3B = register(ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    pattern=("attn",),
    mlp_kind="geglu",
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
    input_mode="patch_prefix",
    num_prefix=256,
    subquadratic=False,
    source="arXiv:2407.07726 (PaliGemma); gemma-2b backbone geometry",
))

# qwen2.5-14b [dense] — GQA with QKV bias.
# 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064
# [hf:Qwen/Qwen2.5 family; hf]. SwiGLU, RoPE theta 1e6, untied head.
QWEN2_5_14B = register(ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=False,
    subquadratic=False,
    source="hf:Qwen/Qwen2.5-14B",
))

# qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + shared expert.
# 24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e
# top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. The "4 shared" experts are
# fused as one 4x-width (5632) sigmoid-gated shared MLP, as in the HF
# reference. Top-4 gates NOT renormalised.
QWEN2_MOE_A2_7B = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    pattern=("moe",),
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    moe_num_experts=60,
    moe_top_k=4,
    moe_d_ff=1408,
    moe_shared_d_ff=5632,
    moe_renormalize=False,
    tie_embeddings=False,
    subquadratic=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))

# qwen3-0.6b [dense] — qk-norm GQA; head_dim decoupled from d_model.
# 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936
# [hf:Qwen/Qwen3 family; hf]. head_dim=128 (> d_model/n_heads —
# exercises the decoupled-projection path), qk_norm, SwiGLU, tied
# embeddings.
QWEN3_0_6B = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    subquadratic=False,
    source="hf:Qwen/Qwen3-0.6B",
))

# recurrentgemma-9b [hybrid] — Griffin: RG-LRU + local attention, 1:2.
# 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000
# [arXiv:2402.19427; unverified]. Pattern: (rglru, rglru, local) — two
# recurrent blocks per local-attention block (W=2048), head_dim=256,
# GeGLU. Bounded decode state (RG-LRU h + ring buffers).
RECURRENTGEMMA_9B = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    mlp_kind="geglu",
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2402.19427 (Griffin/RecurrentGemma-9B)",
))

# stablelm-3b [dense] — MHA (kv == heads).
# 32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304
# [hf:stabilityai/stablelm family; unverified]. SwiGLU, RoPE 10k.
STABLELM_3B = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
    subquadratic=False,
    source="hf:stabilityai/stablelm-3b-4e1t geometry",
))

# xlstm-125m [ssm] — alternating mLSTM / sLSTM blocks, no FFN.
# 12L d_model=768 4H d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
# Matrix-memory mLSTM (chunkwise-parallel) + scalar sLSTM (true
# recurrence). O(1) decode state.
XLSTM_125M = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm", "slstm"),
    mlp_kind="gelu",
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2405.04517 (xLSTM 125M class)",
))
