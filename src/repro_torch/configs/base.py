"""Architecture/config schema and registry.

Each assigned architecture is an `ArchConfig` (exact public-literature
hyperparameters, per-file under configs/) plus a reduced smoke variant
(`cfg.reduced()`) used by CPU tests. The four assigned input shapes are
`ShapeSpec`s; `long_500k` carries the sub-quadratic requirement flag that
the dry-run uses to skip pure full-attention archs (DESIGN.md
§Arch-applicability).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # Layer pattern, repeating; kinds: attn, local, moe, moe_swa, rglru,
    # mlstm, slstm. Remainder layers (n_layers % len(pattern)) take the
    # pattern prefix.
    pattern: tuple[str, ...] = ("attn",)
    window: Optional[int] = None        # sliding window for local/moe_swa
    mlp_kind: str = "swiglu"
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    embed_scale: bool = False           # gemma-style sqrt(d) embed scaling
    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_d_ff: int = 0
    moe_renormalize: bool = True
    # §Perf lever: contract expert einsums over the FSDP-sharded d dim
    # (weights-stationary) instead of gathering expert weights per use.
    moe_data_contract: bool = False
    # Modality frontend stub
    input_mode: str = "tokens"          # tokens | embeds | patch_prefix
    num_prefix: int = 0                 # patch-embedding count (paligemma)
    # Runtime knobs
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    scan_layers: bool = True
    remat: bool = True
    attn_impl: str = "chunked"
    attn_chunk: int = 512
    mlstm_chunk: int = 64
    # Long-context capability: True when decode state is bounded
    # (recurrent state / ring buffers / SWA) — gates long_500k.
    subquadratic: bool = False
    source: str = ""                    # provenance note

    # ---- derived ----
    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> tuple[str, ...]:
        return self.pattern[:self.n_layers % len(self.pattern)]

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f = self.d_model, self.d_ff
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2
        mlp = 3 * d * f if self.mlp_kind in ("swiglu", "geglu") else 2 * d * f
        moe = (self.moe_num_experts * 3 * d * self.moe_d_ff
               + d * self.moe_num_experts
               + (3 * d * self.moe_shared_d_ff + d if self.moe_shared_d_ff
                  else 0))
        per_kind = {
            "attn": attn + mlp, "local": attn + mlp,
            "moe": attn + moe, "moe_swa": attn + moe,
            "rglru": 2 * d * d + 2 * d * d + 4 * d + mlp,  # branches + gates
            "mlstm": 4 * d * self.n_heads * self.head_dim + 2 * d * self.n_heads,
            "slstm": 4 * d * d + 4 * (d // self.n_heads) * d + d * d,
        }
        total = 0
        for li in range(self.n_layers):
            total += per_kind[self.pattern[li % len(self.pattern)]]
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.moe_num_experts:
            return self.param_count()
        full_moe = self.moe_num_experts * 3 * self.d_model * self.moe_d_ff
        active_moe = self.moe_top_k * 3 * self.d_model * self.moe_d_ff
        n_moe_layers = sum(1 for li in range(self.n_layers)
                           if "moe" in self.pattern[li % len(self.pattern)])
        return self.param_count() - n_moe_layers * (full_moe - active_moe)

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU smoke tests."""
        pat = self.pattern
        n_layers = max(len(pat), 2)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            window=min(self.window, 16) if self.window else None,
            moe_num_experts=min(self.moe_num_experts, 4) or 0,
            moe_top_k=min(self.moe_top_k, 2) or 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            moe_shared_d_ff=64 if self.moe_shared_d_ff else 0,
            num_prefix=4 if self.num_prefix else 0,
            attn_chunk=32,
            mlstm_chunk=16,
            scan_layers=self.scan_layers,
            remat=False,
        )


REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(REGISTRY)
