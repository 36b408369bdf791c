"""Architecture config system (the JAX package's ``configs/base.py``, field
for field: a config moves between the two packages unchanged).

One :class:`ArchConfig` per assigned architecture (see sibling modules), plus
``reduced()`` views used by the CPU smoke tests.  Everything the model code
needs is derived from this dataclass — family-specific fields are simply
unused by other families.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    use_bias: bool = False
    rope: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    tie_embeddings: bool = False

    # --- MLA (DeepSeek-style multi-head latent attention) ---
    mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 -> no query compression
    rope_head_dim: int = 64

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0  # expert FFN hidden size (0 -> d_ff)
    moe_every: int = 1  # MoE at layers where (layer % moe_every == moe_offset)
    moe_offset: int = 0
    first_dense_layers: int = 0  # leading layers stay dense (DeepSeek style)
    capacity_factor: float = 1.0
    moe_group_size: int = 512  # GShard-style dispatch group (DESIGN §3)

    # --- SSM / Mamba2 (SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    attn_every: int = 0  # hybrid: attention at layers where l % attn_every == attn_offset
    attn_offset: int = 0

    # --- encoder-decoder (whisper-style) ---
    enc_layers: int = 0
    enc_positions: int = 1500  # stub audio frames

    # --- VLM stub frontend ---
    n_patches: int = 0

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_expert_(self) -> int:
        return self.d_expert or self.d_ff

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, layer: int) -> bool:
        if self.n_experts == 0 or layer < self.first_dense_layers:
            return False
        return layer % self.moe_every == self.moe_offset

    def is_attn_layer(self, layer: int) -> bool:
        if self.family not in ("hybrid",):
            return self.family != "ssm"
        return self.attn_every > 0 and layer % self.attn_every == self.attn_offset

    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers), for roofline."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for l in range(self.n_layers):
            if self.family in ("ssm", "hybrid") and not self.is_attn_layer(l):
                di, ns, h = self.d_inner, self.ssm_state, self.n_ssm_heads
                total += d * (2 * di + 2 * ns + h)  # in_proj -> z, x, B, C, dt
                total += self.ssm_conv_width * (di + 2 * ns)  # causal conv
                total += di * d + di  # out_proj + gated norm
                total += 3 * h  # A_log, D, dt_bias
            else:
                hd = self.head_dim_
                if self.mla:
                    total += d * (self.kv_lora_rank + self.rope_head_dim)
                    total += self.kv_lora_rank * self.n_heads * 2 * hd
                    q_in = self.q_lora_rank or d
                    if self.q_lora_rank:
                        total += d * self.q_lora_rank
                    total += q_in * self.n_heads * (hd + self.rope_head_dim)
                    total += self.n_heads * hd * d
                else:
                    total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                    total += self.n_heads * hd * d
            if self.is_moe_layer(l):
                fe = self.d_expert_
                total += self.n_experts * 3 * d * fe + d * self.n_experts
                total += self.n_shared_experts * 3 * d * fe
            elif self.family != "ssm" or self.is_attn_layer(l):
                total += 3 * d * self.d_ff
        for l in range(self.enc_layers):
            hd = self.head_dim_
            total += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            total += 3 * d * self.d_ff
            # decoder cross-attention (paired with each decoder layer)
        if self.enc_layers:
            total += self.n_layers * (
                d * self.head_dim_ * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * self.head_dim_ * d
            )
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        for l in range(self.n_layers):
            if self.is_moe_layer(l):
                fe = self.d_expert_
                inactive = (self.n_experts - self.top_k) * 3 * self.d_model * fe
                total -= inactive
        return total

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else self.attn_every),
            d_model=128,
            mrope_sections=(4, 6, 6),  # scaled to head_dim=32 (half dim 16)
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab=512,
            kv_lora_rank=64,
            q_lora_rank=64 if self.q_lora_rank else 0,
            rope_head_dim=16,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            d_expert=64 if self.d_expert else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            ssm_chunk=32,
            enc_layers=min(self.enc_layers, 2),
            enc_positions=min(self.enc_positions, 64),
            n_patches=min(self.n_patches, 16),
            moe_group_size=64,
            # cap == group size -> no token dropping, so decode logits match
            # prefill exactly in the smoke tests
            capacity_factor=4.0,
            param_dtype="float32",
            compute_dtype="float32",
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs.archs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs.archs  # noqa: F401

    return sorted(_REGISTRY)
