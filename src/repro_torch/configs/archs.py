"""The 10 assigned architectures (exact specs from the assignment block).

Sources are noted per-arch; where the assignment text and the public model
card disagree, the assignment wins (e.g. kimi-k2 is specified here as GQA
kv=8 rather than the real model's MLA).
"""
from repro_torch.configs.base import ArchConfig, register

# [audio] whisper-small — enc-dec, conv frontend stubbed to precomputed
# frame embeddings [arXiv:2212.04356]
WHISPER_SMALL = register(
    ArchConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,  # decoder layers
        enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=51865,
        rope="none",  # whisper uses learned/sinusoidal positions
        use_bias=True,
        enc_positions=1500,
    )
)

# [moe] Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2]
KIMI_K2 = register(
    ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,  # per assignment: expert FFN width
        vocab=163840,
        n_experts=384,
        n_shared_experts=1,
        top_k=8,
        d_expert=2048,
        first_dense_layers=1,
        rope_theta=5e6,
    )
)

# [moe] DeepSeek-V2 236B — MLA kv_lora=512, 2 shared + 160 routed top-6
# [arXiv:2405.04434]
DEEPSEEK_V2 = register(
    ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=1536,  # expert FFN width per assignment
        vocab=102400,
        mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        d_expert=1536,
        first_dense_layers=1,
    )
)

# [hybrid] Jamba-1.5-large — Mamba+attn 1:7 interleave, MoE 16e top-2
# [arXiv:2403.19887]
JAMBA_15_LARGE = register(
    ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab=65536,
        rope="none",  # jamba attention layers are NoPE
        n_experts=16,
        top_k=2,
        moe_every=2,  # MoE every other layer
        moe_offset=1,
        attn_every=8,  # 1 attention : 7 mamba
        attn_offset=4,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
    )
)

# [dense] StarCoder2-3B — GQA kv=2, RoPE [arXiv:2402.19173]
STARCODER2_3B = register(
    ArchConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab=49152,
        use_bias=True,
        rope_theta=1e5,
    )
)

# [dense] Qwen3-0.6B — qk_norm, GQA [hf:Qwen/Qwen3-0.6B]
QWEN3_06B = register(
    ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab=151936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1e6,
    )
)

# [dense] InternLM2-20B — GQA kv=8 [arXiv:2403.17297]
INTERNLM2_20B = register(
    ArchConfig(
        name="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=92544,
        rope_theta=1e6,
    )
)

# [dense] Command R+ 104B — GQA kv=8, no-bias [hf:CohereForAI]
COMMAND_R_PLUS = register(
    ArchConfig(
        name="command-r-plus-104b",
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab=256000,
        tie_embeddings=True,
        rope_theta=75e6,
    )
)

# [vlm] Qwen2-VL-7B — M-RoPE, dynamic resolution (stub patch embeddings)
# [arXiv:2409.12191]
QWEN2_VL_7B = register(
    ArchConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab=152064,
        rope="mrope",
        mrope_sections=(16, 24, 24),
        use_bias=True,  # qkv bias in qwen2
        n_patches=256,
        rope_theta=1e6,
    )
)

# [ssm] Mamba2-370M — SSD (state-space duality) [arXiv:2405.21060]
MAMBA2_370M = register(
    ArchConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        rope="none",
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
    )
)

ALL_ARCHS = [
    "whisper-small",
    "kimi-k2-1t-a32b",
    "deepseek-v2-236b",
    "jamba-1.5-large-398b",
    "starcoder2-3b",
    "qwen3-0.6b",
    "internlm2-20b",
    "command-r-plus-104b",
    "qwen2-vl-7b",
    "mamba2-370m",
]
