"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed experts
top-6 (arXiv:2405.04434).

27L d_model=2048 16H, expert d_ff=1408, vocab=102400.  Layer 0 is a dense
SwiGLU layer (d_ff=10944) as in the released model; layers 1..26 are MLA+MoE.
(The assignment note "160 routed" matches DeepSeek-V2-full; -lite has 64
routed experts, which we follow per the primary config line.)
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=102400,
        head_blocks=(BlockDef(kind="mla", ffn="swiglu", d_ff=10944),),
        superblock=(BlockDef(kind="mla", ffn="moe"),),
        n_superblocks=26,
        moe_experts=64,
        moe_top_k=6,
        moe_d_ff=1408,
        moe_shared_d_ff=2816,  # 2 shared experts x 1408
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        rope_theta=10000.0,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab=256,
        head_blocks=(BlockDef(kind="mla", ffn="swiglu", d_ff=192),),
        superblock=(BlockDef(kind="mla", ffn="moe"),),
        n_superblocks=2,
        moe_experts=8,
        moe_top_k=2,
        moe_d_ff=96,
        moe_shared_d_ff=96,
        moe_group=64,
        kv_lora_rank=32,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        q_chunk=16,
        ce_chunk=16,
    )
