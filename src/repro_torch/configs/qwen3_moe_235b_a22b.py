"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 (hf:Qwen/Qwen3-30B-A3B
family scaled per assignment).

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936, top-8 of 128.
Adafactor optimizer so the 235B-parameter optimizer state fits a single
256-device mesh.
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab=151936,
        superblock=(BlockDef(kind="attn", ffn="moe"),),
        n_superblocks=94,
        moe_experts=128,
        moe_top_k=8,
        moe_d_ff=1536,
        moe_norm_topk=True,
        rope_theta=1000000.0,
        optimizer="adafactor",
        train_microbatch=8,  # shrinks the layer-stack residuals
        serve_fsdp=True,  # 470 GB of bf16 weights need the batch axes too
        # 64 q-heads shard 16-way (Megatron attention); k/v (4 heads) replicate
        attn_head_shard=True,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab=256,
        superblock=(BlockDef(kind="attn", ffn="moe"),),
        n_superblocks=2,
        moe_experts=8,
        moe_top_k=2,
        moe_d_ff=96,
        moe_group=64,
        rope_theta=1000000.0,
        optimizer="adafactor",
        q_chunk=16,
        ce_chunk=16,
    )
