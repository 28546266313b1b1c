"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
(arXiv:2411.15242).

38L d_model=2048, ssm_state=64; the assigned 32H/kv=32 and d_ff=8192 describe
the *shared* transformer block that is interleaved (same weights every time)
after every 6 mamba2 layers.  38 = 6x6 scanned + 2 tail mamba layers.
Sub-quadratic backbone: designated long_500k arch.
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32000,
        superblock=(
            *(BlockDef(kind="mamba2", ffn="none"),) * 6,
            BlockDef(kind="attn", shared=True),
        ),
        n_superblocks=6,
        tail_blocks=(
            BlockDef(kind="mamba2", ffn="none"),
            BlockDef(kind="mamba2", ffn="none"),
        ),
        has_shared_block=True,
        shared_block=BlockDef(kind="attn", ffn="swiglu"),
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        superblock=(
            BlockDef(kind="mamba2", ffn="none"),
            BlockDef(kind="mamba2", ffn="none"),
            BlockDef(kind="attn", shared=True),
        ),
        n_superblocks=2,
        tail_blocks=(BlockDef(kind="mamba2", ffn="none"),),
        has_shared_block=True,
        shared_block=BlockDef(kind="attn", ffn="swiglu"),
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_chunk=16,
        tie_embeddings=True,
        q_chunk=16,
        ce_chunk=16,
    )
