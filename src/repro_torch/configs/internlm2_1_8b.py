"""internlm2-1.8b [dense] — GQA (arXiv:2403.17297).

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92544,
        superblock=(BlockDef(kind="attn"),),
        n_superblocks=24,
        rope_theta=1000000.0,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab=384,
        superblock=(BlockDef(kind="attn"),),
        n_superblocks=2,
        rope_theta=1000000.0,
        q_chunk=16,
        ce_chunk=16,
    )
