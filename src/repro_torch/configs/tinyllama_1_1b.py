"""tinyllama-1.1b [dense] — llama2-arch small (arXiv:2401.02385).

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        vocab=32000,
        superblock=(BlockDef(kind="attn"),),
        n_superblocks=22,
        rope_theta=10000.0,
        tie_embeddings=False,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        superblock=(BlockDef(kind="attn"),),
        n_superblocks=2,
        q_chunk=16,
        ce_chunk=16,
    )
