"""smollm-135m [dense] — llama-arch small (hf:HuggingFaceTB/SmolLM-135M).

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab=49152,
        superblock=(BlockDef(kind="attn"),),
        n_superblocks=30,
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke",
        n_layers=3,
        d_model=48,
        n_heads=3,
        n_kv_heads=3,
        d_ff=96,
        vocab=256,
        superblock=(BlockDef(kind="attn"),),
        n_superblocks=3,
        tie_embeddings=True,
        q_chunk=16,
        ce_chunk=16,
    )
