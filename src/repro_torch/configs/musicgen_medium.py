"""musicgen-medium [audio] — decoder-only over EnCodec tokens
(arXiv:2306.05284).

48L d_model=1536 24H (MHA kv=24) d_ff=6144, 4 codebooks x vocab 2048 with the
delay interleaving pattern applied by the (stubbed) EnCodec frontend; the
model sums the 4 codebook embeddings and predicts 4 parallel heads.
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab=2048,
        superblock=(BlockDef(kind="attn", ffn="gelu"),),
        n_superblocks=48,
        modality="audio",
        num_codebooks=4,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=128,
        superblock=(BlockDef(kind="attn", ffn="gelu"),),
        n_superblocks=2,
        modality="audio",
        num_codebooks=2,
        q_chunk=16,
        ce_chunk=16,
    )
