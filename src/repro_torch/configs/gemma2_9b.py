"""gemma2-9b [dense] — local+global alternating attention, logit softcaps
(arXiv:2408.00118).

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000; sliding window 4096
on the local layers, attn softcap 50, final softcap 30, sandwich norms,
sqrt(d)-scaled embeddings, tied LM head (the 256k vocab dominates memory).
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab=256000,
        superblock=(
            BlockDef(kind="attn", window=4096, ffn="geglu", post_norms=True),
            BlockDef(kind="attn", window=-1, ffn="geglu", post_norms=True),
        ),
        n_superblocks=21,
        attn_softcap=50.0,
        final_softcap=30.0,
        embed_scale=True,
        tie_embeddings=True,
        rope_theta=10000.0,
        ce_chunk=128,  # 256k vocab: keep the CE chunk buffer small
        # q_chunk divides a 16-way sequence-parallel shard of 4096 tokens
        q_chunk=256,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        superblock=(
            BlockDef(kind="attn", window=8, ffn="geglu", post_norms=True),
            BlockDef(kind="attn", window=-1, ffn="geglu", post_norms=True),
        ),
        n_superblocks=2,
        attn_softcap=50.0,
        final_softcap=30.0,
        embed_scale=True,
        tie_embeddings=True,
        q_chunk=16,
        ce_chunk=16,
    )
