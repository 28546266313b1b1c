"""llava-next-34b [vlm] — anyres tiling; transformer backbone only
(hf:llava-hf/llava-v1.6 family).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The vision tower is
a STUB per the assignment: ``input_specs()`` supplies precomputed anyres
patch embeddings [B, img_tokens, d_model]; the backbone concatenates them
ahead of the text tokens and masks them out of the loss.
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        superblock=(BlockDef(kind="attn"),),
        n_superblocks=60,
        modality="vlm",
        img_tokens=1152,  # anyres: base 576 + one 576-patch tile
        rope_theta=5000000.0,
        train_microbatch=2,  # halve the d=7168 residual stack
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        superblock=(BlockDef(kind="attn"),),
        n_superblocks=2,
        modality="vlm",
        img_tokens=8,
        q_chunk=16,
        ce_chunk=16,
    )
