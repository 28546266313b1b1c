"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

48L d_model=2048 4H d_ff=0 vocab=50304.  d_ff=0 means the blocks are
projection blocks (mLSTM proj-factor 2) with no separate FFN; pattern is
7 mLSTM : 1 sLSTM per superblock (48 = 6 x 8).  Sub-quadratic: designated
long_500k arch (recurrent O(1)-state decode).
"""

from repro_torch.models.config import BlockDef, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        superblock=(
            *(BlockDef(kind="mlstm", ffn="none"),) * 7,
            BlockDef(kind="slstm", ffn="none"),
        ),
        n_superblocks=6,
        ssm_proj_factor=2,
        tie_embeddings=False,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        n_layers=4,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab=256,
        superblock=(
            BlockDef(kind="mlstm", ffn="none"),
            BlockDef(kind="slstm", ffn="none"),
        ),
        n_superblocks=2,
        ssm_proj_factor=2,
        q_chunk=16,
        ce_chunk=16,
    )
