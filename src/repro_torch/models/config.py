"""Model / run configuration dataclasses (shared by configs/, launch/, tune/)."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["BlockDef", "ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One sub-layer slot inside the (scanned) superblock pattern."""

    kind: str = "attn"  # attn | mla | mlstm | slstm | mamba2
    window: int = -1  # sliding-window size for attn (-1 = global)
    ffn: str = "swiglu"  # swiglu | gelu | moe | none
    d_ff: int | None = None  # override cfg.d_ff (e.g. deepseek's dense layer 0)
    post_norms: bool = False  # gemma2 sandwich norms
    shared: bool = False  # zamba2: use the single shared param set


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_layers: int
    superblock: tuple = (BlockDef(),)
    n_superblocks: int = 1
    head_blocks: tuple = ()
    tail_blocks: tuple = ()
    has_shared_block: bool = False
    shared_block: Any = None  # BlockDef for the shared slot

    modality: str = "text"  # text | vlm | audio
    img_tokens: int = 1152  # vlm stub: precomputed patch-embedding count
    num_codebooks: int = 4  # audio

    head_dim: int = 0  # 0 -> d_model // n_heads
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    attn_softcap: float | None = None
    final_softcap: float | None = None
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_d_ff: int = 0
    moe_capacity: float = 1.25
    moe_group: int = 4096  # tokens per dispatch group (einsum mode)
    moe_dispatch: str = "einsum"  # einsum | sort
    moe_aux_coef: float = 0.01
    moe_norm_topk: bool = True

    # MLA
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_proj_factor: int = 2  # xlstm mLSTM inner width multiple

    # execution
    # q_chunk must divide the sequence-parallel shard (seq/16) in training or
    # chunks straddle shards -> pairwise reshard collectives
    q_chunk: int = 256
    prefill_q_chunk: int = 512  # prefill has no SP resharding; bigger = fewer k/v re-reads
    ce_chunk: int = 256
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "nothing_saveable"  # nothing_saveable | dots_saveable | none
    optimizer: str = "adamw"
    scan_unroll: int = 1
    train_microbatch: int = 0  # grad-accumulation slices (0 = off)
    serve_param_dtype: str = "bfloat16"  # serving weights (f32 masters stay on disk)
    serve_fsdp: bool = False  # shard serving weights over batch axes too (235B-class)
    # cast >=2D weights to compute dtype at the top of the layer-scan body so
    # FSDP all-gathers move bf16, not f32 (halves the collective term)
    bf16_weight_gather: bool = False
    # Megatron-style attention: shard q heads over "model" during training
    # (requires n_heads % 16 == 0); k/v replicate over model (cheap when
    # n_kv_heads is small).
    attn_head_shard: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived -------------------------------------------------------------

    def all_blocks(self):
        """(bdef, n_repeats) for parameter counting."""
        out = [(b, 1) for b in self.head_blocks]
        for b in self.superblock:
            out.append((b, self.n_superblocks if not b.shared else 0))
        if self.has_shared_block and self.shared_block is not None:
            out.append((self.shared_block, 1))
        out += [(b, 1) for b in self.tail_blocks]
        return out


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
