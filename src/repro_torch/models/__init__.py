"""The port's model zoo: the dense attention family (GQA, sliding windows,
softcaps; text, VLM and audio backbones), the Mamba2 hybrid family (zamba2),
the xLSTM family (mLSTM and sLSTM blocks) and the MLA / MoE family
(deepseek-v2-lite, qwen3-moe) for serving and training."""

from __future__ import annotations

from .config import SHAPES, BlockDef, ModelConfig, ShapeConfig
from .transfer import load_params_tree, params_from_jax, params_tree
from .transformer import (
    Transformer,
    abstract_params,
    cache_logical,
    count_active_params,
    count_params,
    forward,
    init_cache,
    init_model_params,
    logits_from_hidden,
    loss_fn,
    named_params_logical,
    param_specs,
    params_logical,
)

__all__ = [
    "BlockDef",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "Transformer",
    "param_specs",
    "init_model_params",
    "abstract_params",
    "params_logical",
    "named_params_logical",
    "cache_logical",
    "count_params",
    "count_active_params",
    "forward",
    "loss_fn",
    "logits_from_hidden",
    "init_cache",
    "params_from_jax",
    "params_tree",
    "load_params_tree",
]
