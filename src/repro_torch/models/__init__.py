"""The port's model zoo: the dense attention family (GQA, sliding windows,
softcaps; text, VLM and audio backbones), the Mamba2 hybrid family (zamba2)
and the xLSTM family (mLSTM and sLSTM blocks) for serving and training.
The other families (MLA, MoE) load their configs and raise
``NotImplementedError`` when built."""

from __future__ import annotations

from .config import SHAPES, BlockDef, ModelConfig, ShapeConfig
from .transfer import load_params_tree, params_from_jax, params_tree
from .transformer import (
    Transformer,
    count_params,
    forward,
    init_cache,
    init_model_params,
    logits_from_hidden,
    loss_fn,
    param_specs,
)

__all__ = [
    "BlockDef",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "Transformer",
    "param_specs",
    "init_model_params",
    "count_params",
    "forward",
    "loss_fn",
    "logits_from_hidden",
    "init_cache",
    "params_from_jax",
    "params_tree",
    "load_params_tree",
]
