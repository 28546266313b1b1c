"""``repro_torch.train`` — training on one device: optimizers, data,
checkpoints, the train step and the ``Trainer``."""

from __future__ import annotations

from .checkpoint import CheckpointManager, restore_pytree, save_pytree
from .data import MemmapTokens, SyntheticLM, make_data
from .optimizer import (
    Optimizer,
    adafactor,
    adamw,
    constant_schedule,
    global_norm,
    make_optimizer,
    sgd,
    warmup_cosine,
)
from .train_loop import TrainConfig, Trainer, make_sharded_init, make_train_step

__all__ = [
    "TrainConfig", "Trainer", "make_train_step", "make_sharded_init",
    "Optimizer", "adamw", "adafactor", "sgd", "make_optimizer",
    "warmup_cosine", "constant_schedule", "global_norm",
    "CheckpointManager", "save_pytree", "restore_pytree",
    "SyntheticLM", "MemmapTokens", "make_data",
]
