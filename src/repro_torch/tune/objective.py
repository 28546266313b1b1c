"""Define-by-run objectives over the model zoo.

This is the paper's Figure 3/4 pattern at framework scale: the *trial object*
dynamically constructs the model architecture (family, depth, width, MoE
topology), the optimizer, and the schedule — then trains the candidate with
``repro_torch.train`` on one device and reports eval losses to the pruner at
every eval step.  Pruned trials stop immediately and never checkpoint
(ASHA's no-repechage design, paper §3.2).  Every family of the default
space builds: ``dense`` and ``moe`` (GQA through the flash-attention
kernel, a mixture-of-experts FFN), ``mlstm`` and ``mamba2``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from .. import core as hpo
from ..models.config import BlockDef, ModelConfig
from ..train import SyntheticLM, TrainConfig, Trainer

__all__ = ["LMTuneSpec", "make_lm_objective", "suggest_model_config", "suggest_train_config"]


@dataclasses.dataclass(frozen=True)
class LMTuneSpec:
    """Budget/limits for one tuning study (kept CPU-sized by default)."""

    vocab: int = 256
    seq: int = 64
    batch: int = 8
    total_steps: int = 60
    eval_every: int = 10
    max_layers: int = 4
    max_width: int = 128
    families: tuple = ("dense", "mlstm", "mamba2", "moe")


def suggest_model_config(trial, spec: LMTuneSpec) -> ModelConfig:
    """Paper Fig. 3: a heterogeneous space across architecture families, each
    with its own conditional sub-space — expressible as plain Python."""
    family = trial.suggest_categorical("family", list(spec.families))
    n_layers = trial.suggest_int("n_layers", 1, spec.max_layers)
    width_exp = trial.suggest_int("width_exp", 5, int(math.log2(spec.max_width)))
    d_model = 2**width_exp
    common = dict(
        vocab=spec.vocab, d_model=d_model, n_layers=n_layers,
        q_chunk=16, ce_chunk=16, param_dtype="float32",
    )
    if family == "dense":
        n_heads = trial.suggest_categorical("n_heads", [2, 4])
        ff_mult = trial.suggest_int("ff_mult", 1, 4)
        window = trial.suggest_categorical("window", [-1, 16])
        return ModelConfig(
            name=f"tuned-dense-{trial.number}",
            n_heads=n_heads, n_kv_heads=n_heads,
            d_ff=d_model * ff_mult,
            superblock=(BlockDef(kind="attn", window=window),),
            n_superblocks=n_layers,
            **common,
        )
    if family == "mlstm":
        return ModelConfig(
            name=f"tuned-mlstm-{trial.number}",
            n_heads=trial.suggest_categorical("ssm_heads", [2, 4]),
            n_kv_heads=2, d_ff=0,
            superblock=(BlockDef(kind="mlstm", ffn="none"),),
            n_superblocks=n_layers,
            ssm_proj_factor=trial.suggest_int("proj_factor", 1, 2),
            **common,
        )
    if family == "mamba2":
        return ModelConfig(
            name=f"tuned-mamba2-{trial.number}",
            n_heads=4, n_kv_heads=4, d_ff=0,
            superblock=(BlockDef(kind="mamba2", ffn="none"),),
            n_superblocks=n_layers,
            ssm_state=trial.suggest_categorical("ssm_state", [8, 16]),
            ssm_head_dim=16, ssm_chunk=16,
            **common,
        )
    # moe
    n_exp = trial.suggest_categorical("n_experts", [4, 8])
    return ModelConfig(
        name=f"tuned-moe-{trial.number}",
        n_heads=4, n_kv_heads=2,
        d_ff=d_model,
        superblock=(BlockDef(kind="attn", ffn="moe"),),
        n_superblocks=n_layers,
        moe_experts=n_exp,
        moe_top_k=trial.suggest_int("top_k", 1, 2),
        moe_d_ff=d_model,
        moe_group=64,
        **common,
    )


def suggest_train_config(trial, spec: LMTuneSpec) -> TrainConfig:
    """Paper Fig. 4's create_optimizer: the optimizer space is a separate,
    independently-editable method."""
    return TrainConfig(
        lr=trial.suggest_float("lr", 1e-4, 1e-1, log=True),
        warmup_steps=trial.suggest_int("warmup", 0, 20),
        weight_decay=trial.suggest_float("weight_decay", 1e-3, 0.3, log=True),
        total_steps=spec.total_steps,
        eval_every=spec.eval_every,
        checkpoint_every=10**9,
        seed=trial.number,
    )


def make_lm_objective(spec: LMTuneSpec | None = None, workdir: str | None = None,
                      device=None) -> Callable:
    """The objective: build, train and report one trial's model on ``device``
    (``None``: the card; without one each trial raises unless the caller
    passes ``device="cpu"``)."""
    spec = spec or LMTuneSpec()

    def objective(trial) -> float:
        cfg = suggest_model_config(trial, spec)
        tcfg = suggest_train_config(trial, spec)
        data = SyntheticLM(cfg, batch=spec.batch, seq=spec.seq, seed=0)

        def report(step: int, loss: float) -> bool:
            trial.report(loss, step)
            return trial.should_prune()

        trainer = Trainer(cfg, tcfg, data, workdir=None, report_fn=report, device=device)
        result = trainer.run()
        if result.get("pruned"):
            raise hpo.TrialPruned(f"pruned at step {result['step']}")
        trial.set_user_attr("final_step", result["step"])
        return result["last_loss"]

    return objective
