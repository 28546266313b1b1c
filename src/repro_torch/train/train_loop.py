"""Train-step construction + the host-side training loop.

``make_train_step`` builds the step function: gradients of the
cross-entropy loss (``models.loss_fn``, through the fused cross-entropy,
flash-attention and SSD kernels and their written-out backwards), optional
microbatch accumulation, the optimizer update in place.

``Trainer`` adds the production concerns: init on a device from a seeded
``torch.Generator``, checkpoint/restart (auto-resume from the latest step),
deterministic data skip on resume, eval hooks that feed the HPO pruner, and
graceful preemption (SIGTERM -> final checkpoint).  It runs on one device;
sharded init and meshes belong to the multi-GPU slice of the port.
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Callable

import torch

from ..kernels import ops
from ..models import ModelConfig, Transformer, init_model_params, loss_fn
from ..models.transfer import load_params_tree, params_tree
from .checkpoint import CheckpointManager
from .optimizer import Optimizer, make_optimizer, warmup_cosine

__all__ = ["TrainConfig", "make_train_step", "make_optimizer_for", "Trainer",
           "make_sharded_init"]

_MULTI_GPU = "the multi-GPU slice of the port"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    clip_norm: float = 1.0
    microbatch: int = 0  # 0 = no accumulation; else per-step slices
    checkpoint_every: int = 200
    eval_every: int = 20
    seed: int = 0


def make_optimizer_for(cfg: ModelConfig, tcfg: TrainConfig) -> Optimizer:
    sched = warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    if cfg.optimizer == "adamw":
        return make_optimizer(
            "adamw", sched, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm,
        )
    if cfg.optimizer == "adafactor":
        return make_optimizer("adafactor", sched, clip_norm=tcfg.clip_norm)
    return make_optimizer("sgd", sched, clip_norm=tcfg.clip_norm)


def make_train_step(cfg: ModelConfig, opt: Optimizer, microbatch: int = 0) -> Callable:
    """Returns ``step(model, opt_state, step_no, batch) -> (model, opt_state,
    metrics)``; the model's parameters and the state are updated in place."""

    def grads_of(model, names, leaves, batch):
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, dict(zip(names, grads))

    def step(model: Transformer, opt_state, step_no: int, batch: dict):
        named = dict(model.named_parameters())
        names, leaves = list(named), list(named.values())
        for p in leaves:
            p.requires_grad_(True)
        if microbatch and microbatch > 1:
            # grad accumulation over microbatch slices of the batch dim
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grad_sum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                        for n, p in named.items()}
            for i in range(microbatch):
                part = {k: v[i * (v.shape[0] // microbatch):(i + 1) * (v.shape[0] // microbatch)]
                        for k, v in batch.items()}
                loss, _, grads = grads_of(model, names, leaves, part)
                loss_sum += loss
                for n, g in grads.items():
                    grad_sum[n] += g
            loss = loss_sum / microbatch
            grads = {n: g / microbatch for n, g in grad_sum.items()}
            metrics = {}
        else:
            loss, metrics, grads = grads_of(model, names, leaves, batch)
            metrics = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                       for k, v in metrics.items()}
        _, opt_state, opt_metrics = opt.update(grads, opt_state, named, step_no)
        return model, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return step


def make_sharded_init(*args, **kwargs):
    raise NotImplementedError(f"sharded init belongs to {_MULTI_GPU}")


class Trainer:
    """Host-side loop with checkpoint/restart and pruner hooks, on one device.

    ``device=None`` means the card; without one the trainer raises unless the
    caller passes ``device="cpu"``."""

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        data_iter,
        workdir: str | None = None,
        mesh=None,
        rules=None,
        report_fn: Callable[[int, float], bool] | None = None,
        device=None,
    ):
        if mesh is not None or rules is not None:
            raise NotImplementedError(f"meshes and sharding rules belong to {_MULTI_GPU}")
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = data_iter
        self.workdir = workdir
        self.report_fn = report_fn  # returns True if the trial should stop (pruned)
        self.opt = make_optimizer_for(cfg, tcfg)
        self._step_fn = make_train_step(cfg, self.opt, tcfg.microbatch)
        self.device = ops.resolve_device("auto", device)
        self.ckpt = CheckpointManager(workdir) if workdir else None
        self._preempted = False

    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread (e.g. HPO worker threads)

    def _batch(self) -> dict:
        return {k: v.to(self.device, non_blocking=True) for k, v in self.data.next_batch().items()}

    def run(self) -> dict:
        self._install_sigterm()
        cfg, tcfg = self.cfg, self.tcfg
        generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        model = init_model_params(cfg, generator, self.device)
        opt_state = self.opt.init(dict(model.named_parameters()))
        start_step = 0
        if self.ckpt is not None and self.ckpt.all_steps():
            start_step, (tree, opt_state) = self.ckpt.restore_latest((params_tree(model),
                                                                      opt_state))
            load_params_tree(model, tree)
        step_fn = self._step_fn

        self.data.skip_to(start_step)
        losses = []
        last = None
        for step in range(start_step, tcfg.total_steps):
            model, opt_state, metrics = step_fn(model, opt_state, step, self._batch())
            last = metrics
            if (step + 1) % tcfg.eval_every == 0 or step + 1 == tcfg.total_steps:
                loss = float(metrics["loss"])
                losses.append(loss)
                if self.report_fn is not None and self.report_fn(step + 1, loss):
                    # pruned by the HPO layer: stop immediately, do not checkpoint
                    # (the paper's no-repechage design: pruned trials never resume)
                    return {"pruned": True, "last_loss": loss, "step": step + 1}
            if self.ckpt is not None and (
                (step + 1) % tcfg.checkpoint_every == 0 or self._preempted
            ):
                self.ckpt.save(step + 1, (params_tree(model), opt_state))
                if self._preempted:
                    self.ckpt.wait()  # the process may exit next: the file must be written
                    return {"preempted": True, "step": step + 1,
                            "last_loss": float(last["loss"]) if last else float("nan")}
        if self.ckpt is not None:
            self.ckpt.wait()
        return {
            "pruned": False,
            "last_loss": float(last["loss"]) if last is not None else float("nan"),
            "losses": losses,
            "step": tcfg.total_steps,
            "model": model,
        }
