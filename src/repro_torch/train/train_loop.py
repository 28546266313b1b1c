"""Train-step construction + the host-side training loop.

``make_train_step`` builds the step function: gradients of the
cross-entropy loss (``models.loss_fn``, through the fused cross-entropy,
flash-attention and SSD kernels and their written-out backwards), optional
microbatch accumulation, the optimizer update in place.

The same step runs sharded (``launch.specs.build_step``): under an active
mesh the parameters, the optimizer state and the batch are DTensors, the
model's blocks run on local shards (``models/tensor_parallel.py``), the
loss is replicated before the backward pass, and each gradient is
redistributed to its parameter's placements before the update.
``make_sharded_init`` creates the parameters and the optimizer state
already sharded.

``Trainer`` adds the production concerns: init on a device from a seeded
``torch.Generator``, checkpoint/restart (auto-resume from the latest step),
deterministic data skip on resume, eval hooks that feed the HPO pruner, and
graceful preemption (SIGTERM -> final checkpoint).  It runs on one device.
"""

from __future__ import annotations

import dataclasses
import math
import signal
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import ops
from ..models import (
    ModelConfig,
    Transformer,
    abstract_params,
    init_model_params,
    loss_fn,
    named_params_logical,
    params_logical,
)
from ..models.sharding import (
    ShardingRules,
    axis_sizes,
    dim_names,
    distribute,
    local_shard,
    sharded_zeros,
    side_by_side,
    spec_to_placements,
    tree_shardings,
)
from ..models.transfer import load_params_tree, params_tree
from ..models.transformer import init_items
from .checkpoint import CheckpointManager
from .optimizer import Optimizer, make_optimizer, warmup_cosine

__all__ = ["TrainConfig", "make_train_step", "make_optimizer_for", "Trainer",
           "make_sharded_init"]


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
        if isinstance(loss, DTensor):  # sharded: a partial sum over the batch axes
            loss = loss.full_tensor()
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        grads = torch.autograd.grad(loss, leaves)
        grads = [_placed_like(g, p) for g, p in zip(grads, leaves)]
        return loss.detach(), metrics, dict(zip(names, grads))

    def step(model: Transformer, opt_state, step_no: int, batch: dict):
        named = dict(model.named_parameters())
        names, leaves = list(named), list(named.values())
        for p in leaves:
            p.requires_grad_(True)
        if microbatch and microbatch > 1:
            # grad accumulation over microbatch slices of the batch dim
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grad_sum = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
            parts, layout = _rows(batch, microbatch)
            for part in parts:
                with layout:  # the loss: the sum of the layout's k microbatches' losses
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


def _placed_like(g, p):
    """A DTensor gradient redistributed to its parameter's placements."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _rows(batch: dict, m: int) -> tuple[list[dict], side_by_side]:
    """The step's ``m`` microbatches, microbatch ``i`` the batch's rows
    ``[i B/m, (i+1) B/m)`` as in the reference, in ``m / k`` iterations of
    ``k`` consecutive microbatches side by side: ``(iterations, layout)``,
    ``layout`` the ``sharding.side_by_side`` each iteration runs under.

    A plain batch runs one microbatch an iteration (``k = 1``).  A DTensor
    batch (its rows over the batch axes in contiguous blocks, the first mesh
    dim the major one) is gathered along its rows once, before the loop
    (token ids, labels and image rows: nothing the loop computes), and each
    iteration keeps this rank's block of the iteration's rows, sharded as
    the batch is.  The layout rule: a microbatch's rows lie over the
    innermost batch axes whose sizes' product divides them (the layout's
    ``axes``), and the outer batch axes, ``k`` ranks' worth by the product
    of their sizes, run ``k`` different microbatches side by side (under the
    layout each microbatch's reductions run over its own axes).  With rows
    enough for every batch shard ``k`` is 1; with 32 rows a microbatch over
    ("pod", "data") = (2, 32), each microbatch lies over "data" and the two
    pods run one each.  Raises ``NotImplementedError`` where ``k`` does not
    divide ``m``: no iteration then holds whole microbatches (2 rows a
    microbatch over 4 "data" shards, ``m`` = 2)."""
    first = next(iter(batch.values()))
    if not isinstance(first, DTensor):
        b = first.shape[0] // m
        return ([{key: v[i * b:(i + 1) * b] for key, v in batch.items()} for i in range(m)],
                side_by_side(1))
    mesh = first.device_mesh
    rows = first.shape[0] // m
    k, inner, axes = 1, 1, []
    for dim in reversed([i for i, p in enumerate(first.placements) if p == Shard(0)]):
        if k == 1 and rows % (inner * mesh.size(dim)) == 0:
            inner *= mesh.size(dim)
            axes.insert(0, mesh.mesh_dim_names[dim])
        else:
            k *= mesh.size(dim)
    if m % k:
        raise NotImplementedError(f"{m} microbatches of {rows} rows: their rows divide "
                                  f"{inner} of the batch shards, and the other {k} ranks' "
                                  f"worth of microbatches side by side does not divide {m}")
    per = k * rows
    out: list[dict] = [{} for _ in range(m // k)]
    for key, v in batch.items():
        pl = tuple(v.placements)
        whole = v.redistribute(mesh, tuple(Replicate() if p == Shard(0) else p for p in pl))
        whole = whole.to_local()
        rows_only = tuple(p if p == Shard(0) else Replicate() for p in pl)
        for t, part in enumerate(out):
            local = local_shard(whole[t * per:(t + 1) * per], mesh, rows_only).contiguous()
            part[key] = DTensor.from_local(local, mesh, pl, run_check=False)
    return out, side_by_side(k, axes)


def _meta_params(cfg: ModelConfig) -> dict:
    return dict(Transformer(cfg, device="meta").named_parameters())


def make_sharded_init(cfg: ModelConfig, opt: Optimizer, mesh, rules: ShardingRules):
    """Init with every tensor born sharded.  Returns ``(init, p_sh, o_sh)``:
    ``p_sh`` the placements of each model parameter (``{name:
    placements}``), ``o_sh`` the optimizer state's (the state's tree), and
    ``init(generator) -> (model, opt_state)``.

    ``init`` draws every parameter from ``generator`` (on every rank the
    same seed) as ``init_model_params`` draws it (``init_items``: a stacked
    leaf one layer slice at a time), keeps this rank's shard of it on the
    mesh's device and drops the rest before the next draw: no rank holds
    more than one layer slice of a leaf beyond its own shards (3.22 GB of
    qwen3-moe-235b's stacked expert weights, not the whole 300 GB leaf), and
    gathered the parameters are bit for bit ``init_model_params`` with the
    same seed.  The optimizer state is zeros (every state leaf of the port's
    optimizers starts at zero), each rank allocating its shard."""
    p_sh = tree_shardings(_meta_params(cfg), named_params_logical(cfg), mesh, rules)
    tree_sh = tree_shardings(abstract_params(cfg), params_logical(cfg), mesh, rules)
    opt_abs = opt.init(_meta_params(cfg))
    o_sh = _opt_shardings(opt_abs, tree_sh, mesh)

    def init(generator: torch.Generator):
        model = Transformer(cfg, device="meta")
        for name, value in init_items(cfg, generator, generator.device):
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            setattr(module, leaf, torch.nn.Parameter(distribute(value, mesh, p_sh[name]),
                                                     requires_grad=False))
            del value
        state = _map_tree(lambda a, pl: sharded_zeros(a.shape, a.dtype, mesh, pl), opt_abs, o_sh)
        return model, state

    return init, p_sh, o_sh


def _map_tree(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _placements_spec(placements: tuple, names: tuple, ndim: int) -> list:
    """The reference's spec (as a list of length ``ndim``) of placements."""
    spec: list = [None] * ndim
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim
            spec[d] = names[i] if spec[d] is None else (
                (*spec[d], names[i]) if isinstance(spec[d], tuple) else (spec[d], names[i]))
    return spec


def _opt_shardings(opt_abs, param_shardings, mesh):
    """Optimizer state placements: inherit from the matching parameter
    (the state path's suffix is the parameter's path in the reference's
    tree) where shapes coincide (adam m/v); adafactor's factored vr/vc
    inherit the param spec minus the reduced axis (so expert/vocab shards
    stay sharded), dropping axes that no longer divide; anything else is
    replicated.  ``param_shardings`` is the reference-shaped tree of
    parameter placements; ``mesh`` a ``DeviceMesh`` or ``{axis: size}``."""
    names = dim_names(mesh)
    sizes = axis_sizes(mesh)
    flat_p = dict(_flat(param_shardings))

    def param_spec_for(keys):
        for start in range(len(keys)):
            if keys[start:] in flat_p:
                return flat_p[keys[start:]]
        return None

    def one(keys, leaf):
        hit = param_spec_for(keys)
        if hit is not None:
            return hit
        if keys and keys[-1] in ("vr", "vc"):
            hit = param_spec_for(keys[:-1])
            if hit is not None:
                spec = _placements_spec(hit, names, leaf.dim() + 1)
                del spec[-1 if keys[-1] == "vr" else -2]
                clean = []
                for dim, ax in zip(leaf.shape, spec):
                    axes = (ax,) if isinstance(ax, str) else (ax or ())
                    size = math.prod(sizes[a] for a in axes)
                    clean.append(ax if dim % max(size, 1) == 0 else None)
                return spec_to_placements(tuple(clean), mesh)
        return spec_to_placements((), mesh)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, (*path, k)) for k, v in tree.items()}
        return one(path, tree)

    return walk(opt_abs, ())


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flat(sub, (*path, key))
    else:
        yield path, tree


class Trainer:
    """Host-side loop with checkpoint/restart and pruner hooks, on one device.

    ``device=None`` means the card; without one the trainer raises unless the
    caller passes ``device="cpu"``.  ``mesh`` and ``rules`` are stored and not
    read, as in the reference, whose ``run()`` trains unsharded too: a
    sharded step is ``launch.specs.build_step``'s."""

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
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = data_iter
        self.workdir = workdir
        self.mesh = mesh
        self.rules = rules
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
