"""Abstract input/step construction for the sharded launchers:
``input_specs`` (meta-device stand-ins for every model input) and
``build_step`` (the step with its inputs' DTensor placements for a given
cell).

A :class:`Cell`'s ``args`` are abstract: a ``Transformer`` on the meta
device, the optimizer state and the batch as meta tensors (no storage).
``in_shardings`` holds their placements.  :meth:`Cell.shard` distributes
real inputs of any size the same way, the placements recomputed from the
real shapes by the same logical axes and rules, and the step runs on them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models import (
    SHAPES,
    ModelConfig,
    Transformer,
    abstract_params,
    cache_logical,
    init_cache,
    named_params_logical,
    params_logical,
)
from ..models.sharding import (
    SERVE_RULES,
    TRAIN_RULES,
    ShardingRules,
    distribute,
    distribute_params,
    logical_to_sharding,
    tree_shardings,
    wrap_with_sharding_ctx,
)
from ..serve import make_decode_step, make_prefill_step
from ..train.optimizer import Optimizer
from ..train.train_loop import TrainConfig, _opt_shardings, make_optimizer_for, make_train_step

__all__ = ["input_specs", "build_step", "Cell"]

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_abstract(cfg: ModelConfig, batch: int, seq: int) -> dict:
    i32 = torch.int32
    if cfg.modality == "audio":
        return {
            "tokens": _meta((batch, cfg.num_codebooks, seq), i32),
            "labels": _meta((batch, cfg.num_codebooks, seq), i32),
        }
    if cfg.modality == "vlm":
        return {
            "tokens": _meta((batch, seq - cfg.img_tokens), i32),
            "image_embeds": _meta((batch, cfg.img_tokens, cfg.d_model), torch.bfloat16),
            "labels": _meta((batch, seq), i32),
        }
    return {"tokens": _meta((batch, seq), i32), "labels": _meta((batch, seq), i32)}


def _batch_logical(name: str, ndim: int) -> tuple:
    if name == "image_embeds":
        return ("batch", None, None)
    if ndim == 3:  # audio [B, K, S]
        return ("batch", None, "seq")
    return ("batch", "seq")


def _batch_shardings(batch_abs: dict, mesh, rules: ShardingRules) -> dict:
    return {k: logical_to_sharding(_batch_logical(k, v.dim()), v.shape, mesh, rules)
            for k, v in batch_abs.items()}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-device stand-ins for every input of the cell's step function
    (no device allocation)."""
    shp = SHAPES[shape_name]
    if shp.kind in ("train", "prefill"):
        return _batch_abstract(cfg, shp.global_batch, shp.seq_len)
    # decode: one new token against a seq_len cache
    if cfg.modality == "audio":
        return {"tokens": _meta((shp.global_batch, cfg.num_codebooks, 1), torch.int32)}
    return {"tokens": _meta((shp.global_batch, 1), torch.int32)}


def _abstract_model(cfg: ModelConfig, dtype: torch.dtype) -> Transformer:
    return Transformer(cfg, device="meta").to(dtype)


@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) unit: a step fn + fully-specified abstract
    args + their placements.  ``kind`` is the shape's (train / prefill /
    decode); ``mesh`` and ``rules`` are the cell's, for :meth:`shard`."""

    name: str
    step: Callable
    args: tuple
    in_shardings: tuple
    donate: tuple = ()
    kind: str = "train"
    mesh: Any = None
    rules: ShardingRules | None = None

    def shard(self, *args) -> tuple:
        """Real inputs in the positions of ``args`` distributed by the same
        logical axes and rules: a ``Transformer`` (its parameters cast to
        the abstract model's dtype, then replaced by DTensors), the
        optimizer state, the batch, a cache; ints and ``None`` pass through.  Every rank
        must pass the same values (:func:`~repro_torch.models.sharding.distribute`
        keeps each rank's shard; no collective runs)."""
        out = []
        for pos, (value, abstract) in enumerate(zip(args, self.args)):
            if value is None or isinstance(value, int):
                out.append(value)
            elif isinstance(value, Transformer):
                _cast_params(value, next(abstract.parameters()).dtype)
                names = dict(value.named_parameters())
                logical = named_params_logical(value.cfg)
                sh = {n: logical_to_sharding(logical[n], p.shape, self.mesh, self.rules)
                      for n, p in names.items()}
                out.append(distribute_params(value, sh, self.mesh))
            elif self.kind == "train" and pos == 1:  # the optimizer state
                out.append(self._shard_opt(value))
            elif isinstance(value, dict) and any(k in value for k in ("head", "stack", "tail")):
                logical = cache_logical(value)
                out.append(_map(lambda t, lg: distribute(t, self.mesh, logical_to_sharding(
                    lg, t.shape, self.mesh, self.rules)), value, logical))
            elif isinstance(value, dict):
                out.append({k: distribute(v, self.mesh, logical_to_sharding(
                    _batch_logical(k, v.dim()), v.shape, self.mesh, self.rules))
                    for k, v in value.items()})
            elif isinstance(value, torch.Tensor) and value.dim() in (2, 3):  # decode tokens
                # [B, 1], or audio [B, K, 1]: laid out as build_step lays them
                out.append(distribute(value, self.mesh, logical_to_sharding(
                    ("batch", None, None)[:value.dim()], value.shape, self.mesh, self.rules)))
            else:
                out.append(value)
        return tuple(out)

    def _shard_opt(self, state: dict) -> dict:
        cfg = self.args[0].cfg
        p_tree = tree_shardings(abstract_params(cfg), params_logical(cfg), self.mesh, self.rules)
        o_sh = _opt_shardings(state, p_tree, self.mesh)
        return _map(lambda t, pl: distribute(t, self.mesh, pl), state, o_sh)


def _cast_params(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Each parameter of another dtype replaced by a parameter of its value
    cast to ``dtype`` (``Module.to`` would swap tensors, which fake tensors
    refuse); the model has no buffers."""
    for name, p in list(model.named_parameters()):
        if p.dtype != dtype:
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            setattr(module, leaf, torch.nn.Parameter(p.detach().to(dtype),
                                                     requires_grad=p.requires_grad))


def _map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def build_step(cfg: ModelConfig, shape_name: str, mesh, tcfg: TrainConfig | None = None,
               opt: Optimizer | None = None) -> Cell:
    """The cell's step under ``TRAIN_RULES`` (train) or ``SERVE_RULES``
    (prefill, decode; with ``cfg.serve_fsdp`` the weights' d_model dim over
    the batch axes too).  A train cell's optimizer is ``opt``, by default
    ``make_optimizer_for(cfg, tcfg)``."""
    shp = SHAPES[shape_name]
    p_logical = named_params_logical(cfg)

    if shp.kind == "train":
        rules = TRAIN_RULES
        model = _abstract_model(cfg, getattr(torch, cfg.param_dtype))
        aps = dict(model.named_parameters())
        p_sh = tree_shardings(aps, p_logical, mesh, rules)
        opt = opt or make_optimizer_for(cfg, tcfg or TrainConfig())
        opt_abs = opt.init(aps)
        p_tree = tree_shardings(abstract_params(cfg), params_logical(cfg), mesh, rules)
        o_sh = _opt_shardings(opt_abs, p_tree, mesh)
        batch_abs = input_specs(cfg, shape_name)
        b_sh = _batch_shardings(batch_abs, mesh, rules)
        step = wrap_with_sharding_ctx(make_train_step(cfg, opt, cfg.train_microbatch), mesh, rules)
        return Cell(
            name=f"{cfg.name}:{shape_name}",
            step=step,
            args=(model, opt_abs, 0, batch_abs),
            in_shardings=(p_sh, o_sh, None, b_sh),
            donate=(0, 1),
            kind="train", mesh=mesh, rules=rules,
        )

    rules = SERVE_RULES
    if cfg.serve_fsdp:
        rules = ShardingRules({**SERVE_RULES.rules, "fsdp_embed": ("pod", "data")})
    # serving runs on bf16 weights (f32 masters stay in the checkpoint)
    model = _abstract_model(cfg, getattr(torch, cfg.serve_param_dtype))
    p_sh = tree_shardings(dict(model.named_parameters()), p_logical, mesh, rules)
    cache_abs = init_cache(cfg, shp.global_batch, shp.seq_len, torch.bfloat16, device="meta")
    c_sh = tree_shardings(cache_abs, cache_logical(cache_abs), mesh, rules)

    if shp.kind == "prefill":
        batch_abs = input_specs(cfg, shape_name)
        b_sh = _batch_shardings(batch_abs, mesh, rules)
        step = wrap_with_sharding_ctx(make_prefill_step(cfg), mesh, rules)
        return Cell(
            name=f"{cfg.name}:{shape_name}",
            step=step,
            args=(model, batch_abs, cache_abs),
            in_shardings=(p_sh, b_sh, c_sh),
            donate=(2,),
            kind="prefill", mesh=mesh, rules=rules,
        )

    # decode
    tok_abs = input_specs(cfg, shape_name)["tokens"]
    tok_logical = ("batch", None, None)[: tok_abs.dim()]
    t_sh = logical_to_sharding(tok_logical, tok_abs.shape, mesh, rules)
    step = wrap_with_sharding_ctx(make_decode_step(cfg), mesh, rules)
    return Cell(
        name=f"{cfg.name}:{shape_name}",
        step=step,
        args=(model, tok_abs, cache_abs, 0),
        in_shardings=(p_sh, t_sh, c_sh, None),
        donate=(2,),
        kind="decode", mesh=mesh, rules=rules,
    )
