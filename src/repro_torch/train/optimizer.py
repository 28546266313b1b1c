"""Optimizers in PyTorch: AdamW, Adafactor (factored second moments), SGD
with momentum; global-norm clipping; warmup + cosine schedules.

Parameters and gradients are dicts of tensors keyed by the model's parameter
names.  The optimizer state keeps the reference's tree: nested dicts keyed
as the reference's parameter tree, each leaf of the stacked superblocks one
tensor with a leading layer axis, so a checkpoint of it has the reference's
keys and shapes (``train/checkpoint.py``).  The model names layer ``l`` of
such a leaf ``stack.<l>.<rest>`` (``models/transformer.py``).  Where the
reference returns new parameters and state, the port updates both (and the
clipped gradients) in place under ``torch.no_grad()``, to hold one copy of
each; the model's parameters are float32 masters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "sgd",
    "make_optimizer",
    "warmup_cosine",
    "constant_schedule",
    "global_norm",
    "clip_by_global_norm",
]


def _leaf_of(name: str) -> tuple[tuple[str, ...], "int | None"]:
    """``(path in the reference's tree, layer)`` of a model parameter name:
    ``stack.3.0.attn.wq`` is layer 3 of the stacked leaf ``stack/0/attn/wq``;
    any other name is a leaf of its own (layer ``None``)."""
    parts = tuple(name.split("."))
    if parts[0] == "stack":
        return ("stack", *parts[2:]), int(parts[1])
    return parts, None


def _groups(params: dict) -> dict:
    """The reference's leaf path -> ``[(layer, name), ...]`` in layer order."""
    out: dict = {}
    for name in params:
        path, layer = _leaf_of(name)
        out.setdefault(path, []).append((layer, name))
    for members in out.values():
        members.sort(key=lambda m: -1 if m[0] is None else m[0])
    return out


def _leaf_like(params: dict, members: list, fn) -> torch.Tensor:
    """A state leaf for one group: ``fn(shape)`` with the stacked shape."""
    first = params[members[0][1]]
    shape = tuple(first.shape) if members[0][0] is None else (len(members), *first.shape)
    return fn(shape, first.device)


def _tree(groups: dict, make) -> dict:
    """Nested dicts keyed like the reference's tree, ``make(path)`` at each leaf."""
    tree: dict = {}
    for path in groups:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = make(path)
    return tree


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _check_float32(params: dict) -> None:
    """AdamW and SGD update the float32 master parameters in place."""
    for name, p in params.items():
        if p.dtype != torch.float32:
            raise TypeError(f"{name} is {p.dtype}: the optimizer updates float32 parameters")


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor in a dict (nested or flat),
    in float32, as a 0-d tensor."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for value in node.values():
                walk(value)
        else:
            leaves.append(torch.sum(torch.square(node.to(torch.float32))))

    walk(tree)
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    """Scale the gradients in place by ``min(1, max_norm / norm)``; return
    them and the norm (no host sync)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> Callable:
    def schedule(step) -> float:
        step = float(step)
        # (step+1)/warmup so the very first step trains (lr > 0 at step 0)
        warm = peak_lr * min(1.0, (step + 1.0) / max(warmup, 1))
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))
        return warm if step < warmup else cos

    return schedule


def constant_schedule(lr: float) -> Callable:
    return lambda step: float(lr)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict, int], tuple]  # (grads, state, params, step)
    name: str = "opt"


def _layer(leaf: torch.Tensor, layer: "int | None") -> torch.Tensor:
    return leaf if layer is None else leaf[layer]


def adamw(
    schedule: Callable,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    state_dtype=torch.float32,
) -> Optimizer:
    def init(params):
        _check_float32(params)
        groups = _groups(params)

        def zeros(path):
            return _leaf_like(params, groups[path],
                              lambda s, d: torch.zeros(s, dtype=state_dtype, device=d))

        return {"m": _tree(groups, zeros), "v": _tree(groups, zeros)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        t = float(step) + 1.0
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t
        lr = schedule(step)
        for path, members in _groups(params).items():
            m_leaf, v_leaf = _get(state["m"], path), _get(state["v"], path)
            for layer, name in members:
                p, g = params[name], grads[name].to(torch.float32)
                m, v = _layer(m_leaf, layer), _layer(v_leaf, layer)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                step_ = (m / c1).div_((v / c2).sqrt_().add_(eps))
                step_.add_(p, alpha=weight_decay)
                p.sub_(step_.mul_(lr))
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update, "adamw")


def adafactor(
    schedule: Callable,
    decay: float = 0.99,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    clip_norm: float = 1.0,
) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018), beta1=0.

    For a [r, c] matrix the state is r + c floats instead of r*c.  The
    factoring and the update clip see each stacked leaf whole, leading layer
    axis included, as in the reference: the layers of a leaf are stacked for
    the update (a copy of one leaf at a time) and written back."""

    def factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(params):
        groups = _groups(params)

        def one(path):
            def make(shape, device):
                if factored(shape):
                    return {"vr": _zeros(shape[:-1], device),
                            "vc": _zeros(shape[:-2] + shape[-1:], device)}
                return {"v": _zeros(shape, device)}

            return _leaf_like(params, groups[path], make)

        return {"v": _tree(groups, one)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = schedule(step)
        t = float(step) + 1.0
        beta2t = 1.0 - t ** -0.8  # Adafactor's decay schedule
        for path, members in _groups(params).items():
            st = _get(state["v"], path)
            stacked = members[0][0] is not None
            pick = (lambda d: torch.stack([d[n] for _, n in members])) if stacked else (
                lambda d: d[members[0][1]])
            g32 = pick(grads).to(torch.float32)
            p = pick(params)
            g2 = g32 * g32 + eps
            if factored(p.shape):
                st["vr"].mul_(beta2t).add_(g2.mean(dim=-1), alpha=1 - beta2t)
                st["vc"].mul_(beta2t).add_(g2.mean(dim=-2), alpha=1 - beta2t)
                vr, vc = st["vr"], st["vc"]
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = g32 / torch.sqrt((vr / denom)[..., None] * vc[..., None, :] + eps)
            else:
                st["v"].mul_(beta2t).add_(g2, alpha=1 - beta2t)
                u = g32 / torch.sqrt(st["v"] + eps)
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p32 = p.to(torch.float32)
            p_new = (p32 - lr * (u + weight_decay * p32)).to(p.dtype)
            if stacked:
                for layer, name in members:
                    params[name].copy_(p_new[layer])
            else:
                params[members[0][1]].copy_(p_new)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update, "adafactor")


def sgd(schedule: Callable, momentum: float = 0.9, clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        _check_float32(params)
        groups = _groups(params)
        return {"mu": _tree(groups, lambda path: _leaf_like(params, groups[path], _zeros))}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = schedule(step)
        for path, members in _groups(params).items():
            mu_leaf = _get(state["mu"], path)
            for layer, name in members:
                mu = _layer(mu_leaf, layer)
                mu.mul_(momentum).add_(grads[name].to(torch.float32))
                params[name].sub_(lr * mu)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update, "sgd")


def make_optimizer(name: str, schedule: Callable, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(schedule, **kw)
    if name == "adafactor":
        return adafactor(schedule, **kw)
    if name == "sgd":
        return sgd(schedule, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
