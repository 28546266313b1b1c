"""The driver of ``kind: train`` traffic: training steps of the program's
``make_train_step``, called in a loop as ``Trainer.run`` calls it.

Set-up builds one model and one AdamW state, with the weights drawn from the
seed on the device, and drives them through the traffic's ``check_steps``
first steps (the correctness check reads the loss of each, the first
gradient from the optimizer state, and the change of every leaf after
them): these steps also build and load the kernels and warm every shape.
The window then goes on with the same step, model and state, one fresh
batch a step, each step closed by ``torch.cuda.synchronize()``, until
``--seconds`` have passed; ``train_tokens_per_s`` is all the tokens of the
window's steps over the window's seconds.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from . import check
from .generate import fill_weights, train_batch
from .reference.common import init_table_fill
from .trace import traced

__all__ = ["run", "make_step"]


def make_step(cfg, tcfg):
    """``(optimizer, step)`` of the program for ``cfg``."""
    from repro_torch.train.train_loop import make_optimizer_for, make_train_step

    opt = make_optimizer_for(cfg, tcfg)
    return opt, make_train_step(cfg, opt, tcfg.microbatch)


def _state_leaf(state: dict, name: str) -> torch.Tensor:
    """A model parameter's slice of an optimizer state tree (a stacked
    leaf's layer ``l`` for ``stack.<l>.<rest>``)."""
    parts = name.split(".")
    layer = None
    if parts[0] == "stack":
        layer, parts = int(parts[1]), ["stack", *parts[2:]]
    node = state
    for key in parts:
        node = node[key]
    return node if layer is None else node[layer]


def run(cell, cfg, seed: int, seconds: float, trace: bool, device: str, started: float) -> dict:
    from repro_torch.models import Transformer
    from repro_torch.train import TrainConfig

    from .harness import reference_family

    c, traffic = cell.config, cell.traffic
    family = reference_family(c)
    opt_cfg = traffic["optimizer"]
    if opt_cfg["eps"] != 1e-8:
        raise ValueError("the program's AdamW takes eps 1e-8")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    table = family.param_table(c)
    model = Transformer(cfg, device=device)
    named = dict(model.named_parameters())
    init_table_fill(table, named)
    fill_weights({n: p.data for n, p in named.items()}, table, seed, device)
    tcfg = TrainConfig(lr=opt_cfg["lr"], warmup_steps=opt_cfg["warmup_steps"],
                       total_steps=opt_cfg["total_steps"], weight_decay=opt_cfg["weight_decay"],
                       b1=opt_cfg["b1"], b2=opt_cfg["b2"], clip_norm=opt_cfg["clip_norm"])
    opt, step_fn = make_step(cfg, tcfg)
    opt_state = opt.init(named)
    V, n_check = c["vocab_size"], traffic["check_steps"]

    # the first gradient's leaves themselves, beside their norms, where the
    # cell's limits compare their distance to the reference's
    distance = "grad_distance_median" in cell.limits
    losses, grad, first = [], None, None
    for i in range(n_check):
        batch = train_batch(traffic, V, seed, i, device)
        model, opt_state, out = step_fn(model, opt_state, i, batch)
        losses.append(out["loss"])
        if i == 0:
            grad, first = {}, ({} if distance else None)
            for n in named:
                g = _state_leaf(opt_state["m"], n) / (1 - tcfg.b1)
                grad[n] = float(g.double().norm())
                if distance:
                    first[n] = g.to("cpu")
            del g
    prog = {"losses": [float(x) for x in losses], "grad": grad,
            "change": check.change_norms(dict(model.named_parameters()), table, seed, device)}
    if on_card:
        torch.cuda.synchronize()

    tr: dict = {}
    step, window_losses = n_check, []
    tokens = traffic["batch"] * traffic["seq_len"]
    setup_s = time.time() - started
    with traced(trace, tr):
        t0 = time.perf_counter()
        while True:
            batch = train_batch(traffic, V, seed, step, device)
            model, opt_state, out = step_fn(model, opt_state, step, batch)
            window_losses.append(out["loss"])
            if on_card:
                torch.cuda.synchronize()
            step += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
    steps = step - n_check
    failed = sum(1 for x in window_losses if not math.isfinite(float(x)))
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    del model, opt_state, out, batch, named, window_losses, losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    check_t0 = time.perf_counter()
    ref = check.reference_train(family, c, traffic, seed, device, other_grad=first)
    del first
    numbers, worst = check.train_numbers(prog, ref)
    ctx = {"kind": "train", "window_s": elapsed, "steps": steps, "busy_s": tr.get("busy_s"),
           "kernels": tr.get("kernels", []), "spans": {}}
    return {
        "end_to_end": {"train_tokens_per_s": steps * tokens / elapsed, "setup_s": setup_s,
                       "peak_mem_gib": peak / 2 ** 30},
        "ctx": ctx, "breakdown": tr.get("breakdown"), "checks": numbers,
        "detail": [f"{k} leaf {n}: program {p!r}, reference {r!r}" for k, n, p, r in worst],
        "answered": failed == 0,
        "check_s": time.perf_counter() - check_t0,
        "attempted": steps, "failed": failed, "memory_peak_bytes": peak, "device_kind": kind,
    }
