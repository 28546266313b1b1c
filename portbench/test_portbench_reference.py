"""The plain references held to the program at its smoke configurations,
in float32 on the CPU: the forward pass, the loss and every gradient, and
one AdamW step, on weights and tokens the benchmark draws from a seed."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import generate
from portbench.check import change_norms
from portbench.harness import reference_family
from portbench.reference.common import adamw_update, full_float32
from portbench.smoke import smoke_cell

CELLS = {"deepseek": "deepseek-train-8x2048"}
SEED = 2 ** 32 + 17


def _setup(family_name: str):
    from repro_torch.models import Transformer

    cell, cfg = smoke_cell(CELLS[family_name], batch=2, seq_len=32)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    family = reference_family(cell.config)
    table = family.param_table(cell.config)
    model = Transformer(cfg, device="cpu")
    generate.fill_weights({n: p.data for n, p in model.named_parameters()}, table, SEED, "cpu")
    ref = {n: torch.empty(s) for n, s, _, _ in table}
    generate.fill_weights(ref, table, SEED, "cpu")
    batch = generate.train_batch(cell.traffic, cell.config["vocab_size"], SEED, 0, "cpu")
    return cell, cfg, family, table, model, ref, batch


@pytest.mark.parametrize("family_name", sorted(CELLS))
def test_forward_matches_the_program(family_name):
    from repro_torch.models import forward

    cell, cfg, family, _, model, ref, batch = _setup(family_name)
    with torch.no_grad():
        x, _, aux = forward(model, {"tokens": batch["tokens"]}, mode="train")
        h, ref_aux = family.hidden(ref, batch["tokens"], cell.config)
    assert torch.allclose(x, h, atol=2e-5, rtol=1e-4), float((x - h).abs().max())
    assert abs(float(aux) - float(ref_aux)) < 1e-5


@pytest.mark.parametrize("family_name", sorted(CELLS))
def test_loss_and_gradients_match_the_program(family_name):
    from repro_torch.models import loss_fn

    cell, cfg, family, _, model, ref, batch = _setup(family_name)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, _ = loss_fn(model, batch)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    for p in ref.values():
        p.requires_grad_(True)
    ce, aux = family.loss_sum(ref, batch["tokens"], batch["labels"], cell.config)
    ref_loss = ce / batch["tokens"].numel() + cell.config.get("moe_aux_coef", 0.0) * aux
    ref_grads = dict(zip(ref, torch.autograd.grad(ref_loss, list(ref.values()))))
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < 1e-5
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        scale = float(ref_grads[name].abs().max()) + 1e-6
        assert torch.allclose(g, ref_grads[name], atol=1e-4 * scale, rtol=1e-3), name


@pytest.mark.parametrize("family_name", sorted(CELLS))
def test_one_adamw_step_matches_the_program(family_name):
    from repro_torch.train.train_loop import TrainConfig, make_optimizer_for, make_train_step

    cell, cfg, family, table, model, ref, batch = _setup(family_name)
    o = cell.traffic["optimizer"]
    tcfg = TrainConfig(lr=o["lr"], warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                       weight_decay=o["weight_decay"], b1=o["b1"], b2=o["b2"],
                       clip_norm=o["clip_norm"])
    opt = make_optimizer_for(cfg, tcfg)
    state = opt.init(dict(model.named_parameters()))
    model, state, out = make_train_step(cfg, opt)(model, state, 0, batch)
    for p in ref.values():
        p.requires_grad_(True)
    with full_float32():
        ce, aux = family.loss_sum(ref, batch["tokens"], batch["labels"], cell.config)
        loss = ce / batch["tokens"].numel() + cell.config.get("moe_aux_coef", 0.0) * aux
        grads = dict(zip(ref, torch.autograd.grad(loss, list(ref.values()))))
        norm = adamw_update(ref, grads, {}, 0, o)
    assert abs(float(out["grad_norm"]) - norm) < 1e-4 * norm
    prog = change_norms(dict(model.named_parameters()), table, SEED, "cpu")
    want = change_norms(ref, table, SEED, "cpu")
    for name in want:
        assert abs(prog[name] - want[name]) <= 1e-3 * want[name] + 1e-7, name
