"""The comparison that decides ``correct``, and the reference's side of it.

Training: the first ``check_steps`` steps of the cell, which set-up drives
through the window's own step on the window's own batches, against the
plain reference's steps from the same weights and batches, computed in
float32 with TF32 off after the window:

* ``loss_gap``: the largest ``|loss - reference loss|`` over those steps;
* ``grad_gap``: of the first gradient as the optimizer gets it (clipped;
  the program's read from its AdamW state after one step, ``m / (1 -
  b1)``), the worst leaf's ``|norm - reference norm| / max(reference norm,
  the median leaf's reference norm)``;
* ``change_gap``: the same of each leaf's change over those steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (their change is round-off);
* ``grad_distance_median``: the median leaf's ``||g - g_ref|| / ||g_ref||``
  of that first gradient (read where a cell's limits compare it: the
  program's gradient waits on the host while the reference runs).

Serving: over a sample of the window's finished groups, each served token's
gap below the reference's best logit at its position: ``token_gap``, the
widest, and ``token_gap_mean``, the mean.

A cell's ``limits/<cell>.json`` names the numbers it compares; the others
are printed on standard error beside them.
"""

from __future__ import annotations

import math
import statistics
from collections import defaultdict

import torch

from .generate import reference_weights, train_batch, weight_pieces
from .reference.common import adamw_update, full_float32

__all__ = ["change_norms", "leaf_gaps", "train_numbers", "reference_train",
           "SMALL_GRAD"]

#: leaves whose reference gradient norm is under this share of the median
#: leaf's are left out of ``change_gap``
SMALL_GRAD = 1e-3


@torch.no_grad()
def change_norms(params: dict, table: list, seed: int, device) -> dict:
    """``{name: ||p - p_0||}``, ``p_0`` the weights drawn again from ``seed``."""
    sums = defaultdict(float)
    for name, offset, values in weight_pieces(table, seed, device):
        now = params[name].detach().reshape(-1)[offset:offset + values.numel()]
        sums[name] += float((now.float() - values).pow(2).sum(dtype=torch.float64))
    return {name: math.sqrt(s) for name, s in sums.items()}


def leaf_gaps(prog: dict, ref: dict, names=None) -> dict:
    """``{leaf: |prog norm - ref norm| / max(ref norm, the median leaf's)}``."""
    names = list(ref) if names is None else list(names)
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def train_numbers(prog: dict, ref: dict) -> tuple[dict, list]:
    """``(the numbers, the worst leaves)`` from two sides' ``{"losses",
    "grad", "change"}``: each leaf gap's worst leaf (``grad_gap``,
    ``change_gap``) and, where the reference side holds the distances, the
    median leaf's gradient distance (``grad_distance_median``).  The worst
    leaves, ``(number, leaf, program norm, reference norm)``, go to standard
    error."""
    med = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= SMALL_GRAD * med]
    numbers = {"loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))}
    worst = []
    for key, names in (("grad", None), ("change", moving)):
        gaps = leaf_gaps(prog[key], ref[key], names)
        numbers[f"{key}_gap"] = max(gaps.values())
        for n in sorted(gaps, key=gaps.get)[-3:]:
            worst.append((f"{key}_gap", n, prog[key][n], ref[key][n]))
    if "distance" in ref:
        numbers["grad_distance_median"] = statistics.median(ref["distance"].values())
    return numbers, worst


@torch.no_grad()
def host_copy(tensors: dict) -> dict:
    """``{name: a float32 copy on the host}``, for a comparison made after
    the device's state is freed."""
    return {n: t.detach().to("cpu", torch.float32, copy=True) for n, t in tensors.items()}


def reference_train(family, config: dict, traffic: dict, seed: int, device, prec=None,
                    other_grad: "dict | None" = None, keep_grad: bool = False) -> dict:
    """The reference's ``check_steps`` AdamW steps from the seed's weights
    on the seed's batches: ``{"losses", "grad", "change"}`` (per-leaf
    norms of the first clipped gradient, and of the change).  With
    ``other_grad`` (another side's first clipped gradient, on the host) also
    ``"distance"``: each leaf's ``||other - reference|| / ||reference||``;
    with ``keep_grad`` also ``"first_grad"``, this side's on the host."""
    table = family.param_table(config)
    params = reference_weights(table, seed, device)
    for p in params.values():
        p.requires_grad_(True)
    opt = traffic["optimizer"]
    tokens = traffic["batch"] * traffic["seq_len"]
    aux_coef = config.get("moe_aux_coef", 0.0)
    state, losses, out = {}, [], {}
    with full_float32():
        for i in range(traffic["check_steps"]):
            batch = train_batch(traffic, config["vocab_size"], seed, i, device)
            ce, aux = family.loss_sum(params, batch["tokens"], batch["labels"], config, prec)
            loss = ce / tokens + aux_coef * aux
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            norm = adamw_update(params, grads, state, i, opt)
            if i == 0:
                scale = min(1.0, opt["clip_norm"] / max(norm, 1e-9))
                out["grad"] = {n: float(g.double().norm()) * scale for n, g in grads.items()}
                if other_grad is not None:
                    out["distance"] = {
                        n: float((other_grad[n].to(device) - g * scale).norm()) / max(
                            out["grad"][n], 1e-30) for n, g in grads.items()}
                if keep_grad:
                    out["first_grad"] = host_copy({n: g * scale for n, g in grads.items()})
            losses.append(float(loss.detach()))
            del grads, loss, ce, aux
    out["change"] = change_norms(params, table, seed, device)
    del params, state
    return dict(out, losses=losses)
