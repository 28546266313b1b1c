"""Probes xlstm-1.3b's training loss at its initial weights on one CUDA card.

    PYTHONPATH=src python scripts/xlstm_descent_probe.py [--out probe.json]

Full width and depth, weights drawn from seed 0 as ``launch.train`` draws
them, ``SyntheticLM`` batches of 8 sequences.

1. AdamW at lr +3e-4 (the launcher's) and -3e-4 (the update's sign
   flipped), built as ``launch.train`` builds it, trains on one batch for a
   few steps: 8 steps on batches 0-2 of 256 tokens, 6 steps on batch 0 of
   2048 tokens, in bfloat16 compute.  A correct update lowers that batch's
   loss and a flipped one raises it, where the loss is smooth enough for a
   few steps to show it.
2. The loss along the gradient, in float32 compute: g at the initial
   weights, then the batch's loss at ``w - s eps g / |g|`` for s = +-1
   against the first-order change ``-s eps |g|``, on batch 0 of 256 tokens
   (8 sequences) and of 2048 tokens (2 sequences).

Prints one line a run; ``--out`` also writes them as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.models import Transformer, init_model_params, loss_fn  # noqa: E402
from repro_torch.train import SyntheticLM, TrainConfig, make_train_step  # noqa: E402
from repro_torch.train.train_loop import make_optimizer_for  # noqa: E402


def adamw_on_one_batch(model, initial, batch, lr: float, steps: int) -> list[float]:
    """The batch's loss before each of ``steps`` AdamW steps on it, and
    after the last, from the initial weights."""
    model.load_state_dict(initial)
    opt = make_optimizer_for(model.cfg, TrainConfig(lr=lr, warmup_steps=1, total_steps=steps))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model.cfg, opt)
    losses = [float(step(model, state, i, batch)[2]["loss"]) for i in range(steps)]
    with torch.no_grad():
        losses.append(float(loss_fn(model, batch)[0]))
    return losses


def along_the_gradient(model, initial, batch, lengths) -> dict:
    """|g| at the initial weights and the loss's change at ``w - s eps g / |g|``
    for each eps in ``lengths`` and s = +-1."""
    model.load_state_dict(initial)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    grads = torch.autograd.grad(loss_fn(model, batch)[0], list(named.values()))
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    rows = []
    with torch.no_grad():
        base = float(loss_fn(model, batch)[0])
        for eps in lengths:
            for sign in (1, -1):
                for (name, p), g in zip(named.items(), grads):
                    p.copy_(initial[name] - (sign * eps / norm) * g)
                change = float(loss_fn(model, batch)[0]) - base
                rows.append({"eps": eps, "sign": sign, "change": change,
                             "first_order": -sign * eps * norm})
    for p in named.values():
        p.requires_grad_(False)
    return {"loss": base, "grad_norm": norm, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("xlstm_descent_probe: no CUDA device available", file=sys.stderr)
        return 1
    cfg = configs.get_config("xlstm-1.3b")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    results = {"adamw": [], "gradient": []}
    for S, at, steps in ((256, 0, 8), (256, 1, 8), (256, 2, 8), (2048, 0, 6)):
        batch = SyntheticLM(cfg, 8, S, device="cuda").batch_at(at)
        for lr in (3e-4, -3e-4):
            losses = adamw_on_one_batch(model, initial, batch, lr, steps)
            results["adamw"].append({"S": S, "batch": at, "lr": lr, "losses": losses})
            print(f"bf16 AdamW lr {lr:+.0e}, batch {at} of 8 x {S}, {steps} steps: "
                  f"{losses[0]:.6f} -> {losses[-1]:.6f} ({losses[-1] - losses[0]:+.6f}); "
                  + " ".join(f"{l:.4f}" for l in losses), flush=True)
        del batch
        torch.cuda.empty_cache()
    del model
    model = Transformer(cfg32, device="cuda")
    for B, S, lengths in ((8, 256, (1e-6, 1e-5, 1e-4)), (2, 2048, (1e-9, 1e-8, 1e-7, 1e-6))):
        batch = SyntheticLM(cfg32, B, S, device="cuda").batch_at(0)
        probe = along_the_gradient(model, initial, batch, lengths)
        results["gradient"].append({"B": B, "S": S, **probe})
        print(f"f32 along -g / |g|, batch 0 of {B} x {S}: loss {probe['loss']:.6f}, "
              f"|g| {probe['grad_norm']:.1f}", flush=True)
        for r in probe["rows"]:
            print(f"  eps {r['eps']:.0e} sign {r['sign']:+d}: change {r['change']:+.4e}, "
                  f"first order {r['first_order']:+.4e} (ratio "
                  f"{r['change'] / r['first_order']:.4f})", flush=True)
        del batch
        torch.cuda.empty_cache()
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
