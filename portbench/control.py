"""The readings that the correctness limits are set from, on the card at a
cell's own size: the control (the plain reference computed with float8
e4m3 operands, the step below the configurations' bfloat16, put in the
program's place) and the faults a cell can have, each on several seeds.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--faults]
    python3 portbench/control.py --workload <cell> --seeds ... --program [--look]

Training cells: the control's numbers against the float32 reference; with
``--faults`` also a run with half of each batch left out (the mean over
the rest).  A step that returns its state unchanged reads ``change_gap`` 1
by the measure and needs no run.  Serving cells: a short window of the
cell, then on the same sampled groups the gaps of the tokens the control
puts first; with ``--faults`` a run whose engine alters the first row's
token where it is produced.  ``--program``: sound runs of the cell, every
number of its check read (the lower readings); with ``--look`` (serving)
the routing at each sampled group's widest gap.  Prints one JSON line a
seed and reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import cell_serve, cell_train, check, harness  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """The program's step fed the first half of each batch's rows."""
    make = cell_train.make_step

    def broken(cfg, tcfg):
        opt, step = make(cfg, tcfg)

        def half(model, state, step_no, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(model, state, step_no, {k: v[:rows] for k, v in batch.items()})

        return opt, half

    cell_train.make_step = broken
    try:
        yield
    finally:
        cell_train.make_step = make


@contextlib.contextmanager
def state_unchanged():
    """The program's step returning the parameters as they came in."""
    make = cell_train.make_step

    def broken(cfg, tcfg):
        opt, step = make(cfg, tcfg)

        def frozen(model, state, step_no, batch):
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            model, state, out = step(model, state, step_no, batch)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(before[n])
            return model, state, out

        return opt, frozen

    cell_train.make_step = broken
    try:
        yield
    finally:
        cell_train.make_step = make


@contextlib.contextmanager
def token_altered():
    """The engine's first row serving the next token id after its choice."""
    from repro_torch.serve import engine

    sample = engine.sample_token

    def broken(generator, logits, temperature=0.0, top_k=0):
        tok = sample(generator, logits, temperature, top_k)
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok

    engine.sample_token = broken
    try:
        yield
    finally:
        engine.sample_token = sample


@contextlib.contextmanager
def control_gaps(out: list):
    """Records, beside each sampled group's gap, the control's: the gap of
    the token that the float8 reference puts first."""
    gaps = cell_serve.token_gaps

    def both(family, params, config, group, served, max_new, device, prec=None):
        gaps_, low = gaps(family, params, config, group, served, max_new, device, prec="fp8")
        out.extend(low)
        return gaps_, None

    cell_serve.token_gaps = both
    try:
        yield
    finally:
        cell_serve.token_gaps = gaps


@contextlib.contextmanager
def router_margins(out: list):
    """Records, for the widest-gap served token of each sampled group, the
    reference's routing margin at its position in every MoE layer: the
    probability of its 6th expert less that of the 7th (a near-tie, where
    a bfloat16 hidden state can route the token elsewhere)."""
    from portbench.reference import deepseek

    gaps, moe_call = cell_serve.token_gaps, deepseek._moe_call

    def looked(family, params, config, group, served, max_new, device, prec=None):
        found, low = gaps(family, params, config, group, served, max_new, device, prec)
        worst = max(range(len(found)), key=found.__getitem__)
        row, j = divmod(worst, max_new)
        S = max(len(p) for p in group)
        calls = []

        def record(p, pre, xt, m, prec_):
            calls.append((pre, xt))
            return moe_call(p, pre, xt, m, prec_)

        deepseek._moe_call = record
        try:
            rows, _ = cell_serve._padded(group, served, max_new, device)
            with torch.no_grad():
                family.hidden(params, rows, config, None,
                              calls=[(0, S)] + [(S + i, S + i + 1) for i in range(max_new - 1)])
        finally:
            deepseek._moe_call = moe_call
        m = deepseek.dims(config)
        layers = []
        for i, (pre, xt) in enumerate(calls):
            if i % max_new != j:
                continue
            at = row * S + S - 1 if j == 0 else row
            probs, _, idx = deepseek.route(xt, params[f"{pre}.moe.router"], m)
            top = probs[at].sort(descending=True).values
            rank, C = deepseek.ranks(idx, m)
            layers.append({"layer": pre, "margin": float(top[m["k"] - 1] - top[m["k"]]),
                           "places": rank[at].tolist(), "capacity": C,
                           "dropped_in_call": int((rank >= C).sum())})
        out.append({"gap": found[worst], "row": row, "token": j, "layers": layers})
        return found, low

    cell_serve.token_gaps = looked
    try:
        yield
    finally:
        cell_serve.token_gaps = gaps


#: every number each kind's check gives
NUMBERS = {"train": ("loss_gap", "grad_gap", "change_gap", "grad_distance_median"),
           "serve": ("token_gap", "token_gap_mean")}


def _readings(cell, seed: int, seconds: float) -> dict:
    """A run of the cell, every number of its check read (none compared)."""
    limits = cell.limits
    cell.limits = {n: {"limit": math.inf} for n in NUMBERS[cell.traffic["kind"]]}
    try:
        r = harness.run_cell(cell, seed, seconds, False)
    finally:
        cell.limits = limits
    numbers = {k: v["value"] for k, v in r["checks"].items()}
    correct = r["correct"] and all(numbers[k] <= v["limit"] for k, v in limits.items())
    return {"checks": numbers, "correct": correct}


def _emit(**row) -> None:
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--program", action="store_true",
                    help="sound runs of the program only, every number read")
    ap.add_argument("--look", action="store_true",
                    help="serving: the routing margins at each sampled group's widest gap")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    family = harness.reference_family(cell.config)
    row = dict(workload=args.workload)
    for seed in seeds:
        t = time.time()
        if args.program:
            looks: list = []
            with router_margins(looks) if args.look else contextlib.nullcontext():
                _emit(**row, seed=seed, reading="program", **_readings(cell, seed, args.seconds),
                      seconds=time.time() - t, looks=looks)
        elif cell.traffic["kind"] == "train":
            low = check.reference_train(family, cell.config, cell.traffic, seed, "cuda", "fp8",
                                        keep_grad=True)
            ref = check.reference_train(family, cell.config, cell.traffic, seed, "cuda",
                                        other_grad=low.pop("first_grad"))
            numbers, worst = check.train_numbers(low, ref)
            _emit(**row, seed=seed, reading="control", checks=numbers, worst=worst,
                  seconds=time.time() - t)
            del ref, low
            torch.cuda.empty_cache()
            if args.faults:
                with half_batch():
                    _emit(**row, seed=seed, reading="half_batch",
                          **_readings(cell, seed, args.seconds))
        else:
            lows: list = []
            with control_gaps(lows):
                _emit(**row, seed=seed, reading="program", **_readings(cell, seed, args.seconds))
            _emit(**row, seed=seed, reading="control", checks=cell_serve.gap_numbers(lows),
                  seconds=time.time() - t)
            if args.faults:
                with token_altered():
                    _emit(**row, seed=seed, reading="token_altered",
                          **_readings(cell, seed, args.seconds))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
