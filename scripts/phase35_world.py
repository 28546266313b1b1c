"""Runs ``chip_smoke.py``'s phase 35(a)-(c) alone in phase 31's world.

    PYTHONPATH=src python scripts/phase35_world.py [--adafactor]

Phase 31's world is 4 NCCL ranks, one a card, in a (2, 2) ("data",
"model") mesh on a machine with 4 cards, else one rank on cuda:0.

* Without arguments every rank runs ``chip_smoke.moe_rank``: qwen3-moe-235b
  at full width, the born-sharded init, the sort dispatch trained and
  served against the unsharded steps, with that phase's checks.
* ``--adafactor`` runs the thin case (c) (with 4 cards; else (b)) with
  qwen3-moe's own optimizer, Adafactor at beta1 0, in place of SGD.  For
  each parameter with entries past atol + rtol after the steps it prints,
  at those entries, each step's unsharded gradient against the leaf's
  largest |gradient| and against the leaf's largest difference between the
  two paths' gradients, and the share of them whose sign the two paths
  disagree on; and for each step and microbatch the tokens whose chosen
  experts differ between the paths, with each such token's router margin
  (its k-th largest probability less its (k+1)-th) in both paths.  It
  checks each step's gradients against ``chip_smoke.grad_bounds`` (4 x the
  measured sensitivity on several cards, that sensitivity under
  ``chip_smoke.MOE_SENSITIVITY_CEILING``), except at a step where a token
  took another expert; there every such token must be a near-tie in both
  paths (margin under ``FLIP_MARGIN``, the rule of
  ``tests/test_torch_models.py``): a flip the reference's own function
  allows.

Both print each step's gradient gaps against the sensitivity and the bound,
and exit 1 if a check fails.  Writes rank 0's result to
``chiprun_out/phase35_world<ranks>[_adafactor].json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

#: a routing flip between the paths is a near-tie when the token's margin is under this in
#: both (tests/test_torch_models.py's FLIP_MARGIN)
FLIP_MARGIN = 2e-3


def outside_entries(kept: dict) -> dict:
    """For each parameter with entries past atol + rtol, at those entries:
    their count, and for each step the largest unsharded |gradient| over the
    leaf's largest (``top``) and over the leaf's largest difference between
    the paths (``noise``), and the share whose signs differ."""
    out = {}
    for name, mask in kept["outside"].items():
        steps = []
        for plain, diff in zip(kept["plain_grads"], kept["diffs"]):
            g, d = plain[name], diff[name]
            at, other = g[mask], g[mask] + d[mask]
            top, noise = float(g.abs().max()), float(d.abs().max())
            steps.append({"grad_over_top": float(at.abs().max()) / top if top else 0.0,
                          "grad_over_noise": float(at.abs().max()) / noise if noise else 0.0,
                          "noise_over_top": noise / top if top else 0.0,
                          "sign_differs": float((at * other <= 0).float().mean())})
        out[name] = {"entries": int(mask.sum()), "of": mask.numel(), "steps": steps}
    return out


class _Routes:
    """Records each ``route`` call's expert choices ``[tokens, top_k]``,
    the one-process path's (``moe.route``) apart from the sharded path's
    (``tensor_parallel.route``), in call order (a remat recomputation is
    a call of its own)."""

    def __enter__(self):
        from repro_torch.models import moe, tensor_parallel

        self.saved = (moe.route, tensor_parallel.route)
        self.calls = {"plain": [], "sharded": []}

        def recorded(fn, key):
            def route(p, x, cfg):
                probs, w, idx = fn(p, x, cfg)
                top = probs.detach().topk(cfg.moe_top_k + 1, dim=-1).values
                margin = top[:, cfg.moe_top_k - 1] - top[:, cfg.moe_top_k]
                self.calls[key].append((idx.detach().cpu(), margin.cpu()))
                return probs, w, idx

            return route

        moe.route = recorded(moe.route, "plain")
        tensor_parallel.route = recorded(tensor_parallel.route, "sharded")
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe, tensor_parallel

        moe.route, tensor_parallel.route = self.saved
        return False


def routing_gaps(plain: list, ranks: list, world: int, m: int, steps: int) -> list:
    """Each step's tokens whose chosen experts differ between the paths,
    microbatch by microbatch, with those tokens' router margins in both
    (``flips``: ``(token, plain margin, sharded margin)``).  One row a
    microbatch (the thin layout, or one card): on (2, 2) ("data", "model")
    iteration ``t`` holds microbatches ``2t`` and ``2t + 1`` on data
    coordinates 0 and 1 (ranks 0 and 2); on one card iteration ``t`` is
    microbatch ``t``."""
    per = len(plain) // (steps * m)  # route calls a microbatch: its forward and its remat
    iters = m if world == 1 else m // 2
    out = []
    for s in range(steps):
        for j in range(m):
            rank, t = (0, j) if world == 1 else (2 * (j % 2), j // 2)
            for c in range(per):
                a, ma = plain[(s * m + j) * per + c]
                b, mb = ranks[rank][(s * iters + t) * per + c]
                moved = (a.sort(-1).values != b.sort(-1).values).any(-1)
                out.append({"step": s, "microbatch": j, "call": c, "tokens": int(moved.sum()),
                            "pairs": int((a != b).sum()), "of": a.shape[0],
                            "flips": [(int(i), float(ma[i]), float(mb[i]))
                                      for i in moved.nonzero().flatten().tolist()]})
    return out


def adafactor_failures(res: dict) -> list:
    """The ``--adafactor`` checks that fail: a step's gradients past the
    bound where no token took another expert; a flip that is no near-tie."""
    failed = []
    flipped = {row["step"] for row in res["routing"] if row["tokens"]}
    bounds = chip_smoke.grad_bounds(res, res["world"])
    for step, outside in enumerate(chip_smoke.grads_outside(res, res["world"])):
        if outside and step not in flipped:
            failed.append(f"step {step + 1}: gradients past {bounds[step]:.3g}: {outside}")
    for row in res["routing"]:
        for token, plain, sharded in row["flips"]:
            if not (plain < FLIP_MARGIN and sharded < FLIP_MARGIN):
                failed.append(f"step {row['step'] + 1}, microbatch {row['microbatch']}, token "
                              f"{token}: a flip away from a near-tie ({plain:.3g}, {sharded:.3g})")
    return failed


def adafactor_rank(rank: int, world: int, store: str, out_path: str) -> dict:
    """The thin case (or (b) on one card) with qwen3-moe's Adafactor on
    this rank; rank 0 keeps the gradients and writes the result."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import TrainConfig
    from repro_torch.train.train_loop import make_optimizer_for

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    _build.load()
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        shape = (2, 2) if world == 4 else (1, 1)
        mesh = make_host_mesh(shape, ("data", "model"), device_type="cuda")
        full = configs.get_config("qwen3-moe-235b-a22b")
        cfg = dataclasses.replace(chip_smoke.cut_depth(full, 1), compute_dtype="float32",
                                  serve_param_dtype="float32", moe_dispatch="sort",
                                  moe_capacity=chip_smoke.MOE_SORT_CAPACITY)
        B, m = ((chip_smoke.MOE_THIN_B, chip_smoke.MOE_THIN_M) if world == 4
                else (chip_smoke.MOE_SORT_B, chip_smoke.MOE_SORT_M))
        opt = make_optimizer_for(cfg, TrainConfig())
        with _Routes() as routes:
            res = chip_smoke._moe_train(cfg, mesh, B, m, opt=opt, keep=rank == 0)
        ranks = [None] * world
        dist.all_gather_object(ranks, routes.calls["sharded"])
        # the plain calls: the unsharded run's, then the reordered run's (not compared)
        plain = routes.calls["plain"][:len(routes.calls["plain"]) // 2]
        res["routing"] = routing_gaps(plain, ranks, world, m, chip_smoke.SHARDED_STEPS)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        res["outside_entries"] = outside_entries(res.pop("kept"))
        res.update(rank=rank, world=world, mesh=list(shape))
        with open(out_path, "w") as f:
            json.dump(res, f)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--adafactor", action="store_true",
                    help="the thin case with Adafactor, and where its parameters part")
    opts = ap.parse_args()
    print(chip_smoke.nvidia_smi("name,power.limit"), torch.cuda.device_count(), "card(s)")
    from repro_torch.kernels import _build

    _build.load()
    world, shape = chip_smoke.sharded_world()
    print("world", world, shape, flush=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase35-", dir=os.path.join(ROOT, "build"))
    res = chip_smoke._run_world(world, tmp, adafactor_rank if opts.adafactor
                                else chip_smoke.moe_rank)
    print(f"phase 35 {'(c) with Adafactor' if opts.adafactor else '(a)-(c)'}: "
          f"{time.perf_counter() - t0:.1f} s")
    runs = [res] if opts.adafactor else [res[k] for k in ("train", "thin") if k in res]
    for r in runs:
        print(f"  {r['B']} x {r['S']} in {r['microbatch']} microbatches, {r['optimizer']}: "
              f"gradient gaps {r['grad_worst_rel']}, sensitivity {r['sensitivity']} "
              f"({r['sensitivity_s']:.1f} s), bounds {chip_smoke.grad_bounds(r, world)}, "
              f"leaves past them {chip_smoke.grads_outside(r, world)}")
        for step, (rel, sens) in enumerate(zip(r["grad_rel"], r["sensitivity_rel"])):
            print(f"    step {step + 1} by leaf (gap, sensitivity): "
                  f"{ {n: (round(v, 9), round(sens[n], 9)) for n, v in rel.items()} }")
    failed = []
    if opts.adafactor:
        for key in ("plain_losses", "sharded_losses", "plain_grad_norms", "sharded_grad_norms",
                    "param_excess", "params_outside"):
            print(f"  {key}: {res[key]}")
        for name, v in res["outside_entries"].items():
            print(f"  {name}: {v}")
        for row in res["routing"]:
            print(f"  routing: {row}")
        failed = adafactor_failures(res)
        for line in failed:
            print(f"  FAILED: {line}")
    out = os.path.join(ROOT, "chiprun_out",
                       f"phase35_world{world}{'_adafactor' if opts.adafactor else ''}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
