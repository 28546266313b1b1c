"""Serving launcher: batched generation with the slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        [--smoke] [--requests 8 --max-new 32 --slots 4 --capacity 256 \\
        --temperature 0] [--checkpoint PATH] [--device cpu]

Runs on the card unless ``--device cpu`` is given (the prefill's flash
attention and SSD scan then take their kernels' plain PyTorch versions).  The
weights come from ``--checkpoint`` (a parameter tree saved with
``train.save_pytree``, by this package or the reference's), else they are
random, drawn by ``init_model_params`` from a generator seeded with 0.
"""

from __future__ import annotations

import argparse
import time


def main(argv: "list[str] | None" = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default=None, help="restore params from this .ckpt")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer, init_model_params
    from repro_torch.models import load_params_tree, params_tree
    from repro_torch.serve import Engine
    from repro_torch.train import restore_pytree

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    device = ops.resolve_device("auto", args.device)
    if args.checkpoint:
        model = Transformer(cfg, device=device)
        _, tree = restore_pytree(args.checkpoint, params_tree(model))
        load_params_tree(model, tree)
    else:
        model = init_model_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    engine = Engine(cfg, model, capacity=args.capacity, slots=args.slots,
                    temperature=args.temperature, device=device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=rng.randint(4, 17)).astype(np.int32)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new=args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n = sum(len(o) for o in outs)
    print(f"[serve] {cfg.name} on {device}: {n} tokens / {dt:.2f}s = {n / dt:.1f} tok/s "
          f"({args.requests} requests, {args.slots} slots)")
    return {"arch": cfg.name, "device": str(device), "prompts": prompts, "outputs": outs,
            "tokens": n, "seconds": dt}


if __name__ == "__main__":
    main()
