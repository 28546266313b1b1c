"""Train launcher (one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        [--smoke] [--steps 100 --batch 8 --seq 128 --lr 3e-4 --microbatch 0] \\
        [--workdir DIR] [--data tokens.int32] [--device cpu]

Runs on the card unless ``--device cpu`` is given (the kernels then take
their plain PyTorch versions).  Auto-resumes from the newest checkpoint in
``--workdir``; SIGTERM checkpoints and exits cleanly (preemption-safe).
Weights start random, drawn from a generator seeded with
``TrainConfig.seed`` (0).
"""

from __future__ import annotations

import argparse


def main(argv: "list[str] | None" = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--data", default=None, help="packed int32 token file (memmap)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models import count_params
    from repro_torch.train import TrainConfig, Trainer, make_data

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    tcfg = TrainConfig(
        lr=args.lr,
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        eval_every=max(args.steps // 20, 1),
        checkpoint_every=max(args.steps // 4, 1),
        microbatch=args.microbatch,
    )
    data = make_data(cfg, args.batch, args.seq, path=args.data)
    trainer = Trainer(cfg, tcfg, data, workdir=args.workdir, device=args.device)
    print(f"[train] {cfg.name}: {count_params(cfg)/1e6:.1f}M params on {trainer.device}")
    result = trainer.run()
    print(f"[train] done at step {result['step']}; losses: "
          + " ".join(f"{l:.3f}" for l in result.get("losses", [])))
    return result


if __name__ == "__main__":
    main()
