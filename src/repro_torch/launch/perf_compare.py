"""Run one cell's dry-run under config overrides and report the three
roofline terms, the measurement half of a hypothesis -> change -> measure
loop: the port's counterpart of the reference's ``launch/perf_compare.py``.

    PYTHONPATH=src python -m repro_torch.launch.perf_compare --arch gemma2-9b \\
        --shape train_4k --set remat=none --set moe_group=512 [--multi-pod] [--json] \\
        [--device cpu]

The cell runs as ``launch/dryrun.py`` runs it (a world of fake ranks, fake
tensors, ``op_analysis.analyze_step``) on ``dataclasses.replace(cfg,
**overrides)``; the terms are ``launch/roofline.py``'s, on H100 rates.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time


def measure(arch: str, shape: str, overrides: dict, multi_pod: bool = False,
            device: str = "cuda") -> dict:
    from .. import configs
    from .dryrun import analyze_cell
    from .roofline import HBM_BW, PEAK_FLOPS, collective_seconds

    cfg = configs.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    t0 = time.time()
    st = analyze_cell(cfg, shape, multi_pod, device)["stats"]
    return {
        "arch": arch,
        "shape": shape,
        "device": device,
        "overrides": {k: str(v) for k, v in overrides.items()},
        "run_s": round(time.time() - t0, 1),
        "t_compute_s": st.flops / PEAK_FLOPS,
        "t_memory_s": st.bytes_accessed / HBM_BW,
        "t_collective_s": collective_seconds(st.collectives_by_dim),
        "collectives": dict(st.collectives),
        "collectives_by_dim": st.collectives_by_dim,
        "mem_per_dev_gib": st.memory["per_device_total"] / 2**30,
        "flops": st.flops,
        "bytes": st.bytes_accessed,
        "collective_bytes": st.collective_bytes,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[], help="field=value overrides")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "False"):
            v = v == "True"
        overrides[k] = v

    r = measure(args.arch, args.shape, overrides, args.multi_pod, args.device)
    if args.json:
        print(json.dumps(r, indent=1))
    else:
        print(
            f"{args.arch} {args.shape} {overrides or 'baseline-config'} ({args.device})\n"
            f"  compute   {r['t_compute_s']:10.4f} s  ({r['flops']:.3e} flops/dev)\n"
            f"  memory    {r['t_memory_s']:10.4f} s  ({r['bytes']:.3e} B/dev)\n"
            f"  collective{r['t_collective_s']:10.4f} s  ({r['collective_bytes']:.3e} B/dev)"
            f"  {({k: f'{v:.2e}' for k, v in r['collectives'].items()})}\n"
            f"  mem/dev   {r['mem_per_dev_gib']:10.2f} GiB   run {r['run_s']}s"
        )


if __name__ == "__main__":
    main()
