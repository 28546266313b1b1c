"""Runs ``chip_smoke.py``'s phase 36 alone: a prefill's rows in chunks by the
memory rule of ``launch.specs.build_step``.

    PYTHONPATH=src python scripts/phase36_world.py

Builds the kernels, starts (a) (llava-next-34b's ``prefill_32k`` on 512 fake
ranks, host-bound) in a worker process, then runs (b) in phase 31's world (4
NCCL ranks, one a card, on a machine with 4 cards, else one rank on cuda:0)
and, with 4 cards, (c): xlstm-1.3b's regime (B) on 3 ranks and gemma2-9b's
long_500k cache across its "data" shard boundary on 4.  Each world runs
even where an earlier one failed; the script prints every failure and exits
1 if there was one.  Writes the results to
``chiprun_out/phase36_world<cards>.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("phase36_world: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print(chip_smoke.nvidia_smi("name,power.limit"), torch.cuda.device_count(), "card(s)")
    _build.load()
    pool, pending = chip_smoke.start_llava_rows_cell()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    res, failed = {}, []
    parts = [(key, lambda k=key, n=n, fn=fn: chip_smoke.prefill_rows_world(k, n, fn))
             for key, n, fn in chip_smoke.prefill_rows_worlds()]
    for key, run in parts + [("cell", lambda: chip_smoke._llava_rows_cell(pool, pending))]:
        try:
            res[key] = run()
        except Exception as e:  # reported, and the next world runs
            failed.append(f"{key}: {type(e).__name__}: {e}")
    print(f"phase 36: {time.perf_counter() - t0:.1f} s")
    for line in failed:
        print(f"FAILED {line}")
    out = os.path.join(ROOT, "chiprun_out", f"phase36_world{torch.cuda.device_count()}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
