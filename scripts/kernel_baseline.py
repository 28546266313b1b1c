"""Times this checkout's Parzen and SSD wrappers against another commit's on one card.

    mkdir -p build/parent
    git archive <commit> src/repro_torch | tar -x -C build/parent
    PYTHONPATH=src python scripts/kernel_baseline.py --parent build/parent [--padded] [--out FILE]

The other commit's ``repro_torch.kernels`` package is imported from
``DIR/src`` under another name and builds its own kernels with its own
``_build`` (into ``DIR/build/``), so each side runs through its own wrapper,
as the main path calls it.  On inputs from a seeded generator, at the
Parzen shapes of ``chip_smoke.py``'s phases 2-4 and the SSD shapes of its
phase 17, both outputs are held to the plain version (Parzen within atol
2e-4 / rtol 1e-4; SSD within 2e-3 of the plain version run in float64),
and both are timed in the same process two ways: ``ms``, CUDA events
around eager calls (what the main path pays, the host's work a call
included), the median of 5 rounds that alternate the two sides (the
host's speed drifts), and ``card_ms``, CUDA events around replays of a
CUDA graph of the calls (the card's time alone).  The Parzen components go
to each side as its own main path hands them: unpadded here, and padded to
powers of two on the other side where its ``tpe.py`` padded them
(``--padded``).
Prints one line a shape; ``--out`` also writes them as JSON.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the phases' input makers, timers and tolerances)
from repro_torch.kernels import parzen, ssd  # noqa: E402
from repro_torch.kernels.ref import parzen_score_ref  # noqa: E402

#: (label, C, Kl, Kg): phase 3's and phase 4's final histories scored at
#: their 24 EI candidates, phase 4's score table, and phase 2's largest row
PARZEN_SHAPES = (("phase 3, C=24", 24, 2, 10), ("phase 4, C=24", 24, 26, 4072),
                 ("score table", 4096, 26, 4072), ("phase 2", 4096, 32, 4096))

#: (label, B, S, H, P, G, N, chunk, bf16, init, model layout), from phase 17
SSD_SHAPES = (("zamba2 prefill", 8, 2048, 64, 64, 1, 64, 128, True, True, True),
              ("zamba2 training", 8, 2048, 64, 64, 1, 64, 128, True, False, True),
              ("zamba2 heads, L=64", 2, 2048, 64, 64, 1, 64, 64, True, True, True),
              ("odd S", 2, 1001, 8, 16, 1, 16, 128, True, True, True),
              ("tune N=8 bf16", 8, 64, 16, 16, 1, 8, 16, True, False, True),
              ("zamba2 prefill float32", 8, 2048, 64, 64, 1, 64, 128, False, True, True))


def import_kernels(src: str, name: str):
    """``src``'s ``repro_torch.kernels`` as the package ``name``."""
    init = os.path.join(src, "repro_torch", "kernels", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.parzen"), importlib.import_module(f"{name}.ssd")


def timings(fns: dict, reps: int, graph_calls: int, rounds: int = 5) -> dict:
    """Per side of ``fns``: the median ``ms`` of ``rounds`` rounds of ``reps``
    eager calls, the sides alternating (each round's order reversed from the
    last), the rounds themselves, and ``card_ms``."""
    eager = {side: [] for side in fns}
    for r in range(rounds):
        for side in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            eager[side].append(cs.time_ms(fns[side], reps))
    return {side: {"ms": float(np.median(eager[side])), "ms_rounds": eager[side],
                   "card_ms": cs.graph_ms(fn, graph_calls, max(1, reps // graph_calls))}
            for side, fn in fns.items()}


def pad_pow2(a: np.ndarray, fill: float) -> np.ndarray:
    n = 1 << (len(a) - 1).bit_length()
    return np.concatenate([a, np.full(n - len(a), fill)])


def parzen_rows(other, padded: bool) -> list[dict]:
    rng = np.random.RandomState(0)
    rows = []
    for label, C, n_l, n_g in PARZEN_SHAPES:
        l_side, g_side = cs.synthetic_mixture(rng, n_l, 0), cs.synthetic_mixture(rng, n_g, 0)
        cands = rng.uniform(-3.5, 3.5, C)
        to_card = lambda arrs: [torch.from_numpy(np.asarray(a, np.float32)).cuda() for a in arrs]
        args = to_card((cands, *l_side, *g_side))
        other_args = args
        if padded:
            other_args = to_card((cands, *(pad_pow2(a, f) for side in (l_side, g_side)
                                           for a, f in zip(side, (0.0, 1.0, -np.inf)))))
        ref = parzen_score_ref(*args)
        row = {"label": label, "C": C, "Kl": n_l, "Kg": n_g,
               "other_Kl": len(other_args[1]), "other_Kg": len(other_args[4])}
        fns = {"kernel": lambda: parzen.parzen_score(*args),
               "other": lambda: other.parzen_score(*other_args)}
        for fn in fns.values():
            torch.testing.assert_close(fn(), ref, atol=cs.ATOL, rtol=cs.RTOL)
        row.update(timings(fns, 200, 20))
        print(f"parzen {label:<14} C={C:<5} Kl={n_l:<3} Kg={n_g:<5} (other "
              f"{row['other_Kl']} / {row['other_Kg']}): kernel {row['kernel']['ms']:.5f} ms "
              f"(card {row['kernel']['card_ms']:.5f}), other {row['other']['ms']:.5f} ms "
              f"(card {row['other']['card_ms']:.5f})", flush=True)
        rows.append(row)
    return rows


def ssd_rows(other) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = []
    for label, B, S, H, P, G, N, chunk, bf16, init, layout in SSD_SHAPES:
        dtype = torch.bfloat16 if bf16 else torch.float32
        args = cs.ssd_inputs(gen, B, S, H, P, G, N, dtype, init, layout)
        want = cs.ssd_float64(args, chunk)
        row = {"label": label, "B": B, "S": S, "H": H, "P": P, "N": N, "chunk": chunk,
               "dtype": str(dtype).removeprefix("torch.")}
        fns = {"kernel": lambda: ssd.ssd_forward(*args[:5], chunk, args[5]),
               "other": lambda: other.ssd_forward(*args[:5], chunk, args[5])}
        errs = {}
        for side, fn in fns.items():
            y, fin = fn()
            errs[side] = max(float((y.double() - want[0]).abs().max()),
                             float((fin.double() - want[1]).abs().max()))
            assert errs[side] <= cs.SSD_TOL, (label, side, errs[side])
            del y, fin
        row.update(timings(fns, 10 if S >= 1000 else 50, 5))
        for side, err in errs.items():
            row[side]["max_abs_err"] = err
        print(f"ssd {label:<24} B={B} S={S:<5} H={H:<3} P={P:<3} N={N:<3} L={chunk:<4} "
              f"{row['dtype']:<9}: kernel {row['kernel']['ms']:.4f} ms (card "
              f"{row['kernel']['card_ms']:.4f}; from float64 {row['kernel']['max_abs_err']:.3e}), "
              f"other {row['other']['ms']:.4f} ms (card {row['other']['card_ms']:.4f})",
              flush=True)
        rows.append(row)
        del args, want
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the other commit's src/repro_torch")
    ap.add_argument("--padded", action="store_true",
                    help="pad the other side's Parzen components to powers of two")
    ap.add_argument("--out", help="also write the rows to this JSON file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_baseline: no CUDA device available", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi("name,power.limit")
    print(smi)
    other_parzen, other_ssd = import_kernels(os.path.join(opts.parent, "src"), "other_kernels")
    result = {"nvidia_smi": smi, "parzen": parzen_rows(other_parzen, opts.padded),
              "ssd": ssd_rows(other_ssd)}
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
