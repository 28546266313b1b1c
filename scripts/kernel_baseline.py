"""Times this checkout's kernels and MOTPE study against another commit's on one card.

    mkdir -p build/parent
    git archive <commit> src/repro_torch | tar -x -C build/parent
    PYTHONPATH=src python scripts/kernel_baseline.py --parent build/parent [--padded] \
        [--only parzen,ssd,slstm,motpe,xlstm] [--out FILE]

The other commit's ``repro_torch`` package is imported from ``DIR/src``
under another name and builds its own kernels with its own ``_build``
(into ``DIR/build/``), so each side runs through its own code, as the main
path calls it.  On inputs from a seeded generator, at the Parzen shapes of
``chip_smoke.py``'s phases 2-4, the SSD shapes of its phase 17 and the
sLSTM shapes of its phase 21, both outputs are held to the plain version
(Parzen within atol 2e-4 / rtol 1e-4; SSD within 2e-3 of the plain version
run in float64; sLSTM within a tenth of the float64 output's rms), and
both are timed in the same process two ways: ``ms``, CUDA events around
eager calls (what the main path pays, the host's work a call included),
the median of 5 rounds that alternate the two sides (the host's speed
drifts), and ``card_ms``, CUDA events around replays of a CUDA graph of
the calls (the card's time alone).  The Parzen components go to each side
as its own main path hands them: unpadded here, and padded to powers of
two on the other side where its ``tpe.py`` padded them (``--padded``).
``motpe`` runs phase 7's 512-trial MOTPE study on each side's
``repro_torch.core``, in the order other, this, this, other: trials/s of
each run, and the SHA-256 of its trials, which must agree.  ``xlstm``
serves and trains xlstm-1.3b (this checkout's model, random weights from a
seed) with each side's sLSTM kernel swapped in, the sides taking turns: a
prefill group of 8 x 2022 tokens, 64 decode steps after it a side, and a
training step of 8 x 2048 tokens, each synchronized.
Prints one line a shape or run; ``--out`` also writes them as JSON.
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
import repro_torch.core as hpo  # noqa: E402
from repro_torch.kernels import parzen, slstm, ssd  # noqa: E402
from repro_torch.kernels.ref import parzen_score_ref, slstm_scan_ref  # noqa: E402

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


#: (label, B, S, init, reps) at xlstm-1.3b's sLSTM (4 heads of 512), bf16 u, from phase 21
SLSTM_SHAPES = (("xlstm prefill / training", 8, 2048, False, 5),
                ("xlstm serve group", 8, 1895, False, 5),
                ("xlstm serve group", 8, 2022, False, 5),
                ("xlstm decode", 8, 1, True, 200))


def import_package(src: str, name: str):
    """``src``'s ``repro_torch`` as the package ``name``."""
    init = os.path.join(src, "repro_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


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


def slstm_rows(other) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for label, B, S, init, reps in SLSTM_SHAPES:
        args = cs.slstm_inputs(gen, B, S, 4, 512, torch.bfloat16, init, True)
        want, _ = slstm_scan_ref(*args, compute_dtype=torch.float64)
        rms = float(want.pow(2).mean().sqrt())
        fns = {"kernel": lambda: slstm.slstm_forward(*args),
               "other": lambda: other.slstm_forward(*args)}
        row = {"label": label, "B": B, "S": S, "init": init}
        errs = {}
        for side, fn in fns.items():
            errs[side] = float((fn()[0].double() - want).abs().max())
            assert errs[side] <= rms / 10, (label, side, errs[side], rms)
        row.update(timings(fns, reps, 20 if S == 1 else 1))
        for side, err in errs.items():
            row[side]["max_abs_err"] = err
        print(f"slstm {label:<24} B={B} S={S:<5}: kernel {row['kernel']['ms']:.4f} ms (card "
              f"{row['kernel']['card_ms']:.4f}; from float64 {errs['kernel']:.3e}), other "
              f"{row['other']['ms']:.4f} ms (card {row['other']['card_ms']:.4f})", flush=True)
        rows.append(row)
        del args, want
        torch.cuda.empty_cache()
    return rows


def motpe_runs(other_core) -> list[dict]:
    """Phase 7's MOTPE study on each side, other, this, this, other."""
    runs = []
    for side, core in (("other", other_core), ("kernel", hpo), ("kernel", hpo),
                       ("other", other_core)):
        _, study, seconds = cs.motpe_study(core, 512, 32)
        run = {"side": side, "seconds": seconds, "trials_per_s": 512 / seconds,
               "trials_sha256": cs.trials_hash(study)}
        print(f"motpe {side:<6}: 512 trials in {seconds:.3f} s = {run['trials_per_s']:.2f} "
              f"trials/s; trials sha256 {run['trials_sha256']}", flush=True)
        runs.append(run)
    hashes = {r["trials_sha256"] for r in runs}
    assert len(hashes) == 1, f"the studies made different trials: {hashes}"
    speed = {side: float(np.mean([r["trials_per_s"] for r in runs if r["side"] == side]))
             for side in ("kernel", "other")}
    print(f"motpe: the same trials on both sides; {speed['kernel']:.2f} against "
          f"{speed['other']:.2f} trials/s ({speed['kernel'] / speed['other']:.2f}x)")
    return runs


def xlstm_rows(other_slstm) -> dict:
    """xlstm-1.3b's prefill, decode and training step with each side's sLSTM
    wrapper swapped into this checkout's model (the mLSTM blocks and the
    rest are this checkout's on both sides).  The host's speed drifts over
    a run, so the sides take turns finely: prefills and training steps
    other, this, this, other; decode steps one each in turn, each side on
    its own cache, the order flipped every step."""
    import time

    from repro_torch import configs
    from repro_torch.models import init_model_params, ssm_xlstm
    from repro_torch.serve import make_decode_step
    from repro_torch.train import SyntheticLM, TrainConfig, make_train_step
    from repro_torch.train.train_loop import make_optimizer_for

    cfg = configs.get_config("xlstm-1.3b")
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.from_numpy(np.random.RandomState(22).randint(
        0, cfg.vocab, (8, 2022)).astype(np.int32)).cuda()
    batch = SyntheticLM(cfg, 8, 2048, device="cuda").batch_at(0)
    opt = make_optimizer_for(cfg, TrainConfig(lr=3e-4, warmup_steps=1, total_steps=8))
    step = make_train_step(cfg, opt)
    decode = make_decode_step(cfg)
    wrappers = {"kernel": slstm.slstm_forward, "other": other_slstm.slstm_forward}
    order = ("other", "kernel", "kernel", "other")

    def use(side):
        # the model reaches the wrapper through these two names: the
        # inference path and the Function's forward
        ssm_xlstm.slstm_forward = slstm.slstm_forward = wrappers[side]

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    times = {side: {"prefill_s": [], "decode_s": [], "train_step_s": []} for side in wrappers}
    state = {}
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        for side in wrappers:  # warm both: the process's first calls pay one-time costs
            use(side)
            with torch.no_grad():
                logits, cache = cs.prefill_last_logits(cfg, model, tokens, 4096, "cuda")
                decode(model, logits[:, 0].argmax(dim=-1)[:, None].to(torch.int32), cache, 2022)
            step(model, opt.init(dict(model.named_parameters())), 0, batch)
            model.load_state_dict(params)
            del logits, cache
            torch.cuda.empty_cache()
        with torch.no_grad():
            for side in order:
                use(side)
                dt, state[side] = synced(
                    lambda: cs.prefill_last_logits(cfg, model, tokens, 4096, "cuda"))
                times[side]["prefill_s"].append(dt)
            for i in range(64):
                for side in (order[:2] if i % 2 else order[2:]):
                    use(side)
                    logits, cache = state[side]
                    tok = logits[:, 0].argmax(dim=-1)[:, None].to(torch.int32)
                    dt, state[side] = synced(lambda: decode(model, tok, cache, 2022 + i))
                    times[side]["decode_s"].append(dt)
        del state
        torch.cuda.empty_cache()
        for side in order:
            use(side)
            opt_state = opt.init(dict(model.named_parameters()))
            times[side]["train_step_s"].append(synced(lambda: step(model, opt_state, 0, batch))[0])
            model.load_state_dict(params)
            del opt_state
            torch.cuda.empty_cache()
    finally:
        use("kernel")
    rows = {}
    for side, t in times.items():
        rows[side] = {**t, "prefill_s_median": float(np.median(t["prefill_s"])),
                      "decode_ms_median": 1e3 * float(np.median(t["decode_s"])),
                      "train_step_s_median": float(np.median(t["train_step_s"]))}
        print(f"xlstm {side:<6}: prefill 8 x 2022 " + " / ".join(f"{x:.4f}" for x in t["prefill_s"])
              + f" s; decode median {rows[side]['decode_ms_median']:.3f} ms a step over "
              f"{len(t['decode_s'])} steps; train step "
              + " / ".join(f"{x:.3f}" for x in t["train_step_s"]) + " s", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the other commit's src/repro_torch")
    ap.add_argument("--padded", action="store_true",
                    help="pad the other side's Parzen components to powers of two")
    ap.add_argument("--only", default="parzen,ssd,slstm,motpe,xlstm",
                    help="comma-separated sections to run (default all)")
    ap.add_argument("--out", help="also write the rows to this JSON file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_baseline: no CUDA device available", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi("name,power.limit")
    print(smi)
    import_package(os.path.join(opts.parent, "src"), "other_repro_torch")
    def kernels(name):
        return importlib.import_module(f"other_repro_torch.kernels.{name}")

    sections = {
        "parzen": lambda: parzen_rows(kernels("parzen"), opts.padded),
        "ssd": lambda: ssd_rows(kernels("ssd")),
        "slstm": lambda: slstm_rows(kernels("slstm")),
        "motpe": lambda: motpe_runs(importlib.import_module("other_repro_torch.core")),
        "xlstm": lambda: xlstm_rows(kernels("slstm")),
    }
    result = {"nvidia_smi": smi}
    for name in opts.only.split(","):
        result[name] = sections[name]()
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
