#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA device (an H100 for the ``sm_90a`` kernels) and ``nvcc``; it
builds the kernels from ``src/repro_torch/kernels/csrc`` at first use.
Phases, each of which fails the run by raising:

1. device: the card's name and power limit, the kernels' build time;
2. every kernel against its plain PyTorch version on numpy-seeded inputs,
   with times from CUDA events;
3. the main path as a user calls it: ``create_study(engine="cuda",
   pruner=MedianPruner())`` and ``study.optimize(objective, n_trials=4096,
   ask_batch=32)`` with Optuna's default sampler settings.  With those
   defaults almost every trial is pruned and pruned trials stay out of the
   TPE history, so the phase prints the history sizes and the pruned share;
4. the same search run as a fleet of 32 workers would run it, with pruned
   trials kept in the history (``consider_pruned_trials=True``): each wave
   of 32 trials is asked, sampled and evaluated against one history
   version, then told together.  This is the traffic that builds the
   4096-point score table, the kernel's large shape.
   In phases 3 and 4 the kernels' launch counts are set to 0 just before
   the study and read just after, and held against the ``tpe.score``
   spans; each kernel is then timed at the shapes the study's final
   history gives it;
5. engine agreement: a seeded 14-trial study on ``engine="numpy"`` and on
   ``engine="cuda"`` picks the same parameters.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits with status 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: tolerance of the reference's own engine parity (tests/test_engine.py)
ATOL, RTOL = 2e-4, 1e-4
#: H100 SXM rates from NVIDIA's data sheet: HBM3 bytes/s and FP32 FLOP/s
#: outside the tensor cores; the exp rate is the special-function units'
#: 16 results per clock per SM (CUDA programming guide, compute 9.0)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
EXP_PER_CLOCK_PER_SM = 16
#: FP32 operations per (candidate, component) besides the exp
PARZEN_OPS_PER_PAIR = 8


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, from CUDA
    events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parzen_bound_ms(n_cands: int, n_l: int, n_g: int, sm_clock_hz: float) -> tuple[float, str]:
    """Least time the card could take for one Parzen score: the larger of
    the exps over the SFU rate, the other FP32 operations over the FP32
    peak, and the bytes (each input read once, the output written once)
    over the memory rate."""
    pairs = n_cands * (n_l + n_g)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    exp_s = pairs / (EXP_PER_CLOCK_PER_SM * sm * sm_clock_hz)
    ops_s = pairs * PARZEN_OPS_PER_PAIR / FP32_OPS_PER_S
    bytes_s = 4 * (2 * n_cands + 3 * (n_l + n_g)) / HBM_BYTES_PER_S
    bound = max(exp_s, ops_s, bytes_s)
    return bound * 1e3, ("bytes" if bound == bytes_s else "operations")


def synthetic_mixture(rng: np.random.RandomState, k: int, n_pad: int):
    """A realistic fitted mixture of ``k - n_pad`` components plus ``n_pad``
    inert padding components (``log_norm = -inf``)."""
    from repro_torch.core.samplers.tpe import _ParzenEstimator

    real = k - n_pad
    obs = rng.uniform(-3.0, 3.0, real - 1)
    est = _ParzenEstimator(obs, -3.0, 3.0, rng.uniform(0.5, 1.0, real - 1))
    mus = np.concatenate([est.mus, np.zeros(n_pad)])
    sigmas = np.concatenate([est.sigmas, np.ones(n_pad)])
    ln = np.concatenate([est._log_norm, np.full(n_pad, -np.inf)])
    return mus, sigmas, ln


def check_parzen(args, label: str, reps: int, sm_clock_hz: float) -> dict:
    from repro_torch.kernels.parzen import parzen_score
    from repro_torch.kernels.ref import parzen_score_ref

    out = parzen_score(*args)
    ref = parzen_score_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    err = float((out - ref).abs().max())
    n_cands, n_l, n_g = len(args[0]), len(args[1]), len(args[4])
    # the bound counts the components the data holds; padding (log_norm =
    # -inf) is work the kernel does but the function does not need
    real_l = int(torch.isfinite(args[3]).sum())
    real_g = int(torch.isfinite(args[6]).sum())
    ms = time_ms(lambda: parzen_score(*args), reps)
    plain_ms = time_ms(lambda: parzen_score_ref(*args), reps)
    bound_ms, bound_by = parzen_bound_ms(n_cands, real_l, real_g, sm_clock_hz)
    row = {
        "label": label, "C": n_cands, "Kl": n_l, "Kg": n_g,
        "Kl_real": real_l, "Kg_real": real_g, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(
        f"  parzen {label:<22} C={n_cands:<5} Kl={n_l:<5} ({real_l:<5} real) "
        f"Kg={n_g:<5} ({real_g:<5} real) max_abs_err={err:.3e} kernel={ms:.4f} ms "
        f"plain={plain_ms:.4f} ms bound={bound_ms:.6f} ms ({bound_by})"
    )
    return row


def phase_kernels(sm_clock_hz: float) -> list[dict]:
    """Phase 2: the Parzen kernel against its plain version."""
    print("phase 2: parzen_score kernel vs plain PyTorch version")
    rng = np.random.RandomState(0)
    rows = []
    for n_l, n_g in ((32, 4096), (26, 2023), (8, 8)):
        for padded in (False, True):
            l_side = synthetic_mixture(rng, n_l, n_l // 4 if padded else 0)
            g_side = synthetic_mixture(rng, n_g, n_g // 4 if padded else 0)
            for n_cands in (24, 4096, 1000):
                cands = rng.uniform(-3.5, 3.5, n_cands)
                args = [
                    torch.from_numpy(np.asarray(a, np.float32)).cuda()
                    for a in (cands, *l_side, *g_side)
                ]
                label = "-inf padded" if padded else "no padding"
                rows.append(check_parzen(args, label, 20, sm_clock_hz))
    return rows


def objective(trial) -> float:
    """Eight parameters of a typical model-tuning search space, four
    intermediate reports and a prune check per trial."""
    import repro_torch.core as hpo

    xs = [trial.suggest_float(f"x{i}", -5.0, 5.0) for i in range(4)]
    lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
    width = trial.suggest_int("width", 1, 128, log=True)
    depth = trial.suggest_int("depth", 1, 8)
    act = trial.suggest_categorical("activation", ["relu", "tanh", "gelu"])
    loss = sum((x - 1.0) ** 2 for x in xs)
    loss += (math.log10(lr) + 3.0) ** 2 + 0.1 * abs(math.log2(width) - 5.0)
    loss += 0.2 * abs(depth - 3) + 0.3 * (act != "relu")
    for step in range(4):
        trial.report(loss * (1.0 + 1.0 / (step + 1)), step)
        if trial.should_prune():
            raise hpo.TrialPruned()
    return loss


def run_wave(study, n: int) -> None:
    """One wave of a fleet of ``n`` workers: every trial samples against the
    same finished history, and the wave's results are told together.  (The
    score table of ``TPESampler`` is built on the second score of one
    parameter at one history version, so this is the pattern that reaches
    the kernel's large shape.)"""
    import repro_torch.core as hpo

    results = []
    for trial in study.ask(n):
        try:
            results.append((trial, objective(trial)))
        except hpo.TrialPruned:
            _, value = trial.last_reported
            results.append((trial, value, hpo.TrialState.PRUNED))
    study.tell_batch(results)


def final_estimators(study, param: str = "x0"):
    """The Parzen estimators of ``param`` at the study's final history, and
    the sizes of the history's below and above sets."""
    from repro_torch.core.samplers.tpe import _ParzenEstimator

    fit = study.sampler._trial_fit(study, None)
    _, below, above, w_below, w_above = fit.split(param)
    low, high = -5.0, 5.0
    l_est = _ParzenEstimator(below, low, high, w_below)
    g_est = _ParzenEstimator(above, low, high, w_above)
    return l_est, g_est, len(below), len(above)


def drive_main_path(label: str, study, run) -> dict:
    """Run ``run()`` (which drives ``study``) with every launch count set to
    0 just before and read just after, under telemetry; check its result
    and print where the time went."""
    from repro_torch.core import telemetry
    from repro_torch.core.samplers.tpe import _pad_est
    from repro_torch.kernels import parzen

    telemetry.reset()
    telemetry.enable()
    parzen.reset_launches()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = parzen.launches()
    telemetry.disable()
    hists = telemetry.snapshot()["histograms"]

    trials = study.trials
    n_trials = len(trials)
    n_score = hists["tpe.score"]["count"]
    assert launches > 0, f"{label}: the study never launched the Parzen kernel"
    assert launches == n_score, (label, launches, n_score)
    for t in trials:
        for name, v in t.params.items():
            if name != "activation":
                assert math.isfinite(v), (label, t.number, name, v)
    assert math.isfinite(study.best_value), (label, study.best_value)
    states = {}
    for t in trials:
        states[t.state.name] = states.get(t.state.name, 0) + 1
    pruned_share = states.get("PRUNED", 0) / n_trials
    l_est, g_est, n_below, n_above = final_estimators(study)
    kl, kg = len(_pad_est(l_est)[0]), len(_pad_est(g_est)[0])
    spans = {
        name: {"count": hists[name]["count"], "total_s": hists[name]["sum"],
               "mean_ms": 1e3 * hists[name]["mean"], "p99_ms": 1e3 * hists[name]["p99"]}
        for name in ("study.ask", "study.tell", "study.tell_batch", "tpe.fit",
                     "tpe.score", "storage.report_and_prune")
        if name in hists
    }
    result = {
        "label": label, "n_trials": n_trials, "seconds": seconds,
        "trials_per_s": n_trials / seconds, "parzen_launches": launches,
        "tpe_score_spans": n_score, "states": states, "pruned_share": pruned_share,
        "history_below": n_below, "history_above": n_above,
        "kernel_Kl": kl, "kernel_Kg": kg,
        "best_value": study.best_value, "spans": spans,
    }
    print(f"  {n_trials} trials in {seconds:.3f} s = {n_trials / seconds:.2f} trials/s; "
          f"states {states} (pruned share {pruned_share:.4f}); "
          f"best value {study.best_value:.6f}")
    print(f"  final TPE history of x0: {n_below} below + {n_above} above; "
          f"kernel components Kl={kl} Kg={kg} (pow2-padded)")
    print(f"  parzen_score launches {launches} == tpe.score spans {n_score}")
    for name, s in spans.items():
        print(f"  span {name:<26} count={s['count']:<7} total={s['total_s']:.4f} s "
              f"mean={s['mean_ms']:.4f} ms p99={s['p99_ms']:.4f} ms")
    return result


def kernel_at_history(study, tables: bool, sm_clock_hz: float) -> list[dict]:
    """The kernel at the shapes the study's final history gives it: direct
    scoring of the 24 EI candidates and, where the traffic builds it, the
    score table."""
    from repro_torch.core.samplers.tpe import _pad_est, _to_device
    from repro_torch.kernels import ops

    l_est, g_est, _, _ = final_estimators(study)
    rng = np.random.RandomState(1)
    runs = [(l_est.sample(rng, 24), "direct")]
    if tables:
        runs.append((np.linspace(-5.0, 5.0, ops.SCORE_TABLE_SIZE), "table"))
    rows = []
    for cands, label in runs:
        args = [_to_device(a, torch.device("cuda"))
                for a in (cands, *_pad_est(l_est), *_pad_est(g_est))]
        rows.append(check_parzen(args, label, 100, sm_clock_hz))
    return rows


def phase_optimize(sm_clock_hz: float) -> tuple[dict, list[dict]]:
    """Phase 3: the main path through ``Study.optimize`` with the defaults."""
    import repro_torch.core as hpo

    n_trials, ask_batch = 4096, 32
    print(f"phase 3: {n_trials}-trial study.optimize, engine='cuda', "
          f"MedianPruner, ask_batch={ask_batch}")
    study = hpo.create_study(engine="cuda", pruner=hpo.MedianPruner())
    study.sampler.reseed_rng(0)
    result = drive_main_path(
        "optimize", study,
        lambda: study.optimize(objective, n_trials=n_trials, ask_batch=ask_batch),
    )
    assert result["n_trials"] == n_trials, result["n_trials"]
    rows = kernel_at_history(study, False, sm_clock_hz)
    for r in rows:
        r["label"] = "optimize, " + r["label"]
    return result, rows


def phase_waves(sm_clock_hz: float) -> tuple[dict, list[dict]]:
    """Phase 4: the same search as waves of a 32-worker fleet."""
    import repro_torch.core as hpo

    n_trials, ask_batch = 4096, 32
    print(f"phase 4: {n_trials}-trial study in waves of {ask_batch}, engine='cuda', "
          f"MedianPruner, consider_pruned_trials=True")
    sampler = hpo.TPESampler(seed=0, engine="cuda", consider_pruned_trials=True)
    study = hpo.create_study(sampler=sampler, pruner=hpo.MedianPruner())

    def run():
        for _ in range(n_trials // ask_batch):
            run_wave(study, ask_batch)

    result = drive_main_path("waves", study, run)
    assert result["n_trials"] == n_trials, result["n_trials"]
    rows = kernel_at_history(study, True, sm_clock_hz)
    for r in rows:
        r["label"] = "waves, " + r["label"]
    return result, rows


def phase_agreement() -> None:
    """Phase 5: the reference's 14-trial engine-agreement study."""
    import repro_torch.core as hpo

    print("phase 5: 14-trial study, engine='numpy' vs engine='cuda'")
    params = {}
    for engine in ("numpy", "cuda"):
        s = hpo.create_study(sampler=hpo.TPESampler(seed=11, engine=engine))
        s.optimize(lambda t: t.suggest_float("x", -4, 4) ** 2, n_trials=14)
        params[engine] = np.array([t.params["x"] for t in s.trials])
    np.testing.assert_allclose(params["cuda"], params["numpy"], rtol=1e-5)
    err = float(np.max(np.abs(params["cuda"] - params["numpy"])))
    print(f"  params agree: max abs difference {err:.3e} (rtol 1e-5)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    # phase 1: device and build
    smi = nvidia_smi("name,power.limit")
    print(smi)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"max SM clock {sm_clock_hz / 1e6:.0f} MHz")
    _build.load()
    print(f"phase 1: kernels built and loaded in {_build.build_seconds():.2f} s")
    for line in _build.build_log().splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")

    kernel_rows = phase_kernels(sm_clock_hz)
    optimize, optimize_rows = phase_optimize(sm_clock_hz)
    waves, wave_rows = phase_waves(sm_clock_hz)
    phase_agreement()

    shape_rows = optimize_rows + wave_rows
    table = wave_rows[-1]  # the score-table build: the kernel's large shape
    kernels = [{
        "name": "parzen_score",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/parzen.cu",
        "replaces": "src/repro/kernels/parzen.py:34",
        "launches": optimize["parzen_launches"],
        "launches_waves": waves["parzen_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows + shape_rows),
        "ms": table["ms"],
        "plain_ms": table["plain_ms"],
        "bound_ms": table["bound_ms"],
        "bound_by": table["bound_by"],
        "library_ms": None,
        "shapes": shape_rows,
    }]
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"nvidia_smi": smi, "sm_clock_hz": sm_clock_hz,
                       "build_seconds": _build.build_seconds(),
                       "kernel_checks": kernel_rows, "optimize": optimize, "waves": waves,
                       "kernels": kernels}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
