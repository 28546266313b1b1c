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
   ``engine="cuda"`` picks the same parameters;
6. the Monte-Carlo hypervolume counting kernel against its plain PyTorch
   version, exactly (integer counts), at the reference's test shapes, NaN
   point rows, exact ties, one point, the estimator's 25 x 8192 x 5 and a
   4096 x 65536 x 8 shape that needs several staged point tiles;
7. the multi-objective main path: MOTPE (``TPESampler(multi_objective=True,
   engine="cuda")``) on 5-objective DTLZ2 with 14 variables, 512 trials as
   waves of 32 (half of a 1024-trial study, which ran 303 s on an H100).
   Both kernels' launch counts are set to 0 just before the study and read
   just after; the final split is held identical between the ``"cuda"``
   and ``"torch"`` engines on the card, and the counting kernel is checked
   at the below-set and front-0 shapes the final history gives it;
8. NSGA-II (``engine="cuda"``) on the same DTLZ2, 1024 trials as waves of
   24, and ``study.best_trials`` on the card against the pairwise loop.

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
#: DTLZ2 (Deb, Thiele, Laumanns, Zitzler 2005): objectives and distance
#: variables (the authors' k = 10), so 14 variables in [0, 1]
DTLZ2_M, DTLZ2_K = 5, 10
#: the hypervolume estimator's default sample count
MC_SAMPLES = 8192


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


# -- multi-objective slice ---------------------------------------------------------


def dtlz2(x: np.ndarray, m: int = DTLZ2_M) -> list[float]:
    """DTLZ2's objective vector of ``x`` in [0, 1]^(m - 1 + k)."""
    g = float(np.sum((x[m - 1:] - 0.5) ** 2))
    out = []
    for i in range(m):
        v = 1.0 + g
        for j in range(m - 1 - i):
            v *= math.cos(x[j] * math.pi / 2)
        if i > 0:
            v *= math.sin(x[m - 1 - i] * math.pi / 2)
        out.append(v)
    return out


def run_dtlz2_wave(study, n: int) -> None:
    """One wave of ``n`` DTLZ2 evaluations, asked together and told together."""
    results = []
    for trial in study.ask(n):
        x = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0)
                      for i in range(DTLZ2_M - 1 + DTLZ2_K)])
        results.append((trial, dtlz2(x)))
    study.tell_batch(results)


def mc_compares(pts: torch.Tensor, smp: torch.Tensor) -> int:
    """Compares this data needs: each sample scans the points in order up to
    its second dominator (all of them when it has fewer), m compares each."""
    n, m = pts.shape
    scanned = 0
    chunk = max(1, (1 << 27) // (n * m))
    for start in range(0, len(smp), chunk):
        dom = (pts[None] <= smp[start:start + chunk, None]).all(dim=2)
        reached = dom.cumsum(dim=1) >= 2
        first = reached.to(torch.int8).argmax(dim=1) + 1
        scanned += int(torch.where(reached.any(dim=1), first, n).sum())
    return scanned * m


def raw_mc_launch(pts: torch.Tensor, smp: torch.Tensor):
    """A call of the counting kernel alone, into a buffer allocated once
    (the counts pile up across calls, which the timing does not read): the
    wrapper's allocation and float32 cast left out."""
    from repro_torch.kernels import _build

    lib = _build.load()
    n, m = pts.shape
    counts = torch.zeros(n + 1, dtype=torch.int32, device=pts.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.mc_hv_counts_launch(pts.data_ptr(), n, smp.data_ptr(), len(smp), m,
                                      counts.data_ptr(), counts[n:].data_ptr(), stream)
        assert err == 0, err

    return launch


def check_mc(pts: torch.Tensor, smp: torch.Tensor, label: str, reps: int) -> dict:
    """The counting kernel against its plain version, exactly, with times
    from CUDA events and the bound from the real sizes."""
    from repro_torch.kernels.hypervolume import mc_hv_counts
    from repro_torch.kernels.ref import mc_hv_counts_ref

    excl, total = mc_hv_counts(pts, smp)
    excl_r, total_r = mc_hv_counts_ref(pts, smp)
    torch.cuda.synchronize()
    mismatches = int((excl != excl_r).sum()) + int(total != total_r)
    err = max(float((excl - excl_r).abs().max()) if len(excl) else 0.0,
              float((total - total_r).abs()))
    assert mismatches == 0, (label, mismatches, err)
    n, m = pts.shape
    s = len(smp)
    ms = time_ms(lambda: mc_hv_counts(pts, smp), reps)
    kernel_ms = time_ms(raw_mc_launch(pts, smp), reps)
    plain_ms = time_ms(lambda: mc_hv_counts_ref(pts, smp), max(3, reps // 10))
    compares = mc_compares(pts, smp)
    ops_s = compares / FP32_OPS_PER_S
    bytes_s = (4 * (n + s) * m + 4 * (n + 1)) / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    bound_by = "bytes" if bytes_s >= ops_s else "operations"
    row = {
        "label": label, "n": n, "s": s, "m": m, "mismatches": mismatches,
        "max_abs_err": err, "total": float(total), "compares": compares,
        "compares_all": s * n * m, "ms": ms, "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(f"  mc_hv {label:<22} n={n:<5} s={s:<6} m={m} mismatches={mismatches} "
          f"total={int(total):<6} wrapper={ms:.4f} ms (kernel alone {kernel_ms:.4f}) "
          f"plain={plain_ms:.4f} ms "
          f"bound={bound_ms:.6f} ms ({bound_by}; {compares} of {s * n * m} compares)")
    return row


def estimator_samples(pts: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """The estimator's own draw for ``pts``: uniform in ``[min(pts),
    reference]`` from a fresh ``RandomState(0)``, rounded once to float32."""
    rng = np.random.RandomState(0)
    smp = rng.uniform(pts.min(axis=0), reference, size=(MC_SAMPLES, pts.shape[1]))
    return smp.astype(np.float32)


def phase_mc_kernel() -> list[dict]:
    """Phase 6: the counting kernel against its plain version."""
    print("phase 6: mc_hv_counts kernel vs plain PyTorch version (exact)")
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    cases = []
    # the reference kernel's own test shapes (n, m, s)
    for n, m, s in ((8, 3, 256), (20, 4, 1000), (64, 6, 2048), (3, 2, 100)):
        cases.append((f"reference {n}x{m}x{s}", rng.uniform(0, 1, (n, m)),
                      rng.uniform(0, 1.1, (s, m)), 100))
    pts = rng.uniform(0, 1, (30, 5))
    pts[::7, 1] = np.nan
    pts[11] = np.nan
    cases.append(("NaN point rows", pts, rng.uniform(0, 1.1, (3000, 5)), 100))
    pts = rng.randint(0, 4, size=(40, 3)).astype(float)
    pts[7] = pts[3]
    smp = rng.randint(0, 5, size=(2000, 3)).astype(float)
    smp[:40] = pts
    cases.append(("exact ties", pts, smp, 100))
    pts = rng.uniform(0, 1, (1, 5))
    cases.append(("one point", pts, estimator_samples(pts, np.ones(5) * 1.1), 100))
    pts = rng.uniform(0, 1, (25, 5))
    cases.append(("estimator 25x8192x5", pts, estimator_samples(pts, np.ones(5) * 1.1), 100))
    cases.append(("large 4096x65536x8", rng.uniform(0, 1, (4096, 8)),
                  rng.uniform(0, 1.1, (65536, 8)), 10))
    rows = []
    for label, pts, smp, reps in cases:
        P = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
        S = torch.from_numpy(np.ascontiguousarray(smp, np.float32)).to(dev)
        rows.append(check_mc(P, S, label, reps))
    return rows


class StageTimer:
    """Wall seconds and calls of a few functions of the multi-objective
    engine, wrapped for one phase and put back after it."""

    def __init__(self, targets):
        self.targets = targets  # (owner, attribute name, label)
        self.seconds = {label: 0.0 for _, _, label in targets}
        self.calls = {label: 0 for _, _, label in targets}
        self._saved = []

    def __enter__(self):
        for owner, name, label in self.targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, label))
        return self

    def _wrap(self, fn, label):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[label] += time.perf_counter() - t0
                self.calls[label] += 1
        return timed

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def phase_motpe() -> tuple[dict, list[dict]]:
    """Phase 7: MOTPE on 5-objective DTLZ2 as waves of 32 on the card."""
    import repro_torch.core as hpo
    from repro_torch.core import moo, telemetry
    from repro_torch.core.samplers.tpe import _motpe_split
    from repro_torch.kernels import hypervolume, parzen

    n_trials, wave = 512, 32
    print(f"phase 7: MOTPE on DTLZ2 ({DTLZ2_M} objectives, {DTLZ2_M - 1 + DTLZ2_K} "
          f"variables), {n_trials} trials in waves of {wave}, engine='cuda'")
    sampler = hpo.TPESampler(seed=0, multi_objective=True, engine="cuda")
    study = hpo.create_study(directions=["minimize"] * DTLZ2_M, sampler=sampler)
    est = moo.HypervolumeEstimator
    stages = StageTimer([
        (est, "_mc_stats", "mc_call"), (est, "_counts", "mc_counts"),
        (moo, "solve_hssp", "hssp"), (moo, "nondomination_ranks", "ranks"),
    ])
    telemetry.reset()
    telemetry.enable()
    with stages:
        parzen.reset_launches()
        hypervolume.reset_launches()
        t0 = time.perf_counter()
        for _ in range(n_trials // wave):
            run_dtlz2_wave(study, wave)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        mc_launches = hypervolume.launches()
        parzen_launches = parzen.launches()
    telemetry.disable()
    hists = telemetry.snapshot()["histograms"]
    assert mc_launches > 0, "the MOTPE study never launched the counting kernel"
    assert parzen_launches > 0, "the MOTPE study never launched the Parzen kernel"
    assert parzen_launches == hists["tpe.score"]["count"], (parzen_launches, hists["tpe.score"])
    assert stages.calls["mc_counts"] == mc_launches, (stages.calls, mc_launches)

    trials = study.trials
    assert len(trials) == n_trials
    V = np.array([t.values for t in trials])
    assert V.shape == (n_trials, DTLZ2_M) and np.isfinite(V).all()
    for t in trials:
        assert all(0.0 <= v <= 1.0 for v in t.params.values()), t.params
    L = moo.loss_matrix(V, study.directions)
    front0 = moo.pareto_front_mask(L, engine="cuda")
    assert np.array_equal(front0, moo.pareto_front_mask(L, engine="numpy"))
    n_below = sampler._gamma(len(L))
    split = {eng: _motpe_split(L, n_below, engine=eng, device="cuda")
             for eng in ("cuda", "torch")}
    (b_c, a_c, w_c), (b_t, a_t, w_t) = split["cuda"], split["torch"]
    assert np.array_equal(b_c, b_t) and np.array_equal(a_c, a_t), "final split differs"
    np.testing.assert_allclose(w_c, w_t, atol=1e-12, rtol=0)
    # DTLZ2's Pareto-optimal front is the unit sphere: every objective vector
    # has norm 1 + g >= 1, so the smallest norm on front 0 says how close the
    # search came
    g_min = float(np.min(np.linalg.norm(L[front0], axis=1)))
    assert g_min >= 1.0 - 1e-9, g_min

    spans = {
        name: {"count": hists[name]["count"], "total_s": hists[name]["sum"],
               "mean_ms": 1e3 * hists[name]["mean"], "p99_ms": 1e3 * hists[name]["p99"]}
        for name in ("study.ask", "study.tell_batch", "tpe.fit", "tpe.score")
        if name in hists
    }
    breakdown = {
        "mc_calls": stages.calls["mc_call"],
        "mc_call_s": stages.seconds["mc_call"],
        "mc_host_draw_s": stages.seconds["mc_call"] - stages.seconds["mc_counts"],
        "mc_counts_s": stages.seconds["mc_counts"],
        "hssp_s": stages.seconds["hssp"],
        "hssp_calls": stages.calls["hssp"],
        "ranks_s": stages.seconds["ranks"],
        "tpe_fit_s": spans.get("tpe.fit", {}).get("total_s", 0.0),
        "tpe_score_s": spans.get("tpe.score", {}).get("total_s", 0.0),
    }
    result = {
        "n_trials": n_trials, "wave": wave, "seconds": seconds,
        "trials_per_s": n_trials / seconds, "mc_hv_launches": mc_launches,
        "parzen_launches": parzen_launches, "front0": int(front0.sum()),
        "n_below": int(len(b_c)), "min_front_norm": g_min,
        "spans": spans, "breakdown": breakdown,
    }
    print(f"  {n_trials} trials in {seconds:.3f} s = {n_trials / seconds:.2f} trials/s; "
          f"front 0 holds {int(front0.sum())} trials (closest to the unit sphere: "
          f"norm {g_min:.4f}); below set {len(b_c)}")
    print(f"  launches: mc_hv_counts {mc_launches}, parzen_score {parzen_launches} "
          f"(== tpe.score spans)")
    print(f"  final split identical on 'cuda' and 'torch' (max |dw| "
          f"{float(np.max(np.abs(w_c - w_t))):.3e})")
    for name, sp in spans.items():
        print(f"  span {name:<26} count={sp['count']:<7} total={sp['total_s']:.4f} s "
              f"mean={sp['mean_ms']:.4f} ms p99={sp['p99_ms']:.4f} ms")
    print("  where the time goes: " + ", ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in breakdown.items()))

    rows = []
    dev = torch.device("cuda")
    for label, pts in (("MOTPE below set", L[b_c]), ("MOTPE front 0", L[front0])):
        ref = moo.default_reference_point(pts)
        P = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
        S = torch.from_numpy(estimator_samples(pts, ref)).to(dev)
        rows.append(check_mc(P, S, label, 100))
    return result, rows


def phase_nsga2() -> dict:
    """Phase 8: NSGA-II on the same DTLZ2, then the front on the card."""
    import repro_torch.core as hpo
    from repro_torch.core.study import _pairwise_best_trials

    n_trials = 1024
    sampler = hpo.NSGAIISampler(seed=0, engine="cuda")
    study = hpo.create_study(directions=["minimize"] * DTLZ2_M, sampler=sampler, engine="cuda")
    wave = sampler.joint_wave_size(study, 1 << 30)
    print(f"phase 8: NSGA-II on DTLZ2, {n_trials} trials in waves of {wave}, engine='cuda'")
    t0 = time.perf_counter()
    while len(study.trials) < n_trials:
        run_dtlz2_wave(study, min(wave, n_trials - len(study.trials)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t1 = time.perf_counter()
    best = study.best_trials
    best_s = time.perf_counter() - t1
    completed = study.get_trials(deepcopy=False, states=(hpo.TrialState.COMPLETE,))
    pairwise = _pairwise_best_trials(completed, study.directions)
    assert [t.number for t in best] == [t.number for t in pairwise], "best_trials differs"
    assert [t.values for t in best] == [t.values for t in pairwise]
    assert len(study.trials) == n_trials and len(best) > 0
    print(f"  {n_trials} trials in {seconds:.3f} s = {n_trials / seconds:.2f} trials/s; "
          f"best_trials on the card: {len(best)} trials in {1e3 * best_s:.3f} ms "
          f"== the pairwise loop")
    return {"n_trials": n_trials, "wave": wave, "seconds": seconds,
            "trials_per_s": n_trials / seconds, "front0": len(best),
            "best_trials_ms": 1e3 * best_s}


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
    mc_rows = phase_mc_kernel()
    motpe, motpe_rows = phase_motpe()
    nsga2 = phase_nsga2()

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
    # the main path's own shape: the below set's contributions (25 x 8192 x 5)
    mc_main = motpe_rows[0]
    kernels.append({
        "name": "mc_hv_counts",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hypervolume.cu",
        "replaces": "src/repro/kernels/hypervolume.py:38",
        "launches": motpe["mc_hv_launches"],
        "mismatches": sum(r["mismatches"] for r in mc_rows + motpe_rows),
        "max_abs_err": max(r["max_abs_err"] for r in mc_rows + motpe_rows),
        "ms": mc_main["ms"],
        "plain_ms": mc_main["plain_ms"],
        "bound_ms": mc_main["bound_ms"],
        "bound_by": mc_main["bound_by"],
        "library_ms": None,
        "shapes": mc_rows + motpe_rows,
    })
    kernels[0]["launches_motpe"] = motpe["parzen_launches"]
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"nvidia_smi": smi, "sm_clock_hz": sm_clock_hz,
                       "build_seconds": _build.build_seconds(),
                       "kernel_checks": kernel_rows, "optimize": optimize, "waves": waves,
                       "motpe": motpe, "nsga2": nsga2, "kernels": kernels}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
