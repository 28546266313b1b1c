"""The port's trial-slice scheduler (``repro_torch.tune.TrialSliceScheduler``)
on the CPU, held to the reference.

* The reference's cases, on ``[torch.device("cpu")]`` slices: backfill
  after pruning across four slices (``tests/test_parallel.py::
  test_trial_slice_scheduler_backfills``), and backfill waves that release
  their surplus claims (``tests/test_joint_sampling.py::
  TestSchedulerBackfill``).  Tell order varies with the threads, so these
  assert counts and states, as the reference's do.
* One slice is sequential: the port's scheduler gives the reference's trials
  bit for bit on a seeded ``engine="numpy"`` study, with and without
  backfill waves.
* An objective that raises gives a FAIL trial and the slice goes on.
* Two CPU slices run 4 trials of a smoke-width ``make_lm_objective``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.core as hpo
from repro_torch.core.frozen import TrialState
from repro_torch.tune import LMTuneSpec, TrialSliceScheduler, make_lm_objective

CPU = torch.device("cpu")


def _reference():
    """``repro.core`` (the JAX package); the cross-package cases skip without jax."""
    pytest.importorskip("jax")
    import repro.core as ref

    return ref


def test_trial_slice_scheduler_backfills():
    slices = [[CPU] for _ in range(4)]
    study = hpo.create_study(sampler=hpo.RandomSampler(seed=0),
                             pruner=hpo.SuccessiveHalvingPruner(1, 2, 0))
    seen = []

    def run_trial(trial, devices):
        seen.append(devices)
        x = trial.suggest_float("x", 0, 1)
        for step in (1, 2, 4):
            time.sleep(0.02)  # simulated train epochs so slices overlap
            trial.report(x + step * 0.001, step)
            if trial.should_prune():
                raise hpo.TrialPruned()
        return x

    sched = TrialSliceScheduler(study, slices, run_trial)
    sched.run(n_trials=16)
    trials = study.trials
    assert len(trials) == 16
    done = [t for t in trials if t.state == TrialState.COMPLETE]
    pruned = [t for t in trials if t.state == TrialState.PRUNED]
    assert len(done) >= 1 and len(pruned) >= 1
    assert len(done) + len(pruned) == 16
    slices_used = {e[1] for e in sched.events}
    assert len(slices_used) >= 2, slices_used  # concurrent slices got work (backfill)
    assert all(d == [CPU] for d in seen)
    kinds = [e[0] for e in sched.events]
    assert kinds.count("start") == 16
    assert kinds.count("done") == len(done) and kinds.count("pruned") == len(pruned)
    for t in pruned:  # the highest reported step's value is the final value
        assert t.value == t.intermediate_values[max(t.intermediate_values)]


def test_backfill_batch_completes_all_trials():
    study = hpo.create_study(
        sampler=hpo.TPESampler(seed=0, n_startup_trials=4, multivariate=True, device="cpu")
    )

    def run_trial(trial, devices):
        return trial.suggest_float("x", 0, 1) + trial.suggest_float("y", 0, 1)

    sched = TrialSliceScheduler(study, meshes=[[CPU], [CPU]], run_trial=run_trial,
                                backfill_batch=3)
    sched.run(n_trials=11)
    done = [t for t in study.trials if t.state == TrialState.COMPLETE]
    assert len(done) == 11
    # surplus prefetched claims were released back to the queue, not leaked
    running = [t for t in study.trials if t.state == TrialState.RUNNING]
    assert not running


def _objective_of(pkg):
    def run_trial(trial, _slice):
        x = trial.suggest_float("x", -3, 3)
        lr = trial.suggest_float("lr", 1e-4, 1e-1, log=True)
        kind = trial.suggest_categorical("kind", ["a", "b"])
        value = (x - 1) ** 2 + 0.1 * abs(np.log10(lr) + 2) + (kind == "b") * 0.5
        for step in range(1, 5):
            trial.report(value + 1.0 / step, step)
            if trial.should_prune():
                raise pkg.TrialPruned()
        return value

    return run_trial


def _trials(study) -> list:
    return [(t.number, t.state.name, {k: float(v).hex() if isinstance(v, float) else v
                                       for k, v in t.params.items()},
             [float(v).hex() for v in (t.values or [])],
             sorted((s, float(v).hex()) for s, v in t.intermediate_values.items()))
            for t in study.trials]


@pytest.mark.parametrize("backfill_batch", [1, 4])
def test_one_slice_gives_the_reference_trials(backfill_batch):
    """One slice runs the trials in order: the same seeded study as the
    reference's scheduler, bit for bit."""
    ref = _reference()
    from repro.tune.scheduler import TrialSliceScheduler as RefScheduler

    studies = []
    for pkg, sched_cls, slices in ((hpo, TrialSliceScheduler, [[CPU]]),
                                   (ref, RefScheduler, [None])):
        study = pkg.create_study(
            sampler=pkg.TPESampler(seed=0, n_startup_trials=5, engine="numpy"),
            pruner=pkg.SuccessiveHalvingPruner(min_resource=1, reduction_factor=2),
        )
        sched = sched_cls(study, slices, _objective_of(pkg), backfill_batch=backfill_batch)
        sched.run(n_trials=24)
        studies.append((study, sched.events))
    (mine, my_events), (theirs, their_events) = studies
    assert _trials(mine) == _trials(theirs)
    assert my_events == their_events
    states = [t.state for t in mine.trials]
    assert states.count(TrialState.COMPLETE) + states.count(TrialState.PRUNED) == 24
    assert TrialState.COMPLETE in states and TrialState.PRUNED in states
    # a wave's surplus claims go back to the queue
    assert set(states[24:]) <= {TrialState.WAITING}
    assert TrialState.RUNNING not in states


def test_raising_objective_is_a_failed_trial():
    study = hpo.create_study(sampler=hpo.RandomSampler(seed=1))
    lock = threading.Lock()
    calls = []

    def run_trial(trial, devices):
        x = trial.suggest_float("x", 0, 1)
        with lock:
            calls.append(trial.number)
        if trial.number % 3 == 1:
            raise RuntimeError("a broken trial")
        return x

    sched = TrialSliceScheduler(study, [[CPU], [CPU]], run_trial)
    sched.run(n_trials=9)
    states = {t.number: t.state for t in study.trials}
    assert sorted(calls) == list(range(9))
    assert [n for n, s in states.items() if s == TrialState.FAIL] == [1, 4, 7]
    assert sum(s == TrialState.COMPLETE for s in states.values()) == 6
    assert sorted(e[2] for e in sched.events if e[0] == "failed") == [1, 4, 7]


def test_two_cpu_slices_run_lm_trials():
    """Four smoke-width LM trials on two CPU slices: each trains, reports and
    finishes; both slices take trials."""
    spec = LMTuneSpec(vocab=64, seq=16, batch=2, total_steps=6, eval_every=2,
                      max_layers=1, max_width=32, families=("dense", "mamba2"))
    study = hpo.create_study(
        sampler=hpo.TPESampler(seed=0, n_startup_trials=2, device="cpu"),
        pruner=hpo.SuccessiveHalvingPruner(min_resource=2, reduction_factor=2),
    )

    def run_trial(trial, devices):
        return make_lm_objective(spec, device=devices[0])(trial)

    sched = TrialSliceScheduler(study, [[CPU]] * 2, run_trial)
    sched.run(n_trials=4)
    states = [t.state for t in study.trials]
    assert len(states) == 4 and set(states) <= {TrialState.COMPLETE, TrialState.PRUNED}
    assert TrialState.COMPLETE in states
    assert all(t.intermediate_values for t in study.trials)
    assert {e[1] for e in sched.events} == {0, 1}
    assert np.isfinite(study.best_value)


@pytest.mark.parametrize("multivariate", [False, True], ids=["independent", "multivariate"])
def test_four_slices_share_one_tpe_sampler(multivariate):
    """Four slice threads ask one ``"torch"``-engine TPE sampler (its fit
    caches shared, as the reference's are) while their trials report and
    are pruned: every trial finishes, every parameter is in its domain."""
    study = hpo.create_study(
        sampler=hpo.TPESampler(seed=0, n_startup_trials=4, multivariate=multivariate,
                               consider_pruned_trials=True, engine="torch", device="cpu"),
        pruner=hpo.SuccessiveHalvingPruner(min_resource=1, reduction_factor=2),
    )

    def run_trial(trial, devices):
        x = trial.suggest_float("x", -2, 2)
        n = trial.suggest_int("n", 1, 8)
        kind = trial.suggest_categorical("kind", ["a", "b", "c"])
        value = x * x + 0.1 * n + (kind == "c")
        for step in range(1, 4):
            time.sleep(0.002)
            trial.report(value + 1.0 / step, step)
            if trial.should_prune():
                raise hpo.TrialPruned()
        return value

    sched = TrialSliceScheduler(study, [[CPU]] * 4, run_trial)
    sched.run(n_trials=48)
    trials = study.trials
    assert len(trials) == 48 and sorted(t.number for t in trials) == list(range(48))
    states = [t.state for t in trials]
    assert set(states) <= {TrialState.COMPLETE, TrialState.PRUNED}, states
    for t in trials:
        assert -2 <= t.params["x"] <= 2 and 1 <= t.params["n"] <= 8
        assert t.params["kind"] in ("a", "b", "c")
    assert {e[1] for e in sched.events} == {0, 1, 2, 3}
