"""The port's distributed workers (``repro_torch.core.distributed``).

* The reference's own cases, each under its reference name: ``run_workers``
  over sqlite and journal files (``tests/test_study.py``), the
  ``RetryFailedTrialCallback``, and ``worker_main`` with batched asks
  (``tests/test_records.py``).
* The fork guard: in a process that has initialized CUDA (here
  ``torch.cuda.is_initialized`` patched to say so) ``run_workers`` refuses
  to fork, before it starts a server or a process; ``"spawn"`` is let
  through.
* Spawned workers: two ``spawn`` processes with the ``"torch"`` engine on
  the CPU share a served sqlite study, each trial recording its worker's
  pid.
"""

import multiprocessing
import os

import pytest
import torch

import repro_torch.core as hpo
from repro_torch.core import distributed
from repro_torch.core.frozen import TrialState


def _sphere(trial):
    return sum(trial.suggest_float(f"x{i}", -3, 3) ** 2 for i in range(3))


def _numpy_tpe():
    return hpo.TPESampler(engine="numpy")


def test_distributed_processes_sqlite(tmp_path):
    url = f"sqlite:///{tmp_path}/dist.db"
    hpo.create_study(study_name="dist", storage=url, engine="numpy")

    dur = hpo.run_workers(
        3, url, "dist", _sphere, n_trials_per_worker=8, sampler_factory=_numpy_tpe,
    )
    s = hpo.load_study("dist", url, engine="numpy")
    assert len(s.trials) == 24
    assert sorted(t.number for t in s.trials) == list(range(24))
    assert s.best_value < 10.0
    assert dur > 0


def test_distributed_processes_journal(tmp_path):
    url = f"journal://{tmp_path}/dist.journal"
    hpo.create_study(study_name="dist", storage=url, engine="numpy")
    hpo.run_workers(3, url, "dist", _sphere, n_trials_per_worker=6, sampler_factory=_numpy_tpe)
    s = hpo.load_study("dist", url, engine="numpy")
    assert len(s.trials) == 18
    assert sorted(t.number for t in s.trials) == list(range(18))


def test_retry_failed_trial_callback():
    s = hpo.create_study(engine="numpy")
    cb = hpo.RetryFailedTrialCallback(max_retry=1)

    calls = {"n": 0}

    def flaky(trial):
        trial.suggest_float("x", 0, 1)
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("node died")
        return 1.0

    s.optimize(flaky, n_trials=2, catch=(RuntimeError,), callbacks=[cb])
    states = [t.state for t in s.trials]
    assert TrialState.FAIL in states
    assert TrialState.COMPLETE in states
    retried = [t for t in s.trials if t.user_attrs.get("retry_of") is not None]
    assert retried, "failed trial must be re-enqueued"


class TestBatchedAskTell:
    def test_worker_main_ask_batch(self, tmp_path):
        url = f"sqlite:///{tmp_path}/s.db"
        hpo.create_study(study_name="batched", storage=url, engine="numpy")
        from repro_torch.core.distributed import worker_main

        worker_main(
            url, "batched", lambda t: t.suggest_float("x", 0, 1) ** 2,
            n_trials=6, sampler_factory=_numpy_tpe, seed_offset=0,
            heartbeat_interval=None, ask_batch=3,
        )
        study2 = hpo.load_study("batched", url, engine="numpy")
        done = [t for t in study2.trials if t.state == TrialState.COMPLETE]
        assert len(done) == 6


# -- the fork guard ------------------------------------------------------------


class _NoServer:
    def __init__(self, *args, **kwargs):
        raise AssertionError("run_workers started a server before refusing")


@pytest.mark.parametrize("start_method", ["fork", None])
def test_run_workers_refuses_fork_after_cuda(start_method, tmp_path, monkeypatch):
    if start_method is None and multiprocessing.get_start_method(allow_none=True) not in (
        None, "fork",
    ):
        pytest.skip("this interpreter's default start method is not fork")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "StorageServer", _NoServer)
    started = []
    monkeypatch.setattr(multiprocessing.process.BaseProcess, "start",
                        lambda self: started.append(self))
    url = f"sqlite:///{tmp_path}/fork.db"
    hpo.create_study(study_name="fork", storage=url, engine="numpy")
    with pytest.raises(ValueError, match="spawn"):
        hpo.run_workers(2, url, "fork", _sphere, n_trials_per_worker=1,
                        sampler_factory=_numpy_tpe, serve_storage=True,
                        start_method=start_method)
    assert started == []
    assert hpo.load_study("fork", url, engine="numpy").trials == []


def test_run_workers_lets_spawn_through_after_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    started = []
    monkeypatch.setattr(multiprocessing.process.BaseProcess, "start",
                        lambda self: started.append(self))
    monkeypatch.setattr(multiprocessing.process.BaseProcess, "join",
                        lambda self, timeout=None: None)
    url = f"sqlite:///{tmp_path}/spawn.db"
    hpo.create_study(study_name="spawn", storage=url, engine="numpy")
    hpo.run_workers(2, url, "spawn", _sphere, n_trials_per_worker=1,
                    sampler_factory=_numpy_tpe, start_method="spawn")
    assert len(started) == 2


# -- spawned workers -----------------------------------------------------------


def _pid_objective(trial):
    trial.set_user_attr("pid", os.getpid())
    x = trial.suggest_float("x", -3, 3)
    for step in range(2):
        trial.report(x * x + 1.0 / (step + 1), step)
        if trial.should_prune():
            raise hpo.TrialPruned()
    return x * x


def _torch_tpe_on_cpu():
    return hpo.TPESampler(engine="torch", device="cpu", n_startup_trials=4)


def test_spawned_workers_share_a_served_study(tmp_path):
    """Two spawned workers sample with the ``"torch"`` engine on the CPU
    over a served sqlite file (protocol v2, cached): every trial finishes,
    the numbers are dense and both workers ran trials."""
    url = f"sqlite:///{tmp_path}/spawn.db"
    hpo.create_study(study_name="spawned", storage=url, engine="numpy")
    hpo.run_workers(
        2, url, "spawned", _pid_objective, n_trials_per_worker=12,
        sampler_factory=_torch_tpe_on_cpu, pruner_factory=hpo.MedianPruner,
        serve_storage=True, start_method="spawn",
    )
    trials = hpo.load_study("spawned", url, engine="numpy").trials
    assert sorted(t.number for t in trials) == list(range(24))
    assert {t.state for t in trials} <= {TrialState.COMPLETE, TrialState.PRUNED}
    pids = {t.user_attrs["pid"] for t in trials}
    assert len(pids) == 2 and os.getpid() not in pids
