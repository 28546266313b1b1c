"""Multi-process distributed optimization (paper §4, Fig. 7).

The paper's model: run the *same* worker script N times with the same storage
URL and study name.  ``run_workers`` is the programmatic equivalent (spawning
local processes); on a cluster you launch your own worker script once per
node — workers are stateless and elastic, so joining late or dying early never
corrupts the study.

A process that has initialized CUDA cannot be forked into workers that use
the card again, so ``run_workers`` refuses ``start_method="fork"`` in such a
process (use ``"spawn"``, with a module-level objective and factories).
"""

from __future__ import annotations

import multiprocessing as mp
import time
from typing import Callable

import torch

from .frozen import TrialState
from .pruners import BasePruner
from .samplers import BaseSampler
from .storage import StorageServer, get_storage
from .study import Study, load_study

__all__ = ["run_workers", "worker_main", "RetryFailedTrialCallback"]


def worker_main(
    storage_url: str,
    study_name: str,
    objective: Callable,
    n_trials: int,
    sampler_factory: Callable[[], BaseSampler] | None = None,
    pruner_factory: Callable[[], BasePruner] | None = None,
    seed_offset: int | None = None,
    heartbeat_interval: float | None = 2.0,
    timeout: float | None = None,
    use_cache: bool = True,
    ask_batch: int = 1,
) -> None:
    """Entry point executed inside each worker process.

    ``seed_offset`` reseeds the sampler deterministically per worker so
    exploration streams are distinct but reproducible (``None`` keeps the
    nondeterministic default).  ``use_cache`` wraps ``remote://`` storage in
    :class:`CachedStorage` so per-``ask`` reads stay incremental.
    ``ask_batch > 1`` claims that many trials per storage round trip
    (``Study.ask(n)``) — the remote-latency amortization knob.
    """
    storage = get_storage(
        storage_url, cache=use_cache and storage_url.startswith("remote://")
    )
    study = load_study(
        study_name,
        storage,
        sampler=sampler_factory() if sampler_factory else None,
        pruner=pruner_factory() if pruner_factory else None,
    )
    # different workers must explore differently
    study.sampler.reseed_rng(seed_offset)
    study.heartbeat_interval = heartbeat_interval
    study.optimize(
        objective, n_trials=n_trials, timeout=timeout, catch=(Exception,),
        ask_batch=ask_batch,
    )
    storage.close()


def run_workers(
    n_workers: int,
    storage_url: str,
    study_name: str,
    objective: Callable,
    n_trials_per_worker: int,
    sampler_factory: Callable[[], BaseSampler] | None = None,
    pruner_factory: Callable[[], BasePruner] | None = None,
    timeout: float | None = None,
    start_method: str = "fork",
    serve_storage: bool = False,
    serve_host: str = "127.0.0.1",
    use_cache: bool = True,
    ask_batch: int = 1,
    auth_token: str | None = None,
    reclaim_grace: float | None = None,
    reclaim_requeue: bool = False,
) -> float:
    """Launch ``n_workers`` processes optimizing the same study; returns the
    wall-clock duration.  Storage must be shareable across processes
    (``sqlite:///``, ``journal://``, or ``remote://``).

    With ``serve_storage=True`` the parent wraps ``storage_url`` in a
    :class:`StorageServer` and hands workers its ``remote://`` URL instead —
    the pattern for fleets without a shared filesystem: serve once (e.g. over
    a SQLite file local to the server host), point every node at the URL.
    ``auth_token`` arms the server's shared-secret handshake and embeds the
    token in the workers' URL; ``ask_batch`` makes each worker claim that
    many trials per round trip.

    ``reclaim_grace`` (with ``serve_storage=True``) arms the server-side
    sweeper: RUNNING trials whose worker stopped heartbeating for that many
    seconds are FAILed — or re-enqueued as WAITING with
    ``reclaim_requeue=True``, so a surviving worker's ``ask()`` re-runs them.

    Raises ``ValueError``, before any process or server starts, when the
    processes would be forked from a process that has initialized CUDA: a
    forked child cannot initialize CUDA again, so every device trial in it
    would FAIL (``worker_main`` catches trial errors).  Pass
    ``start_method="spawn"`` there.
    """
    ctx = mp.get_context(start_method)
    if ctx.get_start_method() == "fork" and torch.cuda.is_initialized():
        raise ValueError(
            "run_workers: this process has initialized CUDA, and a forked worker "
            "cannot use the card; pass start_method=\"spawn\" (with a module-level "
            "objective and sampler / pruner factories)"
        )
    server = None
    worker_url = storage_url
    if serve_storage:
        server = StorageServer(
            get_storage(storage_url), host=serve_host, auth_token=auth_token,
            reclaim_grace=reclaim_grace, reclaim_requeue=reclaim_requeue,
        ).start()
        worker_url = (
            f"remote://{auth_token}@{server.host}:{server.port}"
            if auth_token
            else server.url
        )
    procs = []
    t0 = time.time()
    try:
        for i in range(n_workers):
            p = ctx.Process(
                target=worker_main,
                args=(worker_url, study_name, objective, n_trials_per_worker),
                kwargs=dict(
                    sampler_factory=sampler_factory,
                    pruner_factory=pruner_factory,
                    seed_offset=i,
                    timeout=timeout,
                    use_cache=use_cache,
                    ask_batch=ask_batch,
                ),
            )
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
    finally:
        if server is not None:
            server.stop()
    return time.time() - t0


class RetryFailedTrialCallback:
    """Study callback: when a trial FAILs (e.g. node preempted), re-enqueue its
    parameters up to ``max_retry`` times.  Combined with heartbeat failover
    this gives at-least-once trial execution under node failures."""

    def __init__(self, max_retry: int = 1):
        self._max_retry = max_retry

    def __call__(self, study: Study, trial) -> None:
        if trial.state != TrialState.FAIL:
            return
        n_prev = int(trial.system_attrs.get("retry:count", 0))
        if n_prev >= self._max_retry:
            return
        study.enqueue_trial(dict(trial.params), user_attrs={"retry_of": trial.number})
        # mark the new enqueued trial's retry depth via study attr on the failed one
        study._storage.set_trial_system_attr(trial.trial_id, "retry:count", n_prev + 1)
