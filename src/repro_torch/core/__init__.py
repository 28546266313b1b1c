"""``repro_torch.core`` — the define-by-run study loop of the port.

The same API as ``repro.core`` for what the port carries: live trials with
a suggest API, the TPE (with MOTPE), NSGA-II, CMA-ES, GP, grid and random
samplers, the pruners (with the Pareto-aware wrapper), the multi-objective
engine (``moo``: dominance, fronts, exact and Monte-Carlo hypervolume), the
storage backends (in-memory, SQLite, journal file, cached, a ``remote://``
server / client pair and its sharded cluster) and distributed workers
(``run_workers``).  The device engines run on the card by default::

    import repro_torch.core as hpo

    def objective(trial):
        x = trial.suggest_float("x", -10, 10)
        return (x - 2) ** 2

    study = hpo.create_study()            # needs a CUDA device
    # hpo.create_study(device="cpu")      # plain PyTorch version on the host
    study.optimize(objective, n_trials=100)
    print(study.best_params)
"""

from __future__ import annotations

from . import moo
from . import telemetry
from .distributed import RetryFailedTrialCallback, run_workers, worker_main
from .distributions import (
    BaseDistribution,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)
from .exceptions import DuplicatedStudyError, StorageInternalError, TrialPruned
from .frozen import FrozenTrial, StudyDirection, TrialState
from .pruners import (
    BasePruner,
    HyperbandPruner,
    MedianPruner,
    NopPruner,
    ParetoPruner,
    PatientPruner,
    PercentilePruner,
    SuccessiveHalvingPruner,
    ThresholdPruner,
    make_pruner,
)
from .records import ObservationStore
from .samplers import (
    CMA,
    BaseSampler,
    CmaEsSampler,
    GPSampler,
    GridSampler,
    NSGAIISampler,
    RandomSampler,
    TPESampler,
    make_sampler,
)
from .search_space import IntersectionSearchSpace, intersection_search_space
from .storage import (
    BaseStorage,
    CachedStorage,
    InMemoryStorage,
    JournalStorage,
    RemoteStorage,
    SQLiteStorage,
    StorageServer,
    get_storage,
)
from .study import Study, create_study, delete_study, load_study
from .transfer import import_trials
from .trial import FixedTrial, Trial

__all__ = [
    # study / trial
    "Study", "create_study", "load_study", "delete_study",
    "Trial", "FixedTrial", "FrozenTrial", "TrialState", "StudyDirection",
    # distributions
    "BaseDistribution", "FloatDistribution", "IntDistribution", "CategoricalDistribution",
    # samplers
    "BaseSampler", "RandomSampler", "GridSampler", "TPESampler", "CmaEsSampler",
    "CMA", "GPSampler", "NSGAIISampler", "make_sampler",
    # pruners
    "BasePruner", "NopPruner", "SuccessiveHalvingPruner", "MedianPruner",
    "PercentilePruner", "HyperbandPruner", "ThresholdPruner", "PatientPruner",
    "ParetoPruner", "make_pruner",
    # multi-objective engine
    "moo",
    # observability
    "telemetry",
    # storage
    "BaseStorage", "InMemoryStorage", "SQLiteStorage", "JournalStorage",
    "RemoteStorage", "CachedStorage", "StorageServer", "get_storage",
    # distributed / misc
    "run_workers", "worker_main", "RetryFailedTrialCallback",
    "TrialPruned", "DuplicatedStudyError", "StorageInternalError",
    "intersection_search_space", "IntersectionSearchSpace",
    "ObservationStore",
    "import_trials",
]
