"""``repro_torch.core`` — the define-by-run study loop of the port.

The same API as ``repro.core`` for what this slice carries: live trials with
a suggest API, the TPE and random samplers, the pruners, and in-memory
storage.  The TPE sampler's device engine runs on the card by default::

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

from . import telemetry
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
    PatientPruner,
    PercentilePruner,
    SuccessiveHalvingPruner,
    ThresholdPruner,
    make_pruner,
)
from .records import ObservationStore
from .samplers import BaseSampler, RandomSampler, TPESampler
from .search_space import IntersectionSearchSpace, intersection_search_space
from .storage import BaseStorage, InMemoryStorage, get_storage
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
    "BaseSampler", "RandomSampler", "TPESampler",
    # pruners
    "BasePruner", "NopPruner", "SuccessiveHalvingPruner", "MedianPruner",
    "PercentilePruner", "HyperbandPruner", "ThresholdPruner", "PatientPruner",
    "make_pruner",
    # observability
    "telemetry",
    # storage
    "BaseStorage", "InMemoryStorage", "get_storage",
    # misc
    "TrialPruned", "DuplicatedStudyError", "StorageInternalError",
    "intersection_search_space", "IntersectionSearchSpace",
    "ObservationStore",
    "import_trials",
]
