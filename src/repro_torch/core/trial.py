"""The live ``Trial`` object — the paper's central abstraction.

An objective function receives a *living trial object* and constructs the
search space dynamically by calling the suggest API (paper §2, Fig. 1):

    def objective(trial):
        n_layers = trial.suggest_int("n_layers", 1, 4)
        for i in range(n_layers):
            ...

``FixedTrial`` replays a fixed parameter set through the same objective for
deployment (paper §2.2).
"""

from __future__ import annotations

import datetime
import math
from typing import TYPE_CHECKING, Any, Sequence

from .distributions import (
    BaseDistribution,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)
from .exceptions import TrialPruned
from .frozen import FrozenTrial, StudyDirection, TrialState, iv_vec_key

if TYPE_CHECKING:
    from .study import Study

__all__ = ["Trial", "FixedTrial"]


class BaseTrial:
    """Shared suggest API between live and fixed trials."""

    # subclasses implement _suggest(name, distribution) -> external value

    def suggest_float(
        self,
        name: str,
        low: float,
        high: float,
        *,
        log: bool = False,
        step: float | None = None,
    ) -> float:
        return self._suggest(name, FloatDistribution(low, high, log=log, step=step))

    def suggest_int(
        self, name: str, low: int, high: int, *, log: bool = False, step: int = 1
    ) -> int:
        return self._suggest(name, IntDistribution(low, high, log=log, step=step))

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        return self._suggest(name, CategoricalDistribution(choices))

    # legacy aliases (paper-era API)
    def suggest_uniform(self, name: str, low: float, high: float) -> float:
        return self.suggest_float(name, low, high)

    def suggest_loguniform(self, name: str, low: float, high: float) -> float:
        return self.suggest_float(name, low, high, log=True)

    def suggest_discrete_uniform(self, name: str, low: float, high: float, q: float) -> float:
        return self.suggest_float(name, low, high, step=q)

    def _suggest(self, name: str, distribution: BaseDistribution) -> Any:
        raise NotImplementedError

    def report(self, value: float, step: int) -> None:
        raise NotImplementedError

    def should_prune(self) -> bool:
        raise NotImplementedError


class Trial(BaseTrial):
    """A live trial bound to a study + storage.

    Every ``suggest_*`` call (1) checks whether this parameter was already
    suggested in this trial (idempotent re-suggest returns the same value),
    (2) otherwise asks the study's sampler for a value conditioned on trial
    history, and (3) persists (value, distribution) to storage so *other
    workers'* samplers see it immediately.
    """

    def __init__(self, study: "Study", trial_id: int):
        self.study = study
        self._trial_id = trial_id
        self._cached: FrozenTrial | None = None
        # relative (relational) sampling happens once, lazily, at first suggest
        self._relative_params: dict[str, Any] | None = None
        # joint block slice: {name: model-space value} presampled by a batched
        # ``Study.ask(n)`` (see Study._presample_joint); None on the scalar
        # path.  When set, suggest calls slice it instead of sampling, and
        # the per-trial relational stage is skipped (the block replaced it).
        self._joint: "dict[str, float] | None" = None
        self._joint_dists: "dict[str, BaseDistribution]" = {}
        # fused report→prune: decision for the last reported step, if any
        self._prune_decision: "tuple[int, bool] | None" = None
        self._last_report: "tuple[int, float] | None" = None

    # -- identity -------------------------------------------------------------

    @property
    def number(self) -> int:
        return self._frozen().number

    @property
    def params(self) -> dict[str, Any]:
        return dict(self._frozen(refresh=True).params)

    @property
    def distributions(self) -> dict[str, BaseDistribution]:
        return dict(self._frozen(refresh=True).distributions)

    @property
    def user_attrs(self) -> dict[str, Any]:
        return dict(self._frozen(refresh=True).user_attrs)

    @property
    def system_attrs(self) -> dict[str, Any]:
        return dict(self._frozen(refresh=True).system_attrs)

    @property
    def datetime_start(self) -> datetime.datetime | None:
        return self._frozen().datetime_start

    def _frozen(self, refresh: bool = False) -> FrozenTrial:
        if self._cached is None or refresh:
            self._cached = self.study._storage.get_trial(self._trial_id)
        return self._cached

    # -- suggest ---------------------------------------------------------------

    def _suggest(self, name: str, distribution: BaseDistribution) -> Any:
        storage = self.study._storage
        frozen = self._frozen(refresh=True)
        if name in frozen.distributions:
            # idempotent re-suggest within a trial
            from .distributions import check_distribution_compatibility

            check_distribution_compatibility(frozen.distributions[name], distribution)
            return frozen.params[name]

        if distribution.single():
            # domain of size one: no sampling needed
            internal = distribution.to_internal_repr(
                distribution.to_external_repr(
                    distribution.low if hasattr(distribution, "low") else 0.0
                )
            )
        else:
            internal = self._sample(name, distribution, frozen)

        storage.set_trial_param(self._trial_id, name, internal, distribution)
        self._cached = None
        return distribution.to_external_repr(internal)

    def _sample(self, name: str, distribution: BaseDistribution, frozen: FrozenTrial) -> float:
        sampler = self.study.sampler
        if self._relative_params is None and self._joint is None:
            # infer the concurrence relations once per trial (paper §3.1) and
            # run the relational sampler over them.  Joint-presampled trials
            # skip this stage entirely: the block already played the
            # relational role for the whole wave (re-running it would e.g.
            # claim a second grid cell).
            space = sampler.infer_relative_search_space(self.study, frozen)
            self._relative_params = sampler.sample_relative(self.study, frozen, space)
        if self._relative_params and name in self._relative_params:
            ext = self._relative_params[name]
            if distribution._contains(distribution.to_internal_repr(ext)):
                return distribution.to_internal_repr(ext)
        joint = self._joint_value(name, distribution)
        if joint is not None:
            return joint
        return distribution.to_internal_repr(
            sampler.sample_independent(self.study, frozen, name, distribution)
        )

    def _joint_value(self, name: str, distribution: BaseDistribution) -> "float | None":
        """Slice the presampled joint block for one suggest call.

        Returns the internal-repr value when the block covers ``name`` and
        the runtime distribution still matches the group prediction;
        otherwise None, falling back to scalar sampling.  Divergences
        (dynamic search-space branches, drifted bounds, changed types) are
        reported once per study — not per trial — via
        ``Study._note_joint_miss``."""
        if self._joint is None:
            return None
        model = self._joint.get(name)
        if model is None:
            # the group prediction never saw this parameter: a dynamic
            # define-by-run branch the history did not cover
            self.study._note_joint_miss(name, "not in any observed group")
            return None
        if math.isnan(model):
            return None  # sampler declined this column by design; silent
        predicted = self._joint_dists.get(name)
        if predicted is None or type(predicted) is not type(distribution) or (
            isinstance(distribution, CategoricalDistribution) and predicted != distribution
        ):
            self.study._note_joint_miss(name, "distribution type changed")
            return None
        if getattr(predicted, "log", False) != getattr(distribution, "log", False):
            # same type but a different coordinate system: the block value is
            # a log-space (resp. linear) number the runtime codec would
            # silently misread as linear (resp. log)
            self.study._note_joint_miss(name, "log flag changed")
            return None
        # containment must be checked in *model space* against the runtime
        # domain: from_internal clips into bounds, so a post-clip _contains
        # test could never detect a drifted domain
        low, high = distribution.internal_bounds(expand_int=True)
        if not (low <= model <= high):
            self.study._note_joint_miss(name, "bounds drifted past the block")
            return None
        return float(distribution.from_internal([model])[0])

    # -- pruning interface (paper Fig. 5) ---------------------------------------

    def report(self, value: "float | Sequence[float]", step: int) -> None:
        """Report an intermediate objective value at ``step`` ('report API').

        When the study's pruner ships a wire spec (every built-in does), the
        report rides the fused ``report_and_prune`` storage op: the value is
        persisted *and* the prune decision comes back on the same round trip
        — server-side peer data over ``remote://`` — so the following
        ``should_prune()`` answers from the cached decision with zero extra
        storage calls.

        On multi-objective studies ``value`` may be a **vector** (one entry
        per study direction).  A Pareto-aware pruner
        (``ParetoPruner``, multi-objective slice) scalarizes it client-side
        into a minimize-oriented loss, which then rides the *same* fused
        path — one round trip per report, identical wire format.  Vector
        reports without a scalarizing pruner raise (storing only one
        objective silently would corrupt pruning decisions)."""
        step = int(step)
        study = self.study
        directions = study.directions
        direction = directions[0] if len(directions) == 1 else StudyDirection.MINIMIZE
        scalarize = getattr(study.pruner, "scalarize", None)
        spec_probe = getattr(study.pruner, "spec", None)
        probe = spec_probe() if callable(spec_probe) else None
        vector: "list[float] | None" = None
        if isinstance(value, (list, tuple)) or (
            hasattr(value, "__len__") and not isinstance(value, str)
        ):
            vector = [float(v) for v in value]
            if len(directions) > 1 and len(vector) != len(directions):
                raise ValueError(
                    f"vector report has {len(vector)} entries for "
                    f"{len(directions)} study directions"
                )
            if callable(scalarize):
                value = float(scalarize(vector, directions))
            elif probe is not None and probe.get("name") in ("nop", "none"):
                # no pruning decisions to corrupt: keep objective 0 as the
                # scalar stream entry (per-objective curves land via the
                # iv_vec attr below)
                value = float(vector[0])
            else:
                raise ValueError(
                    "vector report needs a Pareto-aware pruner that can "
                    "scalarize it (e.g. ParetoPruner); got "
                    f"{type(study.pruner).__name__}"
                )
        elif len(directions) > 1 and callable(scalarize):
            # a raw scalar would enter the scalarized-loss stream unoriented
            # and unscaled — judged as MINIMIZE next to augmented-Chebyshev
            # losses, silently corrupting every peer's prune decision
            raise ValueError(
                f"multi-objective study with {type(study.pruner).__name__}: "
                f"report all {len(directions)} objectives as a vector, not a scalar"
            )
        else:
            value = float(value)
        spec = probe
        scalarizing = callable(scalarize)
        storage = study._storage
        fused = spec is not None and (len(directions) == 1 or scalarizing)
        # per-objective vectors persist as the iv_vec:<step> system attr,
        # ordered BEFORE the scalar write so the hosted IV store's re-encode
        # (triggered by the scalar) already sees it.  Keeping the 1-frame
        # report contract: a raw remote/sharded client folds both ops into
        # one call_batch frame; CachedStorage has no call_batch but buffers
        # the attr op and flushes it on the SAME frame as the fused report.
        attr_op = None
        if vector is not None and len(vector) > 1:
            attr_op = (self._trial_id, iv_vec_key(step), vector)
        batch = getattr(storage, "call_batch", None) if attr_op else None
        if fused and attr_op and callable(batch):
            results = batch([
                ("set_trial_system_attr", attr_op),
                ("report_and_prune",
                 (study._study_id, self._trial_id, step, value, spec, direction)),
            ])
            self._prune_decision = (step, bool(results[1]))
        else:
            if attr_op is not None:
                storage.set_trial_system_attr(*attr_op)
            # no span of its own: storage.report_and_prune / the client RPC
            # span directly below covers the whole storage round trip already
            if fused:
                decision = storage.report_and_prune(
                    study._study_id, self._trial_id, step, value, spec, direction
                )
                self._prune_decision = (step, bool(decision))
            else:
                storage.set_trial_intermediate_value(self._trial_id, step, value)
                self._prune_decision = None
        if self._last_report is None or step >= self._last_report[0]:
            self._last_report = (step, value)
        self._cached = None

    @property
    def last_reported(self) -> "tuple[int, float] | None":
        """(step, value) of this process's highest-step ``report`` so far —
        the same value ``FrozenTrial.last_step`` would select, so e.g. the
        tune scheduler can record a pruned trial's final value without a
        refetch even when steps were reported out of order."""
        return self._last_report

    def should_prune(self) -> bool:
        """Ask the study's pruner whether this trial should stop
        ('should_prune API').  Answers from the fused decision cached by the
        preceding ``report`` when available (no storage round trip);
        otherwise evaluates the pruner client-side."""
        if self._prune_decision is not None:
            return self._prune_decision[1]
        trial = self.study._storage.get_trial(self._trial_id)
        return self.study.pruner.prune(self.study, trial)

    def prune(self) -> None:
        """Convenience: raise :class:`TrialPruned`."""
        raise TrialPruned(f"trial {self.number} pruned")

    # -- attrs --------------------------------------------------------------------

    def set_user_attr(self, key: str, value: Any) -> None:
        self.study._storage.set_trial_user_attr(self._trial_id, key, value)
        self._cached = None

    def set_system_attr(self, key: str, value: Any) -> None:
        self.study._storage.set_trial_system_attr(self._trial_id, key, value)
        self._cached = None


class FixedTrial(BaseTrial):
    """Replays a fixed parameter set through an objective (paper §2.2).

    The suggest API returns the user-supplied values; unknown parameters raise.
    Use it to *deploy* the best configuration through the very same
    define-by-run objective used for search::

        best = study.best_trial
        objective(FixedTrial(best.params))
    """

    def __init__(self, params: dict[str, Any], number: int = 0):
        self._params = dict(params)
        self._suggested: dict[str, BaseDistribution] = {}
        self._user_attrs: dict[str, Any] = {}
        self._system_attrs: dict[str, Any] = {}
        self._intermediate: dict[int, float] = {}
        self.number = number

    @property
    def params(self) -> dict[str, Any]:
        return dict(self._params)

    @property
    def user_attrs(self) -> dict[str, Any]:
        return dict(self._user_attrs)

    def _suggest(self, name: str, distribution: BaseDistribution) -> Any:
        if name not in self._params:
            raise ValueError(f"FixedTrial has no value for parameter {name!r}")
        value = self._params[name]
        internal = distribution.to_internal_repr(value)
        if not distribution._contains(internal):
            raise ValueError(
                f"FixedTrial value {value!r} for {name!r} is outside {distribution!r}"
            )
        self._suggested[name] = distribution
        return distribution.to_external_repr(internal)

    def report(self, value: float, step: int) -> None:
        self._intermediate[int(step)] = float(value)

    def should_prune(self) -> bool:
        return False

    def set_user_attr(self, key: str, value: Any) -> None:
        self._user_attrs[key] = value

    def set_system_attr(self, key: str, value: Any) -> None:
        self._system_attrs[key] = value
