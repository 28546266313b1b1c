"""Small auxiliary pruners: threshold and patience wrappers.

Both judge only the target trial's own reported values (no peer scan), so
their ``decide`` implementations are trial-local — they still participate in
the fused ``report_and_prune`` round trip via ``spec()``, and
:class:`PatientPruner` forwards the store to whatever pruner it wraps.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

from ..frozen import FrozenTrial, StudyDirection
from .base import BasePruner

if TYPE_CHECKING:
    from ..records import IntermediateValueStore
    from ..study import Study

__all__ = ["ThresholdPruner", "PatientPruner"]


class ThresholdPruner(BasePruner):
    """Prune when an intermediate value leaves [lower, upper] (divergence
    guard: NaN/inf or loss explosion kills the trial immediately)."""

    def __init__(
        self,
        lower: float | None = None,
        upper: float | None = None,
        n_warmup_steps: int = 0,
    ):
        if lower is None and upper is None:
            raise ValueError("give at least one of lower/upper")
        self._lower = lower
        self._upper = upper
        self._warmup = n_warmup_steps

    def spec(self) -> "dict | None":
        if not self._fusable(ThresholdPruner):
            return None
        return {
            "name": "threshold",
            "lower": self._lower,
            "upper": self._upper,
            "n_warmup_steps": self._warmup,
        }

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        return self._evaluate(trial)

    def decide(self, direction, store, trial) -> bool:
        return self._evaluate(trial)

    def _evaluate(self, trial: FrozenTrial) -> bool:
        step = trial.last_step
        if step is None or step < self._warmup:
            return False
        v = trial.intermediate_values[step]
        if v != v or math.isinf(v):
            return True
        if self._lower is not None and v < self._lower:
            return True
        if self._upper is not None and v > self._upper:
            return True
        return False


class PatientPruner(BasePruner):
    """Wraps another pruner; only lets it fire after the trial has made no
    improvement for ``patience`` consecutive reports."""

    def __init__(self, wrapped: BasePruner | None, patience: int, min_delta: float = 0.0):
        if patience < 0 or min_delta < 0:
            raise ValueError("invalid patience/min_delta")
        self._wrapped = wrapped
        self._patience = patience
        self._min_delta = min_delta

    def spec(self) -> "dict | None":
        if not self._fusable(PatientPruner):
            return None
        wrapped_spec = self._wrapped.spec() if self._wrapped is not None else None
        if self._wrapped is not None and wrapped_spec is None:
            return None  # wrapped pruner cannot cross the wire -> no fusion
        return {
            "name": "patient",
            "patience": self._patience,
            "min_delta": self._min_delta,
            "wrapped": wrapped_spec,
        }

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        if not self._stalled(trial, study.direction):
            return False
        if self._wrapped is None:
            return True
        return self._wrapped.prune(study, trial)

    def decide(
        self, direction: StudyDirection, store: "IntermediateValueStore",
        trial: FrozenTrial,
    ) -> bool:
        if not self._stalled(trial, direction):
            return False
        if self._wrapped is None:
            return True
        return self._wrapped.decide(direction, store, trial)

    def _stalled(self, trial: FrozenTrial, direction: StudyDirection) -> bool:
        ivs = trial.intermediate_values
        if len(ivs) <= self._patience:
            return False
        steps = sorted(ivs)
        vals = [ivs[s] for s in steps]
        minimize = direction == StudyDirection.MINIMIZE
        window = vals[-(self._patience + 1):]
        if minimize:
            improved = min(window[1:]) < window[0] - self._min_delta
        else:
            improved = max(window[1:]) > window[0] + self._min_delta
        return not improved
