"""Immutable snapshots of trials: ``TrialState`` and ``FrozenTrial``."""

from __future__ import annotations

import copy
import datetime
import enum
from typing import Any

from .distributions import BaseDistribution

__all__ = ["TrialState", "FrozenTrial", "StudyDirection", "IV_VEC_PREFIX", "iv_vec_key"]

#: system-attr key prefix for per-objective intermediate-value vectors
#: (``iv_vec:<step>`` -> ``[v0, v1, ...]``).  Riding on system attrs means
#: every backend, both wire protocols, the op journal and replication carry
#: vector reports with zero schema changes — and scalar studies, which never
#: write the key, are byte-identical on the wire.
IV_VEC_PREFIX = "iv_vec:"


def iv_vec_key(step: int) -> str:
    return f"{IV_VEC_PREFIX}{int(step)}"


class TrialState(enum.IntEnum):
    RUNNING = 0
    COMPLETE = 1
    PRUNED = 2
    FAIL = 3
    WAITING = 4  # enqueued, not yet claimed by a worker

    def is_finished(self) -> bool:
        return self in (TrialState.COMPLETE, TrialState.PRUNED, TrialState.FAIL)


class StudyDirection(enum.IntEnum):
    MINIMIZE = 0
    MAXIMIZE = 1


class FrozenTrial:
    """An immutable record of a trial as persisted in storage.

    ``params`` holds external reprs; ``distributions`` the per-param domains.
    ``intermediate_values`` maps step -> reported value (paper Fig. 5's
    'report API' history that pruners consume).
    """

    def __init__(
        self,
        number: int,
        state: TrialState,
        value: float | None = None,
        values: list[float] | None = None,
        params: dict[str, Any] | None = None,
        distributions: dict[str, BaseDistribution] | None = None,
        intermediate_values: dict[int, float] | None = None,
        user_attrs: dict[str, Any] | None = None,
        system_attrs: dict[str, Any] | None = None,
        trial_id: int = -1,
        datetime_start: datetime.datetime | None = None,
        datetime_complete: datetime.datetime | None = None,
    ):
        if value is not None and values is not None:
            raise ValueError("specify only one of value / values")
        self.number = number
        self.state = state
        self.values = [value] if value is not None else (list(values) if values else None)
        self.params = dict(params or {})
        self.distributions = dict(distributions or {})
        self.intermediate_values = dict(intermediate_values or {})
        self.user_attrs = dict(user_attrs or {})
        self.system_attrs = dict(system_attrs or {})
        self._trial_id = trial_id
        self.datetime_start = datetime_start
        self.datetime_complete = datetime_complete

    # -- convenience ---------------------------------------------------------

    @property
    def value(self) -> float | None:
        if self.values is None:
            return None
        if len(self.values) != 1:
            raise RuntimeError("this trial is multi-objective; use .values")
        return self.values[0]

    @property
    def trial_id(self) -> int:
        return self._trial_id

    @property
    def intermediate_value_vectors(self) -> dict[int, list[float]]:
        """Per-objective intermediate vectors: step -> ``[v0, v1, ...]``,
        decoded from the ``iv_vec:<step>`` system attrs (empty on scalar
        studies).  The scalar ``intermediate_values`` entry at the same step
        holds the pruner-facing scalarization, not objective 0."""
        out: dict[int, list[float]] = {}
        for k, v in self.system_attrs.items():
            if isinstance(k, str) and k.startswith(IV_VEC_PREFIX):
                try:
                    out[int(k[len(IV_VEC_PREFIX):])] = list(v)
                except (TypeError, ValueError):
                    continue
        return out

    @property
    def last_step(self) -> int | None:
        if not self.intermediate_values:
            return None
        return max(self.intermediate_values)

    @property
    def duration(self) -> datetime.timedelta | None:
        if self.datetime_start is None or self.datetime_complete is None:
            return None
        return self.datetime_complete - self.datetime_start

    def copy(self) -> "FrozenTrial":
        """Structured copy on the suggest hot path: containers are fresh
        dicts/lists, leaf values are shared.  Params, objective values, and
        intermediate values are immutable scalars; distributions are never
        mutated after construction.  Only attr *values* (arbitrary JSON) are
        deep-copied, since callers may mutate those in place."""
        t = FrozenTrial.__new__(FrozenTrial)
        t.number = self.number
        t.state = self.state
        t.values = list(self.values) if self.values is not None else None
        t.params = dict(self.params)
        t.distributions = dict(self.distributions)
        t.intermediate_values = dict(self.intermediate_values)
        t.user_attrs = copy.deepcopy(self.user_attrs)
        t.system_attrs = copy.deepcopy(self.system_attrs)
        t._trial_id = self._trial_id
        t.datetime_start = self.datetime_start
        t.datetime_complete = self.datetime_complete
        return t

    def __repr__(self) -> str:
        return (
            f"FrozenTrial(number={self.number}, state={self.state.name}, "
            f"values={self.values}, params={self.params})"
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, FrozenTrial):
            return NotImplemented
        return self.__dict__ == other.__dict__
