"""Thread-safe in-process storage — the 'lightweight' backend.

This is the zero-setup default the paper calls out as essential for
notebook-scale use (§4): no DB, no files, instant.  Still fully thread-safe so
``study.optimize(n_jobs=k)`` works against it.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Iterable

from .. import telemetry as _telemetry
from ..distributions import BaseDistribution, check_distribution_compatibility
from ..exceptions import DuplicatedStudyError, StudyNotFoundError, TrialNotFoundError
from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import BaseStorage, StudySummary

__all__ = ["InMemoryStorage"]


class _StudyRecord:
    def __init__(self, study_id: int, name: str, directions: list[StudyDirection]):
        self.study_id = study_id
        self.name = name
        self.directions = directions
        self.user_attrs: dict[str, Any] = {}
        self.system_attrs: dict[str, Any] = {}
        self.trials: list[FrozenTrial] = []  # index == number
        self.revision = 0  # bumped on every trial mutation (get_trials_revision)
        # numbers of WAITING trials: Study.ask scans for claimable enqueued
        # trials on *every* ask, so the WAITING lookup must not degrade to a
        # full O(n_trials) state scan as the history grows
        self.waiting: set[int] = set()


class InMemoryStorage(BaseStorage):
    def __init__(self):
        self._lock = threading.RLock()
        self._studies: dict[int, _StudyRecord] = {}
        self._study_name_to_id: dict[str, int] = {}
        self._next_study_id = 0
        self._trial_index: dict[int, tuple[int, int]] = {}  # trial_id -> (study_id, number)
        self._next_trial_id = 0
        self._heartbeats: dict[int, float] = {}

    # -- study -----------------------------------------------------------------

    def create_new_study(self, directions: list[StudyDirection], study_name: str) -> int:
        with self._lock:
            if study_name in self._study_name_to_id:
                raise DuplicatedStudyError(study_name)
            sid = self._next_study_id
            self._next_study_id += 1
            self._studies[sid] = _StudyRecord(sid, study_name, list(directions))
            self._study_name_to_id[study_name] = sid
            return sid

    def delete_study(self, study_id: int) -> None:
        with self._lock:
            rec = self._get_study(study_id)
            del self._study_name_to_id[rec.name]
            del self._studies[study_id]
        self._drop_intermediate_store(study_id)
        self._drop_event_log(study_id)

    def get_study_id_from_name(self, study_name: str) -> int:
        with self._lock:
            if study_name not in self._study_name_to_id:
                raise StudyNotFoundError(study_name)
            return self._study_name_to_id[study_name]

    def get_study_name_from_id(self, study_id: int) -> str:
        with self._lock:
            return self._get_study(study_id).name

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        with self._lock:
            return list(self._get_study(study_id).directions)

    def get_all_studies(self) -> list[StudySummary]:
        with self._lock:
            return [
                StudySummary(
                    s.study_id, s.name, list(s.directions), len(s.trials),
                    dict(s.user_attrs), dict(s.system_attrs),
                )
                for s in self._studies.values()
            ]

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        with self._lock:
            self._get_study(study_id).user_attrs[key] = value

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        with self._lock:
            self._get_study(study_id).system_attrs[key] = value

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        with self._lock:
            return dict(self._get_study(study_id).user_attrs)

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        with self._lock:
            return dict(self._get_study(study_id).system_attrs)

    # -- trial -------------------------------------------------------------------

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        with self._lock:
            rec = self._get_study(study_id)
            tid = self._next_trial_id
            self._next_trial_id += 1
            number = len(rec.trials)
            if template_trial is None:
                t = FrozenTrial(
                    number=number,
                    state=TrialState.RUNNING,
                    trial_id=tid,
                    datetime_start=self._now(),
                )
            else:
                t = template_trial.copy()
                t.number = number
                t._trial_id = tid
                if t.datetime_start is None:
                    t.datetime_start = self._now()
            rec.trials.append(t)
            if t.state == TrialState.WAITING:
                rec.waiting.add(number)
            self._trial_index[tid] = (study_id, number)
            rec.revision += 1
        # outside the backend lock: the event log takes its own leaf lock
        self._record_event(study_id, _telemetry.EV_CREATED, number)
        return tid

    def _get_study(self, study_id: int) -> _StudyRecord:
        if study_id not in self._studies:
            raise StudyNotFoundError(study_id)
        return self._studies[study_id]

    def _get_trial_ref(self, trial_id: int) -> FrozenTrial:
        if trial_id not in self._trial_index:
            raise TrialNotFoundError(trial_id)
        sid, number = self._trial_index[trial_id]
        return self._studies[sid].trials[number]

    def _bump_revision(self, trial_id: int) -> None:
        sid, _ = self._trial_index[trial_id]
        rec = self._studies.get(sid)
        if rec is not None:
            rec.revision += 1

    def set_trial_param(
        self, trial_id: int, param_name: str, param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        with self._lock:
            t = self._get_trial_ref(trial_id)
            self._check_not_finished(t)
            if param_name in t.distributions:
                check_distribution_compatibility(t.distributions[param_name], distribution)
            t.params[param_name] = distribution.to_external_repr(param_value_internal)
            t.distributions[param_name] = distribution
            self._bump_revision(trial_id)

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Iterable[float] | None = None
    ) -> bool:
        with self._lock:
            t = self._get_trial_ref(trial_id)
            if state == TrialState.RUNNING and t.state != TrialState.WAITING:
                return False
            t.state = state
            if values is not None:
                t.values = [float(v) for v in values]
            if state == TrialState.RUNNING:
                t.datetime_start = self._now()
            if state.is_finished():
                t.datetime_complete = self._now()
                self._heartbeats.pop(trial_id, None)
            self._bump_revision(trial_id)
            sid, number = self._trial_index[trial_id]
            rec = self._studies.get(sid)
            if rec is not None:
                if state == TrialState.WAITING:
                    rec.waiting.add(number)
                else:
                    rec.waiting.discard(number)
        self._record_state_event(sid, state, number)
        return True

    def set_trial_intermediate_value(self, trial_id: int, step: int, intermediate_value: float) -> None:
        with self._lock:
            t = self._get_trial_ref(trial_id)
            self._check_not_finished(t)
            t.intermediate_values[int(step)] = float(intermediate_value)
            self._bump_revision(trial_id)
            sid, number = self._trial_index[trial_id]
        # outside the backend lock: hosted IV stores lock store-first
        self._note_iv_dirty(trial_id, sid)
        self._record_event(sid, _telemetry.EV_REPORTED, number, step=int(step))

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        with self._lock:
            t = self._get_trial_ref(trial_id)
            self._check_not_finished(t)
            t.user_attrs[key] = value
            self._bump_revision(trial_id)

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        with self._lock:
            t = self._get_trial_ref(trial_id)
            t.system_attrs[key] = value
            self._bump_revision(trial_id)

    def get_trial(self, trial_id: int) -> FrozenTrial:
        with self._lock:
            return self._get_trial_ref(trial_id).copy()

    def get_all_trials(
        self, study_id: int, deepcopy: bool = True,
        states: tuple[TrialState, ...] | None = None,
        since: int | None = None,
    ) -> list[FrozenTrial]:
        with self._lock:
            rec = self._get_study(study_id)
            trials = rec.trials
            if (
                since is None
                and states
                and all(s == TrialState.WAITING for s in states)
            ):
                # WAITING index: Study.ask issues this exact query per ask, so
                # it must stay O(n_waiting), not O(n_trials)
                trials = [trials[i] for i in sorted(rec.waiting)]
            else:
                if since is not None:
                    trials = trials[since:]  # numbers are dense list indices
                if states is not None:
                    trials = [t for t in trials if t.state in states]
            return [copy.deepcopy(t) for t in trials] if deepcopy else list(trials)

    def get_trials_revision(self, study_id: int) -> int:
        with self._lock:
            return self._get_study(study_id).revision

    @staticmethod
    def _check_not_finished(t: FrozenTrial) -> None:
        if t.state.is_finished():
            raise RuntimeError(f"trial {t.trial_id} is already finished ({t.state.name})")

    # -- heartbeat -----------------------------------------------------------------

    def record_heartbeat(self, trial_id: int) -> None:
        with self._lock:
            self._heartbeats[trial_id] = time.time()

    def get_stale_trial_ids(self, study_id: int, grace_seconds: float) -> list[int]:
        now = time.time()
        with self._lock:
            out = []
            for t in self._get_study(study_id).trials:
                if t.state != TrialState.RUNNING:
                    continue
                hb = self._heartbeats.get(t.trial_id)
                if hb is not None and now - hb > grace_seconds:
                    out.append(t.trial_id)
            return out
