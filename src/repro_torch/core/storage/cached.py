"""``CachedStorage`` — client-side write-behind cache proxy.

``get_all_trials`` is the per-``ask`` bottleneck: every sampler reads the
whole study before suggesting, so a naive remote backend re-ships N trials
over the wire N times (O(N^2) total).  This proxy (modeled on Optuna's
``_CachedStorage``) makes the read incremental and the hot writes local:

* **Finished trials are immutable** (BaseStorage contract) — once seen, they
  are cached forever and never re-fetched.  A per-study *watermark* tracks
  the smallest trial number not yet known-finished; each ``get_all_trials``
  fetches only ``number >= watermark`` from the backend (the ``since=`` hook,
  with a full-read fallback for backends that lack it).
* **Own running trials are tracked locally** — trials this process created or
  claimed keep an up-to-date local copy, so suggest-time reads never touch
  the backend.  Param/attr writes are buffered (write-behind) and flushed in
  one batched RPC before any write that must be globally visible
  (``report`` values for cross-worker pruning, state transitions).
* **Everything else forwards** — claims (``set_trial_state_values``) always
  execute on the backend, so the WAITING->RUNNING compare-and-set stays
  atomic study-wide.

Invalidation rules are documented in DESIGN.md.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Iterable

from .. import telemetry
from ..distributions import BaseDistribution, check_distribution_compatibility
from ..exceptions import RetryableStorageError
from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import BaseStorage, StudySummary, get_trials_since

__all__ = ["CachedStorage"]

# failures that mean "the backend is unreachable right now", after which the
# write-behind buffer must survive intact for a later re-flush
_TRANSIENT = (RetryableStorageError, ConnectionError, TimeoutError, OSError)


class _StudyCache:
    def __init__(self) -> None:
        self.trials: dict[int, FrozenTrial] = {}  # by number
        self.watermark = 0  # every number < watermark is finished and cached
        self.revision: int | None = None  # backend revision at last fetch


class CachedStorage(BaseStorage):
    """Wrap any :class:`BaseStorage` backend with an incremental read cache
    and write-behind buffering for trials owned by this process."""

    def __init__(self, backend: BaseStorage):
        if isinstance(backend, CachedStorage):
            raise ValueError("do not nest CachedStorage proxies")
        self._backend = backend
        self._lock = threading.RLock()
        self._studies: dict[int, _StudyCache] = {}
        self._index: dict[int, tuple[int, int]] = {}  # trial_id -> (study_id, number)
        self._own: dict[int, FrozenTrial] = {}  # trial_id -> local copy (RUNNING, ours)
        self._pending: dict[int, list[tuple[str, tuple]]] = {}  # trial_id -> buffered ops
        self._revision_supported = True  # until the backend says otherwise

    @property
    def backend(self) -> BaseStorage:
        return self._backend

    # -- study (forwarded; studies are cheap metadata) --------------------------

    def create_new_study(self, directions: list[StudyDirection], study_name: str) -> int:
        sid = self._backend.create_new_study(directions, study_name)
        with self._lock:
            self._studies[sid] = _StudyCache()
        return sid

    def delete_study(self, study_id: int) -> None:
        self._backend.delete_study(study_id)
        with self._lock:
            self._studies.pop(study_id, None)
            dead = [tid for tid, (sid, _) in self._index.items() if sid == study_id]
            for tid in dead:
                del self._index[tid]
                self._own.pop(tid, None)
                self._pending.pop(tid, None)

    def get_study_id_from_name(self, study_name: str) -> int:
        return self._backend.get_study_id_from_name(study_name)

    def get_study_name_from_id(self, study_id: int) -> str:
        return self._backend.get_study_name_from_id(study_id)

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        return self._backend.get_study_directions(study_id)

    def get_all_studies(self) -> list[StudySummary]:
        return self._backend.get_all_studies()

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        self._backend.set_study_user_attr(study_id, key, value)

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        self._backend.set_study_system_attr(study_id, key, value)

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        return self._backend.get_study_user_attrs(study_id)

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        return self._backend.get_study_system_attrs(study_id)

    # -- trial ------------------------------------------------------------------

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        tid = self._backend.create_new_trial(study_id, template_trial)
        t = self._backend.get_trial(tid)
        with self._lock:
            self._adopt_created_locked(study_id, t)
        return tid

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        """Batched creation: ids in one round trip, trial rows in a second
        (when the backend supports request batching)."""
        if n <= 0:
            return []
        tids = self._backend.create_new_trials(study_id, n, template_trial)
        call_batch = getattr(self._backend, "call_batch", None)
        if call_batch is not None and len(tids) > 1:
            trials = call_batch([("get_trial", (tid,)) for tid in tids])
        else:
            trials = [self._backend.get_trial(tid) for tid in tids]
        with self._lock:
            for t in trials:
                self._adopt_created_locked(study_id, t)
        return tids

    def _adopt_created_locked(self, study_id: int, t: FrozenTrial) -> None:
        cache = self._studies.setdefault(study_id, _StudyCache())
        self._index[t.trial_id] = (study_id, t.number)
        cache.trials[t.number] = t
        # WAITING (enqueued) trials belong to whoever claims them, not us
        if t.state == TrialState.RUNNING:
            self._own[t.trial_id] = t

    def set_trial_param(
        self, trial_id: int, param_name: str, param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        with self._lock:
            t = self._own.get(trial_id)
            if t is not None:
                if param_name in t.distributions:
                    check_distribution_compatibility(t.distributions[param_name], distribution)
                t.params[param_name] = distribution.to_external_repr(param_value_internal)
                t.distributions[param_name] = distribution
                self._pending.setdefault(trial_id, []).append(
                    ("set_trial_param",
                     (trial_id, param_name, float(param_value_internal), distribution))
                )
                return
        self._backend.set_trial_param(trial_id, param_name, param_value_internal, distribution)

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Iterable[float] | None = None
    ) -> bool:
        values = [float(v) for v in values] if values is not None else None
        with self._lock:
            own = trial_id in self._own
            if own:
                self._flush_trial_locked(trial_id)
            ok = self._backend.set_trial_state_values(trial_id, state, values)
            if not ok:
                return False
            if own and (state.is_finished() or state == TrialState.WAITING):
                # hand the record back to the backend as the source of truth:
                # finished rows are refetched authoritative (incl.
                # datetime_complete); WAITING means we released a batch-asked
                # trial for anyone to claim, so it is no longer ours either
                self._own.pop(trial_id)
                sid, number = self._index[trial_id]
                self._studies.setdefault(sid, _StudyCache()).trials.pop(number, None)
            elif own:
                t = self._own[trial_id]
                t.state = state
                if values is not None:
                    t.values = values
            elif state == TrialState.RUNNING and trial_id in self._index:
                # we just won the claim on an enqueued trial -> adopt it
                sid, number = self._index[trial_id]
                t = self._backend.get_trial(trial_id)
                self._own[trial_id] = t
                self._studies.setdefault(sid, _StudyCache()).trials[number] = t
            return True

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        with self._lock:
            t = self._own.get(trial_id)
            if t is not None:
                if t.state.is_finished():
                    raise RuntimeError(f"trial {trial_id} is already finished")
                t.intermediate_values[int(step)] = float(intermediate_value)
                # reported values feed cross-worker pruners -> must be visible
                self._pending.setdefault(trial_id, []).append(
                    ("set_trial_intermediate_value",
                     (trial_id, int(step), float(intermediate_value)))
                )
                self._flush_trial_locked(trial_id)
                return
        self._backend.set_trial_intermediate_value(trial_id, step, intermediate_value)

    def report_and_prune(
        self, study_id: int, trial_id: int, step: int, value: float,
        pruner_spec: dict, direction,
    ) -> bool:
        """Fused report→prune through the cache: the local copy of an owned
        trial is updated write-through, then any buffered write-behind ops
        ride the *same* batched frame as the fused op — the whole
        report+should_prune round still costs one backend round trip."""
        step, value = int(step), float(value)
        fused = ("report_and_prune", (study_id, trial_id, step, value, pruner_spec, direction))
        with self._lock:
            t = self._own.get(trial_id)
            if t is not None:
                if t.state.is_finished():
                    raise RuntimeError(f"trial {trial_id} is already finished")
                t.intermediate_values[step] = value
                # buffered ops stay queued until the backend confirms (an
                # outage mid-report must not drop the write-behind buffer)
                ops = self._pending.get(trial_id) or []
                call_batch = getattr(self._backend, "call_batch", None)
                try:
                    if call_batch is not None and ops:
                        pruned = bool(call_batch(ops + [fused])[-1])
                    else:
                        for method, params in ops:
                            getattr(self._backend, method)(*params)
                        pruned = bool(self._backend.report_and_prune(*fused[1]))
                except _TRANSIENT:
                    telemetry.inc("cached.flush.failures")
                    raise
                self._pending.pop(trial_id, None)
                return pruned
        return bool(self._backend.report_and_prune(*fused[1]))

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        with self._lock:
            t = self._own.get(trial_id)
            if t is not None:
                t.user_attrs[key] = value
                self._pending.setdefault(trial_id, []).append(
                    ("set_trial_user_attr", (trial_id, key, value))
                )
                return
        self._backend.set_trial_user_attr(trial_id, key, value)

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        with self._lock:
            t = self._own.get(trial_id)
            if t is not None:
                t.system_attrs[key] = value
                self._pending.setdefault(trial_id, []).append(
                    ("set_trial_system_attr", (trial_id, key, value))
                )
                return
        self._backend.set_trial_system_attr(trial_id, key, value)

    def get_trial(self, trial_id: int) -> FrozenTrial:
        with self._lock:
            t = self._own.get(trial_id)
            if t is not None:
                telemetry.inc("cached.get_trial.hit_own")
                return copy.deepcopy(t)
            loc = self._index.get(trial_id)
            if loc is not None:
                sid, number = loc
                cache = self._studies.get(sid)
                if cache is not None and number < cache.watermark:
                    telemetry.inc("cached.get_trial.hit_finished")
                    return copy.deepcopy(cache.trials[number])  # finished, immutable
        telemetry.inc("cached.get_trial.miss")
        return self._backend.get_trial(trial_id)

    def get_all_trials(
        self, study_id: int, deepcopy: bool = True,
        states: tuple[TrialState, ...] | None = None,
        since: int | None = None,
    ) -> list[FrozenTrial]:
        with self._lock:
            cache = self._refresh_locked(study_id)
            trials = [cache.trials[n] for n in sorted(cache.trials)]
            if since is not None:
                trials = [t for t in trials if t.number >= since]
            if states is not None:
                trials = [t for t in trials if t.state in states]
            return [copy.deepcopy(t) for t in trials] if deepcopy else trials

    def _refresh_locked(self, study_id: int) -> _StudyCache:
        """Fetch the unfinished suffix from the backend and advance the
        watermark past newly finished trials.

        The fetch is skipped entirely when the backend's monotonic trial
        revision is unchanged since the last refresh — one cheap counter read
        (a single RPC over ``remote://``) instead of re-shipping every
        RUNNING trial on every ``ask``.  Any trial mutation bumps the
        revision, so in-place updates to RUNNING trials are still seen."""
        cache = self._studies.setdefault(study_id, _StudyCache())
        rev: int | None = None
        if self._revision_supported:
            try:
                rev = self._backend.get_trials_revision(study_id)
            except NotImplementedError:
                self._revision_supported = False
        if rev is not None and rev == cache.revision:
            telemetry.inc("cached.refresh.noop")  # revision-gated skip
            return cache
        # read the revision before the data: writes landing between the two
        # reads show up as a fresh revision on the next refresh
        telemetry.inc("cached.refresh.fetch")
        fresh = get_trials_since(self._backend, study_id, cache.watermark, deepcopy=False)
        for t in fresh:
            if t.trial_id in self._own:
                continue  # never clobber our local (possibly unflushed) copy
            cache.trials[t.number] = t
            self._index[t.trial_id] = (study_id, t.number)
        for tid, t in self._own.items():
            sid, number = self._index[tid]
            if sid == study_id:
                cache.trials[number] = t
        while cache.watermark in cache.trials and cache.trials[cache.watermark].state.is_finished():
            cache.watermark += 1
        cache.revision = rev
        return cache

    # -- write-behind flushing ----------------------------------------------------

    def _flush_trial_locked(self, trial_id: int) -> None:
        """Drain one trial's write-behind buffer.  The buffer is popped only
        AFTER the backend confirms — a flush into a dead server keeps every
        op queued for the next attempt (every buffered op is an overwrite,
        so a partially-applied batch replays harmlessly)."""
        ops = self._pending.get(trial_id)
        if not ops:
            return
        call_batch = getattr(self._backend, "call_batch", None)
        try:
            if call_batch is not None and len(ops) > 1:
                call_batch(list(ops))  # one round trip for the whole buffer
            else:
                for method, params in ops:
                    getattr(self._backend, method)(*params)
        except _TRANSIENT:
            telemetry.inc("cached.flush.failures")
            raise
        self._pending.pop(trial_id, None)

    def flush(self) -> None:
        """Push all buffered writes to the backend.  On a transient backend
        failure the unflushed buffers stay queued (and the error propagates);
        calling ``flush()`` again once the backend is back re-sends them."""
        with self._lock:
            for tid in list(self._pending):
                self._flush_trial_locked(tid)

    @property
    def pending_ops(self) -> int:
        """Number of buffered write-behind ops not yet confirmed flushed."""
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    # -- heartbeat / misc ---------------------------------------------------------

    def get_trials_revision(self, study_id: int) -> int:
        return self._backend.get_trials_revision(study_id)

    def record_heartbeat(self, trial_id: int) -> None:
        self._backend.record_heartbeat(trial_id)

    def get_stale_trial_ids(self, study_id: int, grace_seconds: float) -> list[int]:
        return self._backend.get_stale_trial_ids(study_id, grace_seconds)

    def fail_stale_trials(self, study_id: int, grace_seconds: float) -> list[int]:
        return self._backend.fail_stale_trials(study_id, grace_seconds)

    def reclaim_stale_trials(
        self, study_id: int, grace_seconds: float, requeue: bool = False
    ) -> list[int]:
        return self._backend.reclaim_stale_trials(study_id, grace_seconds, requeue)

    def get_trial_events(self, study_id: int, since: int = 0) -> dict[str, Any]:
        """Lifecycle events live where the mutations execute — the backend."""
        return self._backend.get_trial_events(study_id, since)

    @property
    def supports_block_fetch(self) -> bool:
        return getattr(self._backend, "supports_block_fetch", False)

    def get_observation_block(self, study_id: int, since: int = 0) -> dict[str, Any]:
        # drain write-behind buffers first so the backend snapshot is at
        # least as fresh as what this process has already observed locally
        self.flush()
        return self._backend.get_observation_block(study_id, since)

    def get_iv_block(self, study_id: int, since: int = 0) -> dict[str, Any]:
        self.flush()
        return self._backend.get_iv_block(study_id, since)

    def get_server_metrics(self) -> dict[str, Any]:
        fn = getattr(self._backend, "get_server_metrics", None)
        if fn is None:
            raise NotImplementedError("backend has no server metrics surface")
        return fn()

    def close(self) -> None:
        try:
            self.flush()
        except _TRANSIENT:
            pass  # shutting down against a dead backend: nothing left to try
        self._backend.close()
