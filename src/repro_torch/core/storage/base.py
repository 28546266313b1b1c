"""Abstract storage API.

Every worker in a distributed study shares progress exclusively through an
implementation of :class:`BaseStorage` (paper §4, Fig. 6).  The API is
deliberately small and transactional at the single-call level so backends can
be implemented over an RDB, a journal file, or an in-process dict.

Concurrency contract (what samplers/pruners may assume):

* ``create_new_trial`` atomically assigns a unique, dense trial ``number``.
* ``set_trial_state_values`` is atomic; transitioning RUNNING->finished is
  last-writer-wins, WAITING->RUNNING returns False if another worker already
  claimed the trial.
* reads (``get_all_trials``) may lag writes from other workers — samplers are
  designed for asynchrony (the paper's ASHA never blocks on peers).
"""

from __future__ import annotations

import datetime
import threading
from typing import Any, Iterable

from .. import telemetry
from ..distributions import BaseDistribution
from ..frozen import FrozenTrial, StudyDirection, TrialState

__all__ = ["BaseStorage", "StudySummary", "get_trials_since"]

# TrialState -> lifecycle event kind for successful set_trial_state_values
# transitions (WAITING releases are bookkeeping, not lifecycle — no event)
_STATE_EVENTS = {
    int(TrialState.RUNNING): telemetry.EV_CLAIMED,
    int(TrialState.COMPLETE): telemetry.EV_COMPLETED,
    int(TrialState.PRUNED): telemetry.EV_PRUNED,
    int(TrialState.FAIL): telemetry.EV_FAILED,
}


class StudySummary:
    def __init__(
        self,
        study_id: int,
        study_name: str,
        directions: list[StudyDirection],
        n_trials: int,
        user_attrs: dict[str, Any] | None = None,
        system_attrs: dict[str, Any] | None = None,
    ):
        self.study_id = study_id
        self.study_name = study_name
        self.directions = directions
        self.n_trials = n_trials
        self.user_attrs = user_attrs or {}
        self.system_attrs = system_attrs or {}

    def __repr__(self) -> str:
        return f"StudySummary(name={self.study_name!r}, n_trials={self.n_trials})"


class BaseStorage:
    # -- study ---------------------------------------------------------------

    def create_new_study(
        self, directions: list[StudyDirection], study_name: str
    ) -> int:
        raise NotImplementedError

    def delete_study(self, study_id: int) -> None:
        raise NotImplementedError

    def get_study_id_from_name(self, study_name: str) -> int:
        raise NotImplementedError

    def get_study_name_from_id(self, study_id: int) -> str:
        raise NotImplementedError

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        raise NotImplementedError

    def get_all_studies(self) -> list[StudySummary]:
        raise NotImplementedError

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        raise NotImplementedError

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        raise NotImplementedError

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        raise NotImplementedError

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        raise NotImplementedError

    # -- trial ---------------------------------------------------------------

    def create_new_trial(
        self, study_id: int, template_trial: FrozenTrial | None = None
    ) -> int:
        raise NotImplementedError

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        """Create ``n`` trials; the batched form ``Study.ask(n)`` uses.
        Backends with request batching (``remote://``) override this to claim
        all ids in one round trip."""
        return [self.create_new_trial(study_id, template_trial) for _ in range(n)]

    def set_trial_param(
        self,
        trial_id: int,
        param_name: str,
        param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        raise NotImplementedError

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Iterable[float] | None = None
    ) -> bool:
        """Atomically set state (and final values).  Returns False iff the
        transition was a WAITING->RUNNING claim lost to another worker."""
        raise NotImplementedError

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        raise NotImplementedError

    def set_trial_intermediate_vector(
        self, trial_id: int, step: int, values: "Iterable[float]"
    ) -> None:
        """Persist a per-objective intermediate vector at ``step`` (multi-
        objective learning curves).  Composed from existing primitives — the
        vector rides an ``iv_vec:<step>`` system attr and objective 0 lands
        in the scalar stream — so every backend, both wire protocols, the op
        journal and replication support it with no schema change.  Callers
        that scalarize for pruning (``Trial.report`` with a Pareto-aware
        pruner) write the attr themselves and keep the fused op's scalar."""
        from ..frozen import iv_vec_key

        values = [float(v) for v in values]
        if not values:
            raise ValueError("intermediate vector must be non-empty")
        self.set_trial_system_attr(trial_id, iv_vec_key(step), values)
        self.set_trial_intermediate_value(trial_id, int(step), values[0])

    # class-level: guards lazy creation of per-instance store dicts
    _iv_stores_lock = threading.Lock()

    def report_and_prune(
        self,
        study_id: int,
        trial_id: int,
        step: int,
        value: float,
        pruner_spec: dict,
        direction: "StudyDirection | int",
    ) -> bool:
        """Fused report→prune: persist one intermediate value and return the
        prune decision against this backend's peer data, in a single storage
        operation.

        ``pruner_spec`` is the wire form from ``BasePruner.spec()``;
        ``direction`` the study's optimization direction.  The decision runs
        the pruner's vectorized ``decide`` against a per-study
        :class:`~repro_torch.core.records.IntermediateValueStore` hosted *on this
        backend* — for ``remote://`` that means the server evaluates with its
        own (always-warm) peer data and a worker's ``trial.report()`` +
        ``should_prune()`` costs exactly one round trip, instead of
        set-value + trial refetch + a full peer re-read.

        This default implementation serves every in-process backend
        (in-memory / sqlite / journal); :class:`RemoteStorage` forwards it as
        one RPC and :class:`CachedStorage` batches it with any buffered
        write-behind ops.
        """
        with telemetry.span("storage.report_and_prune"):
            self.set_trial_intermediate_value(trial_id, int(step), float(value))
            if pruner_spec.get("name") in ("nop", "none"):
                return False  # nothing to rank: skip the store refresh entirely
            from ..pruners import pruner_from_spec

            pruner = pruner_from_spec(pruner_spec)
            store = self._intermediate_store(study_id)
            store.refresh()
            trial = self.get_trial(trial_id)
            return bool(pruner.decide(StudyDirection(direction), store, trial))

    def _intermediate_store(self, study_id: int):
        """The per-study intermediate-value store hosted on this backend,
        created lazily (kept warm across fused calls).  Hosted stores track a
        per-trial dirty set — every ``set_trial_intermediate_value`` on this
        backend notes the written trial via :meth:`_note_iv_dirty`, so a
        refresh re-encodes only the changed RUNNING rows, O(changed trials)
        instead of O(rows past the watermark)."""
        from ..records import IntermediateValueStore

        with BaseStorage._iv_stores_lock:
            stores = self.__dict__.setdefault("_iv_stores", {})
            store = stores.get(study_id)
            if store is None:
                stores[study_id] = store = IntermediateValueStore(
                    self, study_id, track_dirty=True
                )
            return store

    def _note_iv_dirty(self, trial_id: int, study_id: "int | None" = None) -> None:
        """Tell the hosted intermediate-value store one trial's reports
        changed.  ``study_id`` scopes the note to the owning study's store
        (every backend can resolve it cheaply); a foreign-study note would
        otherwise poison that store's dirty tracking with an unknown id and
        degrade its refresh back to full re-encodes.  Backends call this from
        ``set_trial_intermediate_value`` **after releasing their own lock**
        (a hosted store's refresh takes the store lock first, then reads
        through the backend — noting under the backend lock would invert
        that order and deadlock)."""
        with BaseStorage._iv_stores_lock:
            stores = self.__dict__.get("_iv_stores")
            if not stores:
                return
            if study_id is not None:
                store = stores.get(study_id)
                targets = [store] if store is not None else []
            else:
                targets = list(stores.values())
        for store in targets:
            store.note_dirty(trial_id)

    def _drop_intermediate_store(self, study_id: int) -> None:
        """Evict a deleted study's store — backends call this from
        ``delete_study`` so a long-lived server does not pin one warm matrix
        per study it ever pruned for."""
        with BaseStorage._iv_stores_lock:
            stores = self.__dict__.get("_iv_stores")
            if stores is not None:
                stores.pop(study_id, None)

    # -- trial lifecycle event trace -------------------------------------------

    # class-level: guards lazy creation of per-instance event-log dicts
    # (same hosting pattern as the intermediate-value stores above)
    _event_logs_lock = threading.Lock()

    def _event_log(self, study_id: int) -> "telemetry.TrialEventLog":
        with BaseStorage._event_logs_lock:
            logs = self.__dict__.setdefault("_event_logs", {})
            log = logs.get(study_id)
            if log is None:
                logs[study_id] = log = telemetry.TrialEventLog()
            return log

    def _record_event(
        self, study_id: int, kind: int, number: int, step: int = -1
    ) -> None:
        """Append one lifecycle event to the study's hosted trace.  Backends
        call this from their mutation methods **after releasing their own
        lock** (the log takes its own leaf lock; keeping the orders disjoint
        mirrors the ``_note_iv_dirty`` rule)."""
        self._event_log(study_id).append(kind, number, step=step)

    def _record_state_event(
        self, study_id: int, state: TrialState, number: int
    ) -> None:
        """Event for a *successful* ``set_trial_state_values`` transition:
        RUNNING means the trial was claimed, finished states map directly;
        a WAITING (re-)release is queue bookkeeping and records nothing."""
        kind = _STATE_EVENTS.get(int(state))
        if kind is not None:
            self._record_event(study_id, kind, number)

    def get_trial_events(self, study_id: int, since: int = 0) -> dict[str, Any]:
        """Columnar trial-lifecycle trace of a study, from event ``since`` on
        (:meth:`telemetry.TrialEventLog.snapshot` wire format: parallel JSON
        lists + interned worker table).  The trace lives on the backend that
        executed the mutations, so over ``remote://`` one RPC returns the
        server-side fleet-wide sequence."""
        return self._event_log(study_id).snapshot(since)

    def _drop_event_log(self, study_id: int) -> None:
        with BaseStorage._event_logs_lock:
            logs = self.__dict__.get("_event_logs")
            if logs is not None:
                logs.pop(study_id, None)

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        raise NotImplementedError

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        raise NotImplementedError

    def get_trial(self, trial_id: int) -> FrozenTrial:
        raise NotImplementedError

    def get_all_trials(
        self,
        study_id: int,
        deepcopy: bool = True,
        states: tuple[TrialState, ...] | None = None,
        since: int | None = None,
    ) -> list[FrozenTrial]:
        """All trials of a study, ordered by ``number``.

        ``since`` restricts the result to trials with ``number >= since`` —
        the incremental-fetch hook :class:`CachedStorage` uses to avoid
        re-reading finished trials on every ``ask``.  Backends that predate
        the parameter still work through :func:`get_trials_since`.
        """
        raise NotImplementedError

    def get_n_trials(
        self, study_id: int, states: tuple[TrialState, ...] | None = None
    ) -> int:
        return len(self.get_all_trials(study_id, deepcopy=False, states=states))

    def get_trial_id_from_study_and_number(self, study_id: int, number: int) -> int:
        for t in self.get_all_trials(study_id, deepcopy=False):
            if t.number == number:
                return t.trial_id
        from ..exceptions import TrialNotFoundError

        raise TrialNotFoundError(f"no trial number {number} in study {study_id}")

    def get_trials_revision(self, study_id: int) -> int:
        """Monotonic per-study counter, bumped by **every** trial mutation —
        including in-place updates to RUNNING trials that a number-based
        ``get_all_trials(since=...)`` poll alone cannot distinguish from "no
        change".  Readers (``CachedStorage``, ``ObservationStore``) poll it to
        skip suffix fetches entirely when nothing moved.  Backends that cannot
        provide one raise ``NotImplementedError``; callers must then fall back
        to always refetching."""
        raise NotImplementedError

    # -- columnar block fetch ---------------------------------------------------

    supports_block_fetch = False
    """Whether the block RPCs below are worth attempting over this backend.
    In-process backends keep it False (``ObservationStore`` ingests their
    trial objects directly, there is nothing to save); ``RemoteStorage``
    flips it on when wire protocol v2 is negotiated."""

    def get_observation_block(self, study_id: int, since: int = 0) -> dict[str, Any]:
        """Observations of *finished* trials with ``number >= since``, as a
        dict of contiguous numpy columns (see
        :func:`.serde.build_observation_block` for the exact layout).  Over
        wire protocol v2 this is the near-memcpy refresh path of
        :class:`~repro_torch.core.records.ObservationStore`."""
        from .serde import build_observation_block

        trials = get_trials_since(self, study_id, since, deepcopy=False)
        return build_observation_block(trials, len(self.get_study_directions(study_id)))

    def get_iv_block(self, study_id: int, since: int = 0) -> dict[str, Any]:
        """Intermediate-value curves of trials with ``number >= since`` in
        CSR layout (see :func:`.serde.build_iv_block`)."""
        from .serde import build_iv_block

        return build_iv_block(get_trials_since(self, study_id, since, deepcopy=False))

    # -- heartbeat / fault tolerance ------------------------------------------

    def record_heartbeat(self, trial_id: int) -> None:
        """Default: no-op.  Backends that support failover override this."""

    def get_stale_trial_ids(self, study_id: int, grace_seconds: float) -> list[int]:
        """Trial ids in RUNNING state whose last heartbeat is older than
        ``grace_seconds`` (i.e. their worker likely died)."""
        return []

    def fail_stale_trials(self, study_id: int, grace_seconds: float) -> list[int]:
        return self.reclaim_stale_trials(study_id, grace_seconds, requeue=False)

    def reclaim_stale_trials(
        self, study_id: int, grace_seconds: float, requeue: bool = False
    ) -> list[int]:
        """Reclaim RUNNING trials whose worker stopped heartbeating: mark them
        FAILed, or — with ``requeue=True`` — hand them back to the WAITING
        queue so another worker's ``ask()`` can claim and re-run them.
        Returns the reclaimed trial ids."""
        target = TrialState.WAITING if requeue else TrialState.FAIL
        reclaimed = []
        for tid in self.get_stale_trial_ids(study_id, grace_seconds):
            if self.set_trial_state_values(tid, target):
                if requeue:
                    # re-arm the staleness clock: whoever claims the requeued
                    # trial gets a full grace period before the next sweep
                    self.record_heartbeat(tid)
                reclaimed.append(tid)
        return reclaimed

    # -- misc ------------------------------------------------------------------

    def _now(self) -> datetime.datetime:
        return datetime.datetime.now()

    def close(self) -> None:
        pass


def get_trials_since(
    storage: BaseStorage,
    study_id: int,
    since: int,
    deepcopy: bool = True,
    states: tuple[TrialState, ...] | None = None,
) -> list[FrozenTrial]:
    """Fetch trials with ``number >= since``, falling back to a full read +
    filter for backends whose ``get_all_trials`` does not accept ``since``."""
    try:
        return storage.get_all_trials(study_id, deepcopy=deepcopy, states=states, since=since)
    except TypeError:
        trials = storage.get_all_trials(study_id, deepcopy=deepcopy, states=states)
        return [t for t in trials if t.number >= since]
