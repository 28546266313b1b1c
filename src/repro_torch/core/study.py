"""``Study`` — one optimization process (paper §2).

A study owns a sampler, a pruner and a storage handle.  ``optimize`` runs the
define-by-run objective repeatedly; distributed optimization is *the same
call from N processes against the same storage* (paper Fig. 7) — there is no
coordinator.  ``ask``/``tell`` expose the trial lifecycle for custom loops
(e.g. the tune scheduler placing trials onto mesh slices).
"""

from __future__ import annotations

import datetime
import logging
import math
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from ..kernels import ops as kops
from . import telemetry
from .exceptions import DuplicatedStudyError, TrialPruned
from .frozen import FrozenTrial, StudyDirection, TrialState
from .log import get_logger
from .pruners import BasePruner, NopPruner
from .records import IntermediateValueStore, ObservationStore
from .samplers import BaseSampler, TPESampler
from .search_space import observed_groups
from .storage import BaseStorage, get_storage
from .trial import Trial

__all__ = ["Study", "create_study", "load_study", "delete_study"]

ObjectiveFunc = Callable[[Trial], float]

_log = get_logger(__name__)


class Study:
    def __init__(
        self,
        study_name: str,
        storage: "str | BaseStorage | None" = None,
        sampler: BaseSampler | None = None,
        pruner: BasePruner | None = None,
        engine: str = "auto",
        device: "str | None" = None,
    ):
        """``engine`` and ``device`` select the compute path of the study's
        own columnar reductions (``pareto_front``) and of the default
        sampler: ``"auto"`` dispatches to the device past the shared work
        thresholds, ``"numpy"``/``"torch"``/``"cuda"`` force a path
        (``kernels/ops.py``); ``device=None`` means the card,
        ``device="cpu"`` runs the plain PyTorch version on the host.
        Without a CUDA device every engine but ``"numpy"`` raises unless
        ``device="cpu"`` is given (``pareto_front`` only when its reduction
        leaves the host).  An explicitly passed sampler keeps its own
        ``engine`` and ``device``."""
        self._storage = get_storage(storage)
        self.study_name = study_name
        self._study_id = self._storage.get_study_id_from_name(study_name)
        self._engine = kops.validate_engine(engine)
        self._device = device
        self.sampler = sampler or TPESampler(engine=engine, device=device)
        self.pruner = pruner or NopPruner()
        self._stop_requested = False
        self._records: ObservationStore | None = None
        self._ivs: IntermediateValueStore | None = None
        # joint-sampling state: group decomposition memoized per store
        # version; the miss log fires once per study, not per trial
        self._groups_cache: "tuple[int, list] | None" = None
        self._joint_miss_logged = False
        # directions are immutable after creation: fetch once here so the
        # fused report path never pays an extra storage call for them
        self._directions: list[StudyDirection] = (
            self._storage.get_study_directions(self._study_id)
        )
        # heartbeat configuration (fault tolerance)
        self.heartbeat_interval: float | None = None
        self.failed_trial_grace: float = 60.0

    # -- directions ----------------------------------------------------------------

    @property
    def directions(self) -> list[StudyDirection]:
        return list(self._directions)

    @property
    def direction(self) -> StudyDirection:
        ds = self.directions
        if len(ds) != 1:
            raise RuntimeError("multi-objective study; use .directions")
        return ds[0]

    # -- trial access ----------------------------------------------------------------

    @property
    def trials(self) -> list[FrozenTrial]:
        return self.get_trials()

    def get_trials(
        self,
        deepcopy: bool = True,
        states: tuple[TrialState, ...] | None = None,
    ) -> list[FrozenTrial]:
        return self._storage.get_all_trials(self._study_id, deepcopy=deepcopy, states=states)

    def observations(self) -> ObservationStore:
        """The study's columnar observation store: finished-trial history as
        number-ordered arrays (one model-space matrix + values/states
        vectors), refreshed incrementally.  This is the substrate every
        array-native sampler reads instead of ``get_trials`` — see
        ``core/records.py``."""
        if self._records is None:
            self._records = ObservationStore(self._storage, self._study_id)
        self._records.refresh()
        return self._records

    def intermediate_values(self, objective: "int | None" = None):
        """The study's columnar intermediate-value store: every trial's
        reported values as one revision-gated ``(n_trials, n_steps)``
        NaN-padded matrix with cached best-so-far prefixes — the substrate
        the vectorized pruner stack reads instead of re-walking
        ``intermediate_values`` dicts (see ``core/records.py``).

        With ``objective=k`` returns that objective's ``(n_trials, n_steps)``
        learning-curve matrix instead of the store — vector reports read
        from the per-objective tensor, scalar reports count as objective 0
        (see ``IntermediateValueStore.objective_matrix``)."""
        if self._ivs is None:
            self._ivs = IntermediateValueStore(self._storage, self._study_id)
        self._ivs.refresh()
        if objective is None:
            return self._ivs
        return self._ivs.objective_matrix(int(objective))

    @property
    def best_trial(self) -> FrozenTrial:
        best = None
        sign = 1.0 if self.direction == StudyDirection.MINIMIZE else -1.0
        for t in self.get_trials(deepcopy=False, states=(TrialState.COMPLETE,)):
            if t.values is None or not math.isfinite(t.values[0]):
                continue
            if best is None or sign * t.values[0] < sign * best.values[0]:
                best = t
        if best is None:
            raise ValueError("no completed trials yet")
        return best.copy()

    @property
    def best_params(self) -> dict[str, Any]:
        return self.best_trial.params

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    @property
    def best_trials(self) -> list[FrozenTrial]:
        """Pareto-optimal completed trials, computed on the multi-objective
        engine: one vectorized dominance reduction over the observation
        store's values matrix (``core/moo.py``) instead of the historical
        O(n²·m) pure-Python pairwise loop (kept as
        :func:`_pairwise_best_trials` and pinned bit-identical to it by
        ``tests/test_torch_moo.py``)."""
        front_numbers = set(self.pareto_front()[1].tolist())
        directions = self.directions
        out = []
        for t in self.get_trials(deepcopy=False, states=(TrialState.COMPLETE,)):
            if t.values is None or len(t.values) != len(directions):
                continue
            if t.number in front_numbers:
                out.append(t.copy())
        return out

    def pareto_front(self) -> "tuple[np.ndarray, np.ndarray]":
        """``(values, numbers)`` of the non-dominated COMPLETE trials, as
        arrays straight off the columnar engine: ``values`` is the
        ``(n_front, n_objectives)`` slice of the observation store's values
        matrix (raw study orientation, number-ordered), ``numbers`` the
        matching trial numbers.  No ``FrozenTrial`` materialization — this is
        the fast path dashboards, samplers and benchmarks read."""
        from . import moo

        store = self.observations()
        directions = self.directions
        # one consistent snapshot: a concurrent refresh from another worker
        # thread must not pair this mask with a re-sorted values matrix
        _, states, V, arity, numbers, _ = store.snapshot_mo()
        mask = (states == int(TrialState.COMPLETE)) & (arity == len(directions))
        front = moo.pareto_front_mask(
            moo.loss_matrix(V, directions), mask=mask,
            engine=self._engine, device=self._device,
        )
        return V[front], numbers[front]

    # -- attrs -------------------------------------------------------------------------

    @property
    def user_attrs(self) -> dict[str, Any]:
        return self._storage.get_study_user_attrs(self._study_id)

    @property
    def system_attrs(self) -> dict[str, Any]:
        return self._storage.get_study_system_attrs(self._study_id)

    def set_user_attr(self, key: str, value: Any) -> None:
        self._storage.set_study_user_attr(self._study_id, key, value)

    def set_system_attr(self, key: str, value: Any) -> None:
        self._storage.set_study_system_attr(self._study_id, key, value)

    # -- ask / tell ----------------------------------------------------------------------

    def ask(self, n: int | None = None) -> "Trial | list[Trial]":
        """Create a new trial (claiming an enqueued WAITING one if present).

        ``ask(n)`` is the batched form: it claims up to ``n`` enqueued
        WAITING trials, creates the remainder in one storage round trip
        (``create_new_trials`` batches over ``remote://``), and returns a
        list of ``n`` trials.  Distributed workers and the tune scheduler use
        it to seed a whole wave of trials per round trip."""
        with telemetry.span("study.ask"):
            if n is None:
                for t in self.get_trials(deepcopy=False, states=(TrialState.WAITING,)):
                    if self._storage.set_trial_state_values(t.trial_id, TrialState.RUNNING):
                        return Trial(self, t.trial_id)
                trial_id = self._storage.create_new_trial(self._study_id)
                return Trial(self, trial_id)
            if n < 0:
                raise ValueError(f"ask(n) needs n >= 0, got {n}")
            trials: list[Trial] = []
            fixed: set[int] = set()  # claimed enqueued trials with fixed params
            for t in self.get_trials(deepcopy=False, states=(TrialState.WAITING,)):
                if len(trials) == n:
                    break
                if self._storage.set_trial_state_values(t.trial_id, TrialState.RUNNING):
                    trials.append(Trial(self, t.trial_id))
                    if t.system_attrs.get("fixed_params"):
                        fixed.add(t.trial_id)
            for trial_id in self._storage.create_new_trials(self._study_id, n - len(trials)):
                trials.append(Trial(self, trial_id))
            # enqueued configurations replay their fixed params, never the block:
            # presampling them would waste draws and, worse, consume stateful
            # joint side effects (a grid cell claimed for a trial that will not
            # evaluate it) — they keep the scalar path exactly as ask() would
            sampled = [t for t in trials if t._trial_id not in fixed]
            if sampled:
                self._presample_joint(sampled)
            return trials

    # -- joint (block) sampling -----------------------------------------------

    def observed_param_groups(self) -> list:
        """Group decomposition of the observed search space (connected
        components of co-observed parameters), memoized per observation-store
        version — see ``search_space.observed_groups``."""
        store = self.observations()
        cached = self._groups_cache
        if cached is not None and cached[0] == store.version:
            return cached[1]
        groups = observed_groups(store)
        self._groups_cache = (store.version, groups)
        return groups

    def _presample_joint(self, trials: "list[Trial]") -> None:
        """One ``sample_joint`` call per observed parameter group covers the
        whole wave: each pending trial gets its slice of the returned
        ``(n, n_params)`` block attached, and its ``suggest_*`` calls resolve
        from the slice with no further sampler work (see ``Trial._sample``).
        Samplers without a joint model (or with ``multivariate=False``)
        decline and the per-trial define-by-run path runs untouched."""
        sampler = self.sampler
        if not sampler.joint_enabled():
            return
        with telemetry.span("study.presample_joint"):
            self._presample_joint_inner(trials, sampler)

    def _presample_joint_inner(self, trials: "list[Trial]", sampler: BaseSampler) -> None:
        groups = self.observed_param_groups()
        if not groups:
            return
        n = len(trials)
        trial_ids = [t._trial_id for t in trials]
        # the wave's RNG key: the first pending trial's storage-assigned
        # number (one cached get_trial at most).  Concurrent workers claim
        # disjoint numbers, so their joint blocks draw from distinct streams
        # even with identical histories — keying on history length could not
        # distinguish them.
        try:
            first_number = trials[0].number
        except Exception:  # pragma: no cover - racing delete
            first_number = None
        rows: list[dict[str, float]] = [{} for _ in trials]
        dists: dict[str, Any] = {}
        any_block = False
        kwargs: dict[str, Any] = {"trial_ids": trial_ids}
        if self._sampler_takes_first_number(sampler):
            kwargs["first_number"] = first_number
        for group in groups:
            block = sampler.sample_joint(self, group, n, **kwargs)
            if block is None:
                # declined whole group (startup/warmup): record NaN cells so
                # the shim falls back silently — only parameters *no* group
                # predicted (dynamic branches) count as misses worth logging
                for name in group.names:
                    dists[name] = group.dists[name]
                    for row in rows:
                        row[name] = float("nan")
                continue
            block = np.asarray(block, dtype=float)
            if block.shape != (n, len(group.names)):
                raise ValueError(
                    f"sample_joint returned shape {block.shape}, expected "
                    f"{(n, len(group.names))} for group {group.names}"
                )
            any_block = True
            for j, name in enumerate(group.names):
                dists[name] = group.dists[name]
                for i in range(n):
                    rows[i][name] = float(block[i, j])
        if any_block:
            for trial, row in zip(trials, rows):
                trial._joint = row
                trial._joint_dists = dists

    def _sampler_takes_first_number(self, sampler: BaseSampler) -> bool:
        """Custom samplers may predate the ``first_number`` kwarg of the
        block contract: probe the signature once per study (not
        TypeError-catch per call, which would swallow genuine errors inside
        the sampler)."""
        cached = self.__dict__.get("_joint_sig_ok")
        if cached is not None and cached[0] is type(sampler):
            return cached[1]
        import inspect

        ok = False
        try:
            ok = "first_number" in inspect.signature(sampler.sample_joint).parameters
        except (TypeError, ValueError):  # pragma: no cover - exotic callables
            pass
        self.__dict__["_joint_sig_ok"] = (type(sampler), ok)
        return ok

    def _note_joint_miss(self, name: str, reason: str) -> None:
        """Joint-block prediction miss (dynamic branch / drifted domain):
        log once per study — a per-trial warning would fire on every wave of
        a branching objective and drown real signal."""
        if self._joint_miss_logged:
            return
        self._joint_miss_logged = True
        telemetry.inc("study.joint_miss")
        # the per-study flag above already dedupes; a global log_once keyed
        # on id(self) would go silent when a dead study's id gets reused
        _log.log(
            logging.INFO,
            "study %r [worker %s]: joint block missed parameter %r (%s); "
            "falling back to per-trial scalar sampling for divergent "
            "parameters (logged once per study)",
            self.study_name, telemetry.worker_id(), name, reason,
        )

    def tell(
        self,
        trial: "Trial | int",
        values: "float | Sequence[float] | None" = None,
        state: TrialState = TrialState.COMPLETE,
    ) -> None:
        with telemetry.span("study.tell"):
            trial_id, state, values = self._normalize_tell(trial, values, state)
            self._storage.set_trial_state_values(trial_id, state, values)
            frozen = self._storage.get_trial(trial_id)
            self.sampler.after_trial(self, frozen, state, values)
            if self._records is not None:
                self._records.refresh()  # ingest the finished trial incrementally

    def tell_batch(
        self,
        results: Sequence[tuple],
        state: TrialState = TrialState.COMPLETE,
    ) -> None:
        """Report many finished trials at once.  Each item is ``(trial,
        values)`` or ``(trial, values, state)``.  Over a batching backend
        (``remote://``) all state transitions travel in one frame."""
        with telemetry.span("study.tell_batch"):
            normalized = []
            for item in results:
                trial, values = item[0], item[1]
                st = item[2] if len(item) > 2 else state
                normalized.append(self._normalize_tell(trial, values, st))
            call_batch = getattr(self._storage, "call_batch", None)
            if call_batch is not None and len(normalized) > 1:
                call_batch(
                    [("set_trial_state_values", (tid, st, vs)) for tid, st, vs in normalized]
                )
                frozens = call_batch([("get_trial", (tid,)) for tid, _, _ in normalized])
            else:
                for tid, st, vs in normalized:
                    self._storage.set_trial_state_values(tid, st, vs)
                frozens = [self._storage.get_trial(tid) for tid, _, _ in normalized]
            for frozen, (tid, st, vs) in zip(frozens, normalized):
                self.sampler.after_trial(self, frozen, st, vs)
            if self._records is not None:
                self._records.refresh()

    @staticmethod
    def _normalize_tell(trial, values, state) -> tuple[int, TrialState, "list[float] | None"]:
        trial_id = trial._trial_id if isinstance(trial, Trial) else int(trial)
        if values is not None:
            values = [float(values)] if not isinstance(values, (list, tuple)) else [
                float(v) for v in values
            ]
        if state == TrialState.COMPLETE and values is None:
            raise ValueError("completed trials need a value")
        if values is not None and any(v != v for v in values):
            state, values = TrialState.FAIL, None  # NaN objective -> failed
        return trial_id, state, values

    def enqueue_trial(self, params: dict[str, Any], user_attrs: dict[str, Any] | None = None) -> None:
        """Seed the study with a known-good configuration (warm start)."""
        t = FrozenTrial(number=-1, state=TrialState.WAITING, system_attrs={"fixed_params": params})
        if user_attrs:
            t.user_attrs.update(user_attrs)
        self._storage.create_new_trial(self._study_id, template_trial=t)

    def stop(self) -> None:
        """Ask ``optimize`` loops in this process to stop after the current trial."""
        self._stop_requested = True

    # -- optimize -------------------------------------------------------------------------

    def optimize(
        self,
        func: ObjectiveFunc,
        n_trials: int | None = None,
        timeout: float | None = None,
        n_jobs: int = 1,
        catch: tuple[type[Exception], ...] = (),
        callbacks: Iterable[Callable[["Study", FrozenTrial], None]] | None = None,
        gc_after_trial: bool = False,
        show_progress_bar: bool = False,
        ask_batch: int = 1,
    ) -> None:
        """``ask_batch > 1`` claims that many trials per storage round trip
        (``ask(n)``) and evaluates them sequentially — the lever distributed
        workers use to amortize remote-storage latency."""
        self._stop_requested = False
        callbacks = list(callbacks or [])
        deadline = time.time() + timeout if timeout is not None else None

        if n_jobs == 1:
            self._optimize_loop(func, n_trials, deadline, catch, callbacks, ask_batch)
            return

        # thread-based parallel trials against shared storage (the in-process
        # version of paper Fig. 7)
        budget_lock = threading.Lock()
        remaining = [n_trials]

        def take() -> bool:
            with budget_lock:
                if remaining[0] is None:
                    return True
                if remaining[0] <= 0:
                    return False
                remaining[0] -= 1
                return True

        def worker():
            while not self._stop_requested:
                if deadline is not None and time.time() > deadline:
                    break
                # grab up to ask_batch budget slots (capped to the sampler's
                # generation size), claim them in one round trip, evaluate
                # sequentially
                eff = max(1, min(ask_batch, self.sampler.joint_wave_size(self, ask_batch)))
                slots = 0
                while slots < eff and take():
                    slots += 1
                if slots == 0:
                    break
                pending = self.ask(slots) if ask_batch > 1 else [None] * slots
                try:
                    while pending:
                        if self._stop_requested or (
                            deadline is not None and time.time() > deadline
                        ):
                            break
                        self._run_one(func, catch, callbacks, trial=pending.pop(0))
                finally:
                    self._release_unrun(pending)

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(n_jobs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    def _optimize_loop(self, func, n_trials, deadline, catch, callbacks, ask_batch=1) -> None:
        i = 0
        pending: list[Trial] = []
        try:
            while n_trials is None or i < n_trials:
                if self._stop_requested:
                    break
                if deadline is not None and time.time() > deadline:
                    break
                if ask_batch > 1 and not pending:
                    want = ask_batch if n_trials is None else min(ask_batch, n_trials - i)
                    # popsize-aware waves: a generation-based sampler (CMA-ES,
                    # NSGA-II) caps the wave so each ask(n) block aligns with
                    # one generation instead of replaying a stale state past it
                    want = max(1, min(want, self.sampler.joint_wave_size(self, want)))
                    pending = self.ask(want)
                trial = pending.pop(0) if pending else None
                self._run_one(func, catch, callbacks, trial=trial)
                i += 1
        finally:
            self._release_unrun(pending)

    def _release_unrun(self, trials: "list[Trial]") -> None:
        """Return batch-asked but never-evaluated trials (stop/deadline/raise)
        to the WAITING queue: no parameter was suggested yet, so enqueued
        warm-start configurations survive and any later ``ask`` — here or on
        another worker — claims them intact instead of leaking RUNNING rows."""
        for t in trials:
            if t is None:
                continue
            try:
                self._storage.set_trial_state_values(t._trial_id, TrialState.WAITING)
            except Exception:
                warnings.warn(f"could not release unevaluated trial {t._trial_id}")

    def _run_one(self, func, catch, callbacks, trial: "Trial | None" = None) -> FrozenTrial:
        if trial is None:
            trial = self.ask()
        trial_id = trial._trial_id

        # fixed params from enqueue_trial
        fixed = self._storage.get_trial(trial_id).system_attrs.get("fixed_params")
        if fixed:
            trial._relative_params = dict(fixed)

        hb_stop = self._start_heartbeat(trial_id)
        state = TrialState.COMPLETE
        values: list[float] | None = None
        try:
            raw = func(trial)
            values = [float(v) for v in raw] if isinstance(raw, (list, tuple)) else [float(raw)]
            if any(v != v for v in values):  # NaN objective -> failed trial
                state, values = TrialState.FAIL, None
                self._storage.set_trial_system_attr(trial_id, "fail:exception", "nan objective")
        except TrialPruned as e:
            state = TrialState.PRUNED
            # record the pruned-at value as the final value when available
            frozen = self._storage.get_trial(trial_id)
            last = frozen.last_step
            if last is not None:
                values = [frozen.intermediate_values[last]]
            self._storage.set_trial_system_attr(trial_id, "pruned:reason", str(e) or "pruned")
        except Exception as e:
            state = TrialState.FAIL
            self._storage.set_trial_system_attr(trial_id, "fail:exception", repr(e))
            if not isinstance(e, catch):
                raise
        finally:
            # exactly one finish on every path — including the uncaught-raise
            # path above, which previously risked finishing the trial twice
            self._finish(trial_id, state, values, hb_stop)

        frozen = self._storage.get_trial(trial_id)
        self.sampler.after_trial(self, frozen, state, values)
        if self._records is not None:
            self._records.refresh()  # keep the columnar store warm
        for cb in callbacks:
            cb(self, frozen)
        return frozen

    def _finish(self, trial_id, state, values, hb_stop) -> None:
        if hb_stop is not None:
            hb_stop.set()
        try:
            self._storage.set_trial_state_values(trial_id, state, values)
        except Exception:
            warnings.warn(f"could not persist final state for trial {trial_id}")

    def _start_heartbeat(self, trial_id: int) -> threading.Event | None:
        if self.heartbeat_interval is None:
            return None
        stop = threading.Event()

        def beat():
            while not stop.wait(self.heartbeat_interval):
                try:
                    self._storage.record_heartbeat(trial_id)
                except Exception:
                    pass

        self._storage.record_heartbeat(trial_id)
        threading.Thread(target=beat, daemon=True).start()
        return stop

    # -- fault tolerance -------------------------------------------------------------------

    def fail_stale_trials(self) -> list[int]:
        """Mark RUNNING trials with expired heartbeats as FAILED; returns their
        trial ids.  Call from any worker (or a janitor) to recover from
        worker crashes."""
        return self._storage.fail_stale_trials(self._study_id, self.failed_trial_grace)

    def retry_failed_trials(self) -> int:
        """Re-enqueue failed trials' parameters (at-least-once execution)."""
        n = 0
        for t in self.get_trials(deepcopy=False, states=(TrialState.FAIL,)):
            if t.system_attrs.get("retried"):
                continue
            self._storage.set_trial_system_attr(t.trial_id, "retried", True)
            self.enqueue_trial(dict(t.params), user_attrs={"retry_of": t.number})
            n += 1
        return n

    # -- export ---------------------------------------------------------------------------

    def trials_dataframe(self) -> list[dict[str, Any]]:
        """Rows of plain dicts (pandas-free analogue of the paper's §4 export;
        feed to ``csv.DictWriter`` or pandas if installed)."""
        rows = []
        for t in self.get_trials(deepcopy=False):
            row: dict[str, Any] = {
                "number": t.number,
                "state": t.state.name,
                "value": t.values[0] if t.values else None,
                "datetime_start": t.datetime_start.isoformat() if t.datetime_start else None,
                "datetime_complete": t.datetime_complete.isoformat() if t.datetime_complete else None,
            }
            if t.values is not None and len(t.values) > 1:
                for k, v in enumerate(t.values):
                    row[f"values_{k}"] = v
            for k, v in t.params.items():
                row[f"params_{k}"] = v
            for k, v in t.user_attrs.items():
                row[f"user_attrs_{k}"] = v
            rows.append(row)
        return rows


def _pairwise_best_trials(
    completed: "list[FrozenTrial]", directions: "list[StudyDirection]"
) -> list[FrozenTrial]:
    """The frozen pre-engine Pareto front: the pure-Python pairwise dominance
    loop ``Study.best_trials`` shipped before the columnar multi-objective
    engine existed.  Kept verbatim as the parity reference: the tests pin
    the engine bit-identical to this."""
    completed = [
        t for t in completed
        if t.values is not None and len(t.values) == len(directions)
    ]

    def dominates(a: FrozenTrial, b: FrozenTrial) -> bool:
        better = False
        for av, bv, d in zip(a.values, b.values, directions):
            sa = av if d == StudyDirection.MINIMIZE else -av
            sb = bv if d == StudyDirection.MINIMIZE else -bv
            if sa > sb:
                return False
            if sa < sb:
                better = True
        return better

    return [
        t for t in completed if not any(dominates(o, t) for o in completed if o is not t)
    ]


def create_study(
    study_name: str | None = None,
    storage: "str | BaseStorage | None" = None,
    sampler: BaseSampler | None = None,
    pruner: BasePruner | None = None,
    direction: "str | StudyDirection" = "minimize",
    directions: "Sequence[str | StudyDirection] | None" = None,
    load_if_exists: bool = False,
    engine: str = "auto",
    device: "str | None" = None,
) -> Study:
    backend = get_storage(storage)
    if directions is None:
        directions = [direction]
    dirs = [
        d if isinstance(d, StudyDirection) else StudyDirection[d.upper()] for d in directions
    ]
    if study_name is None:
        study_name = f"study-{datetime.datetime.now().strftime('%Y%m%d-%H%M%S-%f')}"
    try:
        backend.create_new_study(dirs, study_name)
    except DuplicatedStudyError:
        if not load_if_exists:
            raise
    return Study(
        study_name, backend, sampler=sampler, pruner=pruner, engine=engine, device=device
    )


def load_study(
    study_name: str,
    storage: "str | BaseStorage",
    sampler: BaseSampler | None = None,
    pruner: BasePruner | None = None,
    engine: str = "auto",
    device: "str | None" = None,
) -> Study:
    return Study(
        study_name, get_storage(storage), sampler=sampler, pruner=pruner,
        engine=engine, device=device,
    )


def delete_study(study_name: str, storage: "str | BaseStorage") -> None:
    backend = get_storage(storage)
    backend.delete_study(backend.get_study_id_from_name(study_name))
