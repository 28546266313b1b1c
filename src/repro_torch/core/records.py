"""Columnar observation + intermediate-value stores — the array substrate
shared by the sampler *and* pruner stacks.

Before this module existed, every ``ask`` re-materialized the full trial
history as Python ``FrozenTrial`` lists and looped per-parameter in scalar
numpy — O(trials x params) interpreter work per trial.  The
:class:`ObservationStore` replaces that with an incrementally-maintained
structure-of-arrays view of *finished* trials:

* one ``(n_trials, n_params)`` float64 matrix in **model space**
  (log-transformed numerics / categorical indices; see
  ``BaseDistribution.to_internal``), NaN where a trial did not suggest a
  parameter (define-by-run conditionals),
* aligned ``numbers`` / ``states`` / ``values`` (first objective) /
  ``last_intermediate_values`` vectors.

Maintenance is incremental and storage-agnostic:

* ``refresh()`` first polls the storage's monotonic **revision counter**
  (``get_trials_revision``) — if nothing changed since the last look, the
  refresh is O(1) and touches no trial data,
* otherwise it fetches only the suffix ``number >= watermark`` via
  ``get_all_trials(since=...)`` (the same hook :class:`CachedStorage` uses,
  so the two compose: through a cached remote backend a refresh is at most
  one revision RPC),
* finished trials are immutable (BaseStorage contract), so each is encoded
  into the matrix exactly once, O(n_params) amortized per ``Study.tell``.

Out-of-order finishes (trial #5 completing before #3) are appended as they
arrive; the number-sorted view is re-materialized lazily, only when new rows
landed.  Returned arrays are read-only views shared between callers — never
mutate them.

The :class:`IntermediateValueStore` is the pruner-side sibling: an
``(n_trials, n_steps)`` NaN-padded matrix of reported intermediate values
(rows indexed by trial number — dense by the storage contract — columns by a
sorted side table of distinct steps, so sparse/irregular step grids cost only
the columns they use), plus aligned ``states`` / ``trial_ids`` vectors and
lazily-cached best-so-far prefix matrices (``fmin.accumulate`` /
``fmax.accumulate`` along the step axis).  Unlike the observation store it
must track *live* RUNNING trials — their rows are rewritten on refresh —
so its revision gate is the whole optimization: when ``get_trials_revision``
is unchanged a refresh is O(1), otherwise only the suffix past the dense
finished prefix is refetched and re-encoded.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING

import numpy as np

from . import telemetry
from .frozen import IV_VEC_PREFIX, TrialState
from .storage.base import get_trials_since

if TYPE_CHECKING:
    from .distributions import BaseDistribution
    from .storage.base import BaseStorage

__all__ = ["ObservationStore", "IntermediateValueStore"]

_MIN_CAPACITY = 32

#: system-attr key the grid sampler claims cells under (imported by
#: ``samplers/grid.py``); ingested as a dedicated column so ``_taken`` is a
#: vector op over finished trials instead of a FrozenTrial walk
_GRID_ATTR = "grid_sampler:grid_id"


def _poll_revision(store) -> "int | None":
    """Shared revision-gate probe for both columnar stores.

    Returns the storage's current per-study revision, or None when the
    backend does not support one (the probe downgrades
    ``store._revision_supported`` permanently on the first
    ``NotImplementedError``/missing method, so later refreshes skip the
    call).  Callers MUST read the revision *before* reading trial data:
    writes landing between the two reads then surface as a fresh revision on
    the next refresh instead of being lost."""
    if store._revision_supported:
        get_rev = getattr(store._storage, "get_trials_revision", None)
        if get_rev is None:
            store._revision_supported = False
        else:
            try:
                return get_rev(store._study_id)
            except NotImplementedError:
                store._revision_supported = False
    return None


class ObservationStore:
    def __init__(self, storage: "BaseStorage", study_id: int):
        self._storage = storage
        self._study_id = study_id
        self._lock = threading.RLock()

        self._n = 0
        self._capacity = 0
        self._numbers = np.empty(0, dtype=np.int64)
        self._states = np.empty(0, dtype=np.int64)
        self._values = np.empty(0)
        # multi-objective values: (capacity, n_objectives) NaN-padded matrix
        # plus a per-row arity column (len(trial.values); 0 when absent) so
        # the Pareto engine can exclude wrong-arity rows exactly like the
        # frozen pairwise loop did.  n_objectives comes from the study's
        # directions, fetched once on first refresh.
        self._n_objectives: "int | None" = None
        self._values_mat = np.empty((0, 0))
        self._values_len = np.empty(0, dtype=np.int64)
        self._last_iv = np.empty(0)
        self._grid_ids = np.empty(0, dtype=np.int64)
        self._cols: dict[str, np.ndarray] = {}
        self._dists: dict[str, "BaseDistribution"] = {}
        # distribution-type tracking for the vectorized intersection space:
        # per-param int8 row of type codes (-1 = not suggested), a type->code
        # registry, and the latest distribution per (name, code, state)
        self._type_rows: dict[str, np.ndarray] = {}
        self._type_codes: dict[type, int] = {}
        self._latest_dist: dict[tuple, tuple[int, "BaseDistribution"]] = {}

        self._watermark = 0          # every number < watermark is ingested
        self._finished: set[int] = set()  # ingested numbers >= watermark
        self._revision: int | None = None
        self._revision_supported = True
        # columnar block fetch (wire protocol v2): downgraded permanently on
        # the first NotImplementedError, exactly like the revision probe
        self._block_supported = True

        self._dirty = False
        self._view_numbers = self._numbers
        self._view_states = self._states
        self._view_values = self._values
        self._view_values_mat = self._values_mat
        self._view_values_len = self._values_len
        self._view_last_iv = self._last_iv
        self._view_grid_ids = self._grid_ids
        self._view_cols: dict[str, np.ndarray] = {}
        self._view_type_rows: dict[str, np.ndarray] = {}

        #: bumped whenever new observations land; samplers key caches on it
        self.version = 0

    # -- maintenance -----------------------------------------------------------

    def refresh(self) -> None:
        """Bring the store up to date with storage.  O(1) when the storage
        revision is unchanged; otherwise one incremental suffix fetch."""
        with self._lock:
            rev = _poll_revision(self)
            if rev is not None and rev == self._revision:
                telemetry.inc("records.obs.refresh.noop")
                return
            telemetry.inc("records.obs.refresh.fetch")
            if self._n_objectives is None:
                # directions are immutable after study creation: one fetch
                # sizes the values matrix for the store's whole lifetime
                self._n_objectives = len(
                    self._storage.get_study_directions(self._study_id)
                )
                self._values_mat = np.full((self._capacity, self._n_objectives), np.nan)
                self._view_values_mat = self._values_mat[:0]
            if self._block_supported and getattr(
                self._storage, "supports_block_fetch", False
            ):
                try:
                    block = self._storage.get_observation_block(
                        self._study_id, self._watermark
                    )
                except NotImplementedError:
                    self._block_supported = False
                else:
                    telemetry.inc("records.obs.refresh.block")
                    self._ingest_block(block)
                    while self._watermark in self._finished:
                        self._finished.discard(self._watermark)
                        self._watermark += 1
                    self._revision = rev
                    return
            fresh = get_trials_since(
                self._storage, self._study_id, self._watermark, deepcopy=False
            )
            for t in fresh:
                if not t.state.is_finished() or t.number in self._finished:
                    continue
                self._append(t)
            while self._watermark in self._finished:
                self._finished.discard(self._watermark)
                self._watermark += 1
            self._revision = rev

    def _ingest_block(self, block: dict) -> None:
        """Ingest a ``get_observation_block`` payload — the same per-row
        writes :meth:`_append` performs, but fed from contiguous wire arrays
        (model-space internals computed server-side) instead of FrozenTrial
        objects, so a remote refresh decodes no JSON trial dicts at all."""
        n = int(block["n"])
        if n == 0:
            return
        from .distributions import json_to_distribution

        numbers, states = block["numbers"], block["states"]
        values, values_len = block["values"], block["values_len"]
        values_mat, last_iv = block["values_mat"], block["last_iv"]
        grid_ids = block["grid_ids"]
        m = self._values_mat.shape[1]
        mat_ok = values_mat.ndim == 2 and values_mat.shape[1] == m
        # interned distributions decode once per block, not once per row
        params = [
            (name, ent["internal"], ent["dist_idx"],
             [json_to_distribution(s) for s in ent["dists"]])
            for name, ent in block["params"].items()
        ]
        complete, pruned = int(TrialState.COMPLETE), int(TrialState.PRUNED)
        for i in range(n):
            num = int(numbers[i])
            if num in self._finished:
                continue
            if self._n == self._capacity:
                self._grow(max(_MIN_CAPACITY, 2 * self._capacity))
            row = self._n
            self._numbers[row] = num
            st = int(states[i])
            self._states[row] = st
            self._values[row] = values[i]
            self._values_len[row] = int(values_len[i])
            if mat_ok and int(values_len[i]) == m:
                self._values_mat[row, :] = values_mat[i]
            self._last_iv[row] = last_iv[i]
            self._grid_ids[row] = int(grid_ids[i])
            for name, internal, dist_idx, dists in params:
                di = int(dist_idx[i])
                if di < 0:
                    continue
                dist = dists[di]
                col = self._cols.get(name)
                if col is None:
                    col = np.full(self._capacity, np.nan)
                    self._cols[name] = col
                col[row] = internal[i]
                self._dists[name] = dist
                code = self._type_codes.setdefault(type(dist), len(self._type_codes))
                trow = self._type_rows.get(name)
                if trow is None:
                    trow = np.full(self._capacity, -1, dtype=np.int8)
                    self._type_rows[name] = trow
                trow[row] = code
                if st in (complete, pruned):
                    key = (name, code, st)
                    prev = self._latest_dist.get(key)
                    if prev is None or num > prev[0]:
                        self._latest_dist[key] = (num, dist)
            self._n += 1
            self._finished.add(num)
            self._dirty = True
            self.version += 1

    def _append(self, trial) -> None:
        if self._n == self._capacity:
            self._grow(max(_MIN_CAPACITY, 2 * self._capacity))
        row = self._n
        self._numbers[row] = trial.number
        self._states[row] = int(trial.state)
        self._values[row] = trial.values[0] if trial.values else np.nan
        vals = trial.values or []
        self._values_len[row] = len(vals)
        m = self._values_mat.shape[1]
        if len(vals) == m:
            self._values_mat[row, :] = vals
        # wrong-arity rows stay NaN: the Pareto engine excludes them via the
        # arity column, matching the frozen pairwise loop's length filter
        last = trial.last_step
        self._last_iv[row] = (
            trial.intermediate_values[last] if last is not None else np.nan
        )
        gid = trial.system_attrs.get(_GRID_ATTR)
        self._grid_ids[row] = int(gid) if gid is not None else -1
        for name, dist in trial.distributions.items():
            col = self._cols.get(name)
            if col is None:
                col = np.full(self._capacity, np.nan)
                self._cols[name] = col
            col[row] = float(dist.to_internal([trial.params[name]])[0])
            self._dists[name] = dist
            code = self._type_codes.setdefault(type(dist), len(self._type_codes))
            trow = self._type_rows.get(name)
            if trow is None:
                trow = np.full(self._capacity, -1, dtype=np.int8)
                self._type_rows[name] = trow
            trow[row] = code
            if trial.state in (TrialState.COMPLETE, TrialState.PRUNED):
                key = (name, code, int(trial.state))
                prev = self._latest_dist.get(key)
                if prev is None or trial.number > prev[0]:
                    self._latest_dist[key] = (trial.number, dist)
        self._n += 1
        self._finished.add(trial.number)
        self._dirty = True
        self.version += 1

    def _grow(self, capacity: int) -> None:
        def enlarge(arr: np.ndarray, fill) -> np.ndarray:
            out = np.full(capacity, fill, dtype=arr.dtype)
            out[: self._n] = arr[: self._n]
            return out

        self._numbers = enlarge(self._numbers, 0)
        self._states = enlarge(self._states, 0)
        self._values = enlarge(self._values, np.nan)
        self._values_len = enlarge(self._values_len, 0)
        m = self._values_mat.shape[1]
        vmat = np.full((capacity, m), np.nan)
        vmat[: self._n] = self._values_mat[: self._n]
        self._values_mat = vmat
        self._last_iv = enlarge(self._last_iv, np.nan)
        self._grid_ids = enlarge(self._grid_ids, -1)
        for name in self._cols:
            self._cols[name] = enlarge(self._cols[name], np.nan)
        for name in self._type_rows:
            self._type_rows[name] = enlarge(self._type_rows[name], -1)
        self._capacity = capacity

    def _materialize(self) -> None:
        if not self._dirty:
            return
        n = self._n
        order = np.argsort(self._numbers[:n], kind="stable")

        def view(arr: np.ndarray) -> np.ndarray:
            out = arr[:n][order]
            out.flags.writeable = False
            return out

        self._view_numbers = view(self._numbers)
        self._view_states = view(self._states)
        self._view_values = view(self._values)
        self._view_values_mat = view(self._values_mat)
        self._view_values_len = view(self._values_len)
        self._view_last_iv = view(self._last_iv)
        self._view_grid_ids = view(self._grid_ids)
        self._view_cols = {name: view(col) for name, col in self._cols.items()}
        self._view_type_rows = {
            name: view(row) for name, row in self._type_rows.items()
        }
        self._dirty = False

    # -- columnar accessors (all number-ordered, read-only) ---------------------

    @property
    def n_observations(self) -> int:
        with self._lock:
            return self._n

    @property
    def numbers(self) -> np.ndarray:
        with self._lock:
            self._materialize()
            return self._view_numbers

    @property
    def states(self) -> np.ndarray:
        with self._lock:
            self._materialize()
            return self._view_states

    @property
    def values(self) -> np.ndarray:
        """First objective value per finished trial (NaN when absent)."""
        with self._lock:
            self._materialize()
            return self._view_values

    @property
    def n_objectives(self) -> "int | None":
        """Number of study objectives (None until the first refresh)."""
        with self._lock:
            return self._n_objectives

    @property
    def values_matrix(self) -> np.ndarray:
        """``(n_trials, n_objectives)`` matrix of final objective vectors,
        number-ordered.  Rows are NaN where the trial carried no values or a
        wrong-arity vector (see :attr:`values_arity`) — the substrate of the
        multi-objective engine (``core/moo.py``)."""
        with self._lock:
            self._materialize()
            return self._view_values_mat

    @property
    def values_arity(self) -> np.ndarray:
        """``len(trial.values)`` per finished trial (0 when absent).  The
        Pareto engine masks on ``values_arity == n_objectives`` to reproduce
        the frozen pairwise loop's length filter exactly."""
        with self._lock:
            self._materialize()
            return self._view_values_len

    @property
    def last_intermediate_values(self) -> np.ndarray:
        with self._lock:
            self._materialize()
            return self._view_last_iv

    @property
    def grid_ids(self) -> np.ndarray:
        """Grid-sampler cell ids per finished trial (-1 where unclaimed)."""
        with self._lock:
            self._materialize()
            return self._view_grid_ids

    def intersection_space(
        self, include_pruned: bool = False
    ) -> "dict[str, BaseDistribution]":
        """The intersection search space over finished trials, as one vector
        op per parameter: a parameter survives iff its type-code row has no
        -1 (absent) and a single code across the state mask; the returned
        distribution is the one from the highest-numbered included trial
        (bounds may drift).  Semantics match
        ``search_space.intersection_search_space``."""
        with self._lock:
            self._materialize()
            states = self._view_states
            mask = states == int(TrialState.COMPLETE)
            allowed = [TrialState.COMPLETE]
            if include_pruned:
                mask = mask | (states == int(TrialState.PRUNED))
                allowed.append(TrialState.PRUNED)
            if not bool(mask.any()):
                return {}
            out: dict[str, "BaseDistribution"] = {}
            for name, trow in self._view_type_rows.items():
                codes = trow[mask]
                code = int(codes[0])
                if code < 0 or bool((codes != code).any()):
                    continue
                cands = [
                    ent
                    for st in allowed
                    if (ent := self._latest_dist.get((name, code, int(st))))
                ]
                if cands:
                    out[name] = max(cands, key=lambda e: e[0])[1]
            return dict(sorted(out.items()))

    def co_occurrence(
        self, names: "list[str] | None" = None, include_pruned: bool = True
    ) -> tuple[list[str], np.ndarray]:
        """``(names, mask)`` where ``mask[i, j]`` is True iff parameters
        ``names[i]`` and ``names[j]`` were both suggested by at least one
        observed trial — the relation whose connected components are the
        joint-sampling groups (see ``search_space.observed_groups``).

        Computed as one boolean matmul over the store's dist-type rows
        (presence = type code >= 0), restricted to COMPLETE (and by default
        PRUNED) trials so the grouping matches the observations samplers
        actually model."""
        with self._lock:
            self._materialize()
            names = self.param_names() if names is None else list(names)
            if not names or self._n == 0:
                return names, np.zeros((len(names), len(names)), dtype=bool)
            states = self._view_states
            mask = states == int(TrialState.COMPLETE)
            if include_pruned:
                mask = mask | (states == int(TrialState.PRUNED))
            absent = np.full(self._n, -1, dtype=np.int8)
            present = np.stack(
                [self._view_type_rows.get(n, absent) >= 0 for n in names], axis=1
            )
            present = present & mask[:, None]
            p = present.astype(np.int64)
            return names, (p.T @ p) > 0

    def snapshot(self) -> tuple:
        """``(version, states, values, last_intermediate_values, cols)`` as
        one **consistent** set of number-ordered read-only views, taken under
        a single lock acquisition.  Concurrent refreshes replace the view
        arrays and the column dict wholesale (never mutate them), so a
        caller holding a snapshot keeps seeing one coherent history even
        while other threads tell new trials — mixing individual property
        reads across a refresh does not have that guarantee."""
        with self._lock:
            self._materialize()
            return (
                self.version,
                self._view_states,
                self._view_values,
                self._view_last_iv,
                self._view_cols,
            )

    def snapshot_mo(self) -> tuple:
        """Multi-objective sibling of :meth:`snapshot`: ``(version, states,
        values_matrix, values_arity, numbers, cols)`` as one consistent set
        of number-ordered read-only views under a single lock acquisition —
        mixing individual property reads across a concurrent refresh could
        pair a stale mask with a re-sorted matrix."""
        with self._lock:
            self._materialize()
            return (
                self.version,
                self._view_states,
                self._view_values_mat,
                self._view_values_len,
                self._view_numbers,
                self._view_cols,
            )

    def param_names(self) -> list[str]:
        with self._lock:
            return sorted(self._cols)

    def column(self, name: str) -> "np.ndarray | None":
        """Model-space values of one parameter (NaN where not suggested)."""
        with self._lock:
            self._materialize()
            return self._view_cols.get(name)

    def distribution(self, name: str) -> "BaseDistribution | None":
        with self._lock:
            return self._dists.get(name)

    def matrix(self, names: "list[str] | None" = None) -> np.ndarray:
        """The ``(n_trials, n_params)`` model-space matrix (NaN = missing)."""
        with self._lock:
            self._materialize()
            names = self.param_names() if names is None else names
            if not names:
                return np.empty((self._n, 0))
            cols = [
                self._view_cols.get(n, np.full(self._n, np.nan)) for n in names
            ]
            return np.stack(cols, axis=1) if self._n else np.empty((0, len(names)))

    def design_matrix(self, names: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """``(X, y)`` over COMPLETE trials that carry a value and suggested
        every parameter in ``names`` — the rows relational samplers (CMA-ES,
        GP) train on, straight from the store with no re-encoding."""
        with self._lock:
            self._materialize()
            mask = (self._view_states == int(TrialState.COMPLETE)) & ~np.isnan(
                self._view_values
            )
            cols = []
            for name in names:
                col = self._view_cols.get(name)
                if col is None:
                    return np.empty((0, len(names))), np.empty(0)
                mask = mask & ~np.isnan(col)
                cols.append(col)
            if not names:
                return np.empty((int(mask.sum()), 0)), self._view_values[mask]
            X = np.stack([c[mask] for c in cols], axis=1)
            return X, self._view_values[mask]


class IntermediateValueStore:
    """Revision-gated ``(n_trials, n_steps)`` matrix of reported values.

    * Rows are indexed directly by trial ``number`` (dense per the storage
      contract); columns by a sorted side table of the distinct steps seen so
      far, so sparse or irregular step grids (rungs 1, 2, 4, 8, ...) cost
      only the columns they use.  Cells are NaN where nothing was reported.
    * ``states`` / ``trial_ids`` vectors are aligned with the rows; rows not
      yet observed carry state -1 so every pruner mask excludes them.
    * ``best_so_far(minimize)`` caches the NaN-ignoring prefix-best matrix
      (``np.fmin/fmax.accumulate`` over the step axis) — the array the
      percentile pruners slice one column out of per decision.
    * ``refresh()`` is O(1) when the storage's ``get_trials_revision`` is
      unchanged; otherwise it refetches only ``number >= watermark``, where
      the watermark advances over the dense *finished* prefix (finished
      trials are immutable, so their rows are never rewritten; RUNNING rows
      are re-encoded each refresh because their dicts mutate in place).

    Every backend hosts one instance per study for the fused
    ``report_and_prune`` storage op; ``Study.intermediate_values()`` exposes
    a client-side one for direct ``pruner.prune`` calls.  Readers that slice
    several arrays must do so inside ``with store.lock():`` for a torn-free
    snapshot.
    """

    def __init__(self, storage: "BaseStorage", study_id: int, track_dirty: bool = False):
        self._storage = storage
        self._study_id = study_id
        self._lock = threading.RLock()

        self._n_rows = 0
        self._row_cap = 0
        self._steps = np.empty(0, dtype=np.int64)  # sorted distinct steps
        self._step_index: dict[int, int] = {}
        self._matrix = np.empty((0, 0))
        self._states = np.empty(0, dtype=np.int64)
        self._trial_ids = np.empty(0, dtype=np.int64)
        self._row_len = np.empty(0, dtype=np.int64)  # reported values per row
        # per-objective vector reports (multi-objective learning curves):
        # a lazily-created (row_cap, n_steps, n_objectives) tensor plus a
        # per-row arity column (0 = scalar-only trial), mirroring the
        # observation store's values_arity.  Scalar studies never allocate
        # the tensor, so the widened store costs them nothing.
        self._n_obj = 1
        self._vtensor: "np.ndarray | None" = None
        self._iv_arity = np.empty(0, dtype=np.int64)

        self._watermark = 0  # every number < watermark is finished + encoded
        self._revision: int | None = None
        self._revision_supported = True
        self._block_supported = True  # see ObservationStore._block_supported
        self._bsf: dict[bool, np.ndarray] = {}  # minimize? -> prefix-best

        # per-trial dirty tracking (hosted stores only): backends note every
        # intermediate-value write via ``note_dirty``, so a refresh re-encodes
        # only the changed RUNNING rows instead of every row past the
        # watermark.  Rows whose state or report count changed are re-encoded
        # even without a note (covers writers on *other* storage instances —
        # only a same-length step overwrite from a foreign process can hide,
        # and reports are append-per-step in practice).
        self._track_dirty = track_dirty
        self._dirty: set[int] = set()          # row numbers noted changed
        self._dirty_unknown = False            # a note arrived for an unseen id
        self._id_to_row: dict[int, int] = {}
        #: rows (re-)encoded so far — observability hook, pinned by tests
        self.reencode_count = 0

        #: bumped whenever any cell changes; decisions may key caches on it
        self.version = 0

    def lock(self):
        """Context manager for a consistent multi-array read."""
        return self._lock

    # -- maintenance -----------------------------------------------------------

    def note_dirty(self, trial_id: int) -> None:
        """Mark one trial's row as changed (called by backends on every
        intermediate-value write).  O(1); unknown ids — a trial reported
        before this store ever encoded it — set a conservative flag that
        forces the next refresh to re-encode every fetched row."""
        with self._lock:
            row = self._id_to_row.get(trial_id)
            if row is not None:
                self._dirty.add(row)
            else:
                self._dirty_unknown = True

    def refresh(self) -> None:
        with self._lock:
            rev = _poll_revision(self)
            if (
                rev is not None and rev == self._revision
                and not self._dirty and not self._dirty_unknown
            ):
                # a note may land *after* the write it describes was already
                # fetched under this revision — the dirty check above keeps
                # that row from going stale until the next unrelated mutation
                telemetry.inc("records.iv.refresh.noop")
                return
            telemetry.inc("records.iv.refresh.fetch")
            if self._block_supported and getattr(
                self._storage, "supports_block_fetch", False
            ):
                try:
                    block = self._storage.get_iv_block(self._study_id, self._watermark)
                except NotImplementedError:
                    self._block_supported = False
                else:
                    telemetry.inc("records.iv.refresh.block")
                    self._ingest_block(block)
                    self._revision = rev
                    return
            fresh = get_trials_since(
                self._storage, self._study_id, self._watermark, deepcopy=False
            )
            if fresh:
                self._ingest(fresh)
            else:
                # nothing at/after the watermark: any noted row is finished
                # (immutable), so the dirty state carries no information —
                # clear it or a spurious note would pin refreshes forever
                self._dirty.clear()
                self._dirty_unknown = False
            self._revision = rev

    def _ingest_block(self, block: dict) -> None:
        """Ingest a ``get_iv_block`` CSR payload — the same row writes
        :meth:`_ingest` performs, but cell placement is one vectorized
        ``searchsorted`` scatter per row instead of a Python dict walk."""
        n = int(block["n"])
        if n == 0:
            self._dirty.clear()
            self._dirty_unknown = False
            return
        numbers, states = block["numbers"], block["states"]
        trial_ids, rowptr = block["trial_ids"], block["rowptr"]
        steps, vals = block["steps"], block["vals"]
        top = int(numbers.max())
        if top >= self._row_cap:
            self._grow_rows(max(_MIN_CAPACITY, 2 * self._row_cap, top + 1))
        self._n_rows = max(self._n_rows, top + 1)

        # optional per-objective vector columns (flat CSR keyed by trial
        # number): absent entirely on scalar studies — see build_iv_block
        vec_map: dict[int, list] = {}
        vec_numbers = block.get("vec_numbers")
        if vec_numbers is not None and len(vec_numbers):
            vec_steps, vec_ptr = block["vec_steps"], block["vec_ptr"]
            vec_vals = block["vec_vals"]
            for j in range(len(vec_numbers)):
                lo, hi = int(vec_ptr[j]), int(vec_ptr[j + 1])
                vec_map.setdefault(int(vec_numbers[j]), []).append(
                    (int(vec_steps[j]), vec_vals[lo:hi])
                )

        skip_clean = self._track_dirty and not self._dirty_unknown
        sel = []
        for i in range(n):
            row = int(numbers[i])
            cnt = int(rowptr[i + 1] - rowptr[i])
            if (
                skip_clean
                and row not in self._dirty
                and self._states[row] == int(states[i])
                and self._row_len[row] == cnt
            ):
                continue  # clean RUNNING row: state and report count unchanged
            sel.append(i)

        new_steps = {
            int(s)
            for i in sel
            for s in steps[int(rowptr[i]) : int(rowptr[i + 1])]
            if int(s) not in self._step_index
        }
        for i in sel:
            for s, _ in vec_map.get(int(numbers[i]), ()):
                if s not in self._step_index:
                    new_steps.add(s)
        if new_steps:
            self._grow_cols(new_steps)

        for i in sel:
            row = int(numbers[i])
            tid = int(trial_ids[i])
            self._states[row] = int(states[i])
            self._trial_ids[row] = tid
            self._id_to_row[tid] = row
            self._matrix[row, :] = np.nan
            lo, hi = int(rowptr[i]), int(rowptr[i + 1])
            if hi > lo:
                self._matrix[row, np.searchsorted(self._steps, steps[lo:hi])] = vals[lo:hi]
            self._row_len[row] = hi - lo
            vitems = vec_map.get(row)
            if vitems:
                self._ensure_objectives(max(len(v) for _, v in vitems))
                self._vtensor[row, :, :] = np.nan
                for s, v in vitems:
                    self._vtensor[row, self._step_index[s], : len(v)] = v
                self._iv_arity[row] = max(len(v) for _, v in vitems)
            elif self._vtensor is not None and self._iv_arity[row]:
                self._vtensor[row, :, :] = np.nan
                self._iv_arity[row] = 0
            self.reencode_count += 1
        self._dirty.clear()
        self._dirty_unknown = False
        if sel:
            telemetry.inc("records.iv.rows_reencoded", len(sel))
        while self._watermark < self._n_rows and TrialState(
            self._states[self._watermark]
        ).is_finished():
            self._watermark += 1
        if sel:
            self._bsf.clear()
            self.version += 1

    def _ingest(self, trials) -> None:
        top = max(t.number for t in trials)
        if top >= self._row_cap:
            self._grow_rows(max(_MIN_CAPACITY, 2 * self._row_cap, top + 1))
        self._n_rows = max(self._n_rows, top + 1)

        # deepcopy=False feeds live dict refs on in-process backends: a
        # concurrent report can mutate mid-iteration, so snapshot with retry
        def snapshot(t) -> list:
            for _ in range(3):
                try:
                    return list(t.intermediate_values.items())
                except RuntimeError:  # pragma: no cover - dict-resize race
                    continue
            return list(t.intermediate_values.items())

        # per-objective vectors ride on iv_vec:<step> system attrs -> same
        # live-dict snapshot policy as the scalar reports above
        def vec_snapshot(t) -> list:
            for _ in range(3):
                try:
                    return [
                        (int(k[len(IV_VEC_PREFIX):]), [float(x) for x in v])
                        for k, v in t.system_attrs.items()
                        if isinstance(k, str) and k.startswith(IV_VEC_PREFIX)
                    ]
                except (RuntimeError, TypeError, ValueError):  # pragma: no cover
                    continue
            return []

        rows = []
        skip_clean = self._track_dirty and not self._dirty_unknown
        for t in trials:
            row = t.number
            if (
                skip_clean
                and row not in self._dirty
                and self._states[row] == int(t.state)  # -1 (never encoded) differs
                and self._row_len[row] == len(t.intermediate_values)
            ):
                continue  # clean RUNNING row: state and report count unchanged
            rows.append((row, t, snapshot(t), vec_snapshot(t)))

        new_steps = set()
        for _, _, items, vec_items in rows:
            for s, _ in items:
                if int(s) not in self._step_index:
                    new_steps.add(int(s))
            for s, _ in vec_items:
                if int(s) not in self._step_index:
                    new_steps.add(int(s))
        if new_steps:
            self._grow_cols(new_steps)

        for row, t, items, vec_items in rows:
            self._states[row] = int(t.state)
            self._trial_ids[row] = t.trial_id
            self._id_to_row[t.trial_id] = row
            self._matrix[row, :] = np.nan
            for s, v in items:
                self._matrix[row, self._step_index[int(s)]] = v
            self._row_len[row] = len(items)
            if vec_items:
                self._ensure_objectives(max(len(v) for _, v in vec_items))
                self._vtensor[row, :, :] = np.nan
                for s, v in vec_items:
                    self._vtensor[row, self._step_index[int(s)], : len(v)] = v
                self._iv_arity[row] = max(len(v) for _, v in vec_items)
            elif self._vtensor is not None and self._iv_arity[row]:
                self._vtensor[row, :, :] = np.nan
                self._iv_arity[row] = 0
            self.reencode_count += 1
        self._dirty.clear()
        self._dirty_unknown = False
        if rows:
            telemetry.inc("records.iv.rows_reencoded", len(rows))
        while self._watermark < self._n_rows and TrialState(
            self._states[self._watermark]
        ).is_finished():
            self._watermark += 1
        if rows:
            self._bsf.clear()
            self.version += 1

    def _grow_rows(self, capacity: int) -> None:
        n_cols = self._matrix.shape[1]
        matrix = np.full((capacity, n_cols), np.nan)
        matrix[: self._n_rows] = self._matrix[: self._n_rows]
        self._matrix = matrix
        if self._vtensor is not None:
            vt = np.full((capacity, n_cols, self._n_obj), np.nan)
            vt[: self._n_rows] = self._vtensor[: self._n_rows]
            self._vtensor = vt

        def enlarge(arr: np.ndarray, fill) -> np.ndarray:
            out = np.full(capacity, fill, dtype=arr.dtype)
            out[: self._n_rows] = arr[: self._n_rows]
            return out

        self._states = enlarge(self._states, -1)
        self._trial_ids = enlarge(self._trial_ids, -1)
        self._row_len = enlarge(self._row_len, 0)
        self._iv_arity = enlarge(self._iv_arity, 0)
        self._row_cap = capacity

    def _grow_cols(self, new_steps: set) -> None:
        steps = np.asarray(
            sorted(set(self._steps.tolist()) | new_steps), dtype=np.int64
        )
        matrix = np.full((self._row_cap, len(steps)), np.nan)
        if self._steps.size:
            matrix[:, np.searchsorted(steps, self._steps)] = self._matrix
        if self._vtensor is not None:
            vt = np.full((self._row_cap, len(steps), self._n_obj), np.nan)
            if self._steps.size:
                vt[:, np.searchsorted(steps, self._steps), :] = self._vtensor
            self._vtensor = vt
        self._matrix = matrix
        self._steps = steps
        self._step_index = {int(s): j for j, s in enumerate(steps)}

    def _ensure_objectives(self, arity: int) -> None:
        """Widen (or create) the per-objective tensor to ``arity`` slots."""
        if arity <= self._n_obj and self._vtensor is not None:
            return
        n_obj = max(arity, self._n_obj)
        vt = np.full((self._row_cap, self._matrix.shape[1], n_obj), np.nan)
        if self._vtensor is not None:
            vt[:, :, : self._n_obj] = self._vtensor
        self._vtensor = vt
        self._n_obj = n_obj

    # -- accessors (hold ``lock()`` across multi-array reads) -------------------

    @staticmethod
    def _ro(arr: np.ndarray) -> np.ndarray:
        """Read-only view: these buffers are long-lived and shared across
        every decision on the backend — a caller mutating one would corrupt
        peer data for all subsequent prunes (same policy as the
        ObservationStore views)."""
        out = arr.view()
        out.flags.writeable = False
        return out

    @property
    def n_rows(self) -> int:
        with self._lock:
            return self._n_rows

    @property
    def steps(self) -> np.ndarray:
        with self._lock:
            return self._ro(self._steps)

    @property
    def states(self) -> np.ndarray:
        with self._lock:
            return self._ro(self._states[: self._n_rows])

    @property
    def trial_ids(self) -> np.ndarray:
        with self._lock:
            return self._ro(self._trial_ids[: self._n_rows])

    @property
    def matrix(self) -> np.ndarray:
        with self._lock:
            return self._ro(self._matrix[: self._n_rows])

    @property
    def n_objectives(self) -> int:
        """Widest vector arity seen so far (1 while scalar-only)."""
        with self._lock:
            return self._n_obj if self._vtensor is not None else 1

    @property
    def iv_arity(self) -> np.ndarray:
        """Per-row vector arity (0 = scalar-only reports), aligned with
        :attr:`states` — the IV sibling of ``ObservationStore.values_arity``."""
        with self._lock:
            return self._ro(self._iv_arity[: self._n_rows])

    def objective_matrix(self, objective: int = 0) -> np.ndarray:
        """One objective's ``(n_trials, n_steps)`` learning-curve matrix.

        Rows that reported vectors read from the per-objective tensor; rows
        that reported plain scalars fall back to the scalar matrix for
        ``objective == 0`` (a scalar report *is* objective 0) and stay NaN
        for higher objectives.  Note the scalar matrix itself is not that
        fallback for vector rows — there it holds the pruner-facing
        scalarized loss."""
        objective = int(objective)
        with self._lock:
            n = self._n_rows
            if self._vtensor is None:
                if objective == 0:
                    return self._ro(self._matrix[:n])
                return self._ro(np.full((n, self._matrix.shape[1]), np.nan))
            if objective >= self._n_obj:
                return self._ro(np.full((n, self._matrix.shape[1]), np.nan))
            out = self._vtensor[:n, :, objective].copy()
            if objective == 0:
                scalar_rows = self._iv_arity[:n] == 0
                out[scalar_rows] = self._matrix[:n][scalar_rows]
            out.flags.writeable = False
            return out

    def step_index(self, step: int) -> "int | None":
        """Column of exactly ``step``, or None if never reported."""
        with self._lock:
            return self._step_index.get(int(step))

    def index_upto(self, step: int) -> int:
        """Column of the largest recorded step <= ``step`` (-1 if none)."""
        with self._lock:
            return int(np.searchsorted(self._steps, int(step), side="right")) - 1

    def step_column(self, step: int) -> "np.ndarray | None":
        """All trials' values at exactly ``step`` (NaN where unreported)."""
        with self._lock:
            j = self._step_index.get(int(step))
            return self._ro(self._matrix[: self._n_rows, j]) if j is not None else None

    def best_so_far(self, minimize: bool) -> np.ndarray:
        """Prefix-best matrix: cell (i, j) is trial i's best reported value
        over steps[0..j], ignoring NaN reports (NaN iff none reported)."""
        with self._lock:
            cached = self._bsf.get(minimize)
            if cached is None:
                op = np.fmin if minimize else np.fmax
                cached = op.accumulate(self._matrix[: self._n_rows], axis=1)
                cached.flags.writeable = False
                self._bsf[minimize] = cached
            return cached
