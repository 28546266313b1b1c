"""Columnar plot reductions for the live analytics service (paper §4's
web-dashboard criterion).

Every dashboard view is computed here as an array reduction over the
columnar stores (``core/records.py``) — no ``FrozenTrial`` walks:

* optimization history — running-best prefix scan over the COMPLETE mask
  (:func:`running_best`),
* contour — 2-D grid binning of the objective over two model-space
  parameter columns, best value per cell (:func:`contour_reduction`),
* slice — per-parameter scatter plus binned quantile band
  (:func:`slice_reduction`),
* Pareto front — front mask from the multi-objective engine
  (``core/moo.pareto_front_mask``),
* learning curves — rows of the intermediate-value matrix, per objective on
  vector-reporting studies.

Randomized parity tests against brute-force per-trial reference loops live
in ``tests/test_torch_analytics.py``.

:class:`StudyAnalytics` wraps one study with payload caches keyed on the
stores' version counters, so an idle study renders for free; the
:class:`RevisionPoller` is the one revision-gated poll loop shared by
``dashboard --live`` and the HTTP service (``serve/dashboard_service.py``).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Iterable

import numpy as np

from . import moo, telemetry
from .frozen import TrialState
from .importance import fanova_importances, spearman_importances

if TYPE_CHECKING:
    from .records import IntermediateValueStore
    from .study import Study

__all__ = [
    "RevisionPoller",
    "StudyAnalytics",
    "running_best",
    "contour_reduction",
    "slice_reduction",
    "learning_curves",
    "jsonable",
]

_COMPLETE = int(TrialState.COMPLETE)


def jsonable(obj: Any) -> Any:
    """Strict-JSON-safe conversion: numpy scalars/arrays to native Python,
    non-finite floats to ``None`` (browser ``JSON.parse`` rejects NaN)."""
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return f if math.isfinite(f) else None
    if isinstance(obj, (np.integer, int)) and not isinstance(obj, bool):
        return int(obj)
    if isinstance(obj, np.ndarray):
        return [jsonable(v) for v in obj.tolist()]
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# Pure columnar reductions (parity-tested vs per-trial reference loops)
# ---------------------------------------------------------------------------


def running_best(
    numbers: np.ndarray, values: np.ndarray, states: np.ndarray, minimize: bool
) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """``(numbers, values, best)`` over COMPLETE finite trials in number
    order — the optimization-history view.  ``best[i]`` is the best value
    among the first ``i+1`` usable trials (NaN-free prefix scan)."""
    mask = (states == _COMPLETE) & np.isfinite(values)
    y = values[mask].astype(float)
    op = np.fmin if minimize else np.fmax
    best = op.accumulate(y) if y.size else y
    return numbers[mask], y, best


def contour_reduction(
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    mask: np.ndarray,
    nx: int = 24,
    ny: int = 24,
    minimize: bool = True,
) -> "tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]":
    """2-D grid binning of objective ``z`` over two model-space parameter
    columns: ``(x_edges, y_edges, grid, counts)`` where ``grid[r, c]`` is the
    best ``z`` among masked points falling in cell (r, c) (NaN when empty).

    One ``minimum.at``/``maximum.at`` scatter — no per-trial Python loop."""
    m = mask & np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    xs, ys, zs = x[m].astype(float), y[m].astype(float), z[m].astype(float)
    if xs.size == 0:
        return np.zeros(nx + 1), np.zeros(ny + 1), np.full((ny, nx), np.nan), np.zeros((ny, nx), dtype=np.int64)
    xlo, xhi = float(xs.min()), float(xs.max())
    ylo, yhi = float(ys.min()), float(ys.max())
    if xhi <= xlo:
        xhi = xlo + 1.0
    if yhi <= ylo:
        yhi = ylo + 1.0
    xe = np.linspace(xlo, xhi, nx + 1)
    ye = np.linspace(ylo, yhi, ny + 1)
    ix = np.minimum(((xs - xlo) / (xhi - xlo) * nx).astype(np.int64), nx - 1)
    iy = np.minimum(((ys - ylo) / (yhi - ylo) * ny).astype(np.int64), ny - 1)
    flat = iy * nx + ix
    init = np.inf if minimize else -np.inf
    acc = np.full(nx * ny, init)
    (np.minimum if minimize else np.maximum).at(acc, flat, zs)
    counts = np.zeros(nx * ny, dtype=np.int64)
    np.add.at(counts, flat, 1)
    grid = np.where(counts > 0, acc, np.nan).reshape(ny, nx)
    return xe, ye, grid, counts.reshape(ny, nx)


def slice_reduction(
    x: np.ndarray,
    z: np.ndarray,
    mask: np.ndarray,
    n_bins: int = 10,
) -> dict:
    """Per-parameter slice view: the masked ``(x, z)`` scatter plus a binned
    median/p25/p75 band (``centers``/``med``/``lo``/``hi``/``counts``)."""
    m = mask & np.isfinite(x) & np.isfinite(z)
    xs, zs = x[m].astype(float), z[m].astype(float)
    out = {"x": xs, "z": zs}
    if xs.size == 0:
        out["bins"] = {"centers": np.empty(0), "med": np.empty(0),
                       "lo": np.empty(0), "hi": np.empty(0),
                       "counts": np.empty(0, dtype=np.int64)}
        return out
    blo, bhi = float(xs.min()), float(xs.max())
    if bhi <= blo:
        bhi = blo + 1.0
    ib = np.minimum(((xs - blo) / (bhi - blo) * n_bins).astype(np.int64), n_bins - 1)
    centers, med, lo_q, hi_q, counts = [], [], [], [], []
    width = (bhi - blo) / n_bins
    for b in range(n_bins):
        sel = zs[ib == b]
        if sel.size == 0:
            continue
        centers.append(blo + (b + 0.5) * width)
        med.append(float(np.median(sel)))
        lo_q.append(float(np.percentile(sel, 25)))
        hi_q.append(float(np.percentile(sel, 75)))
        counts.append(int(sel.size))
    out["bins"] = {
        "centers": np.asarray(centers),
        "med": np.asarray(med),
        "lo": np.asarray(lo_q),
        "hi": np.asarray(hi_q),
        "counts": np.asarray(counts, dtype=np.int64),
    }
    return out


def learning_curves(
    store: "IntermediateValueStore",
    max_curves: int = 64,
    objective: "int | None" = None,
) -> dict:
    """The last ``max_curves`` reporting trials' curves off the IV matrix:
    ``(steps, numbers, states, matrix)`` (rows aligned with numbers).  With
    ``objective=k`` the per-objective tensor slice is used instead of the
    scalar (pruner-facing) matrix."""
    with store.lock():
        matrix = store.matrix if objective is None else store.objective_matrix(objective)
        states = store.states
        steps = store.steps
        has = np.isfinite(matrix).any(axis=1) if matrix.size else np.zeros(0, dtype=bool)
        rows = np.flatnonzero(has)[-max_curves:]
        return {
            "steps": steps.copy(),
            "numbers": rows,
            "states": states[rows] if rows.size else rows,
            "matrix": matrix[rows] if rows.size else np.empty((0, steps.size)),
        }


# ---------------------------------------------------------------------------
# Revision-gated polling (shared by dashboard --live and the HTTP service)
# ---------------------------------------------------------------------------


class RevisionPoller:
    """The one revision-gated poll loop: ``poll()`` costs exactly one
    ``get_trials_revision`` call and reports whether anything changed since
    the previous poll.  Both the ``--live`` terminal dashboard and every
    HTTP delta endpoint go through this class, so "idle study = zero
    refetch" is pinned in one place (telemetry counters
    ``dashboard.poll.idle`` / ``dashboard.poll.changed``)."""

    def __init__(self, storage, study_id: int):
        self._storage = storage
        self._study_id = study_id
        self.rev = -1
        self.ticks = 0
        self.changes = 0

    def poll(self) -> bool:
        """True iff the study mutated since the last poll (always True on
        the first)."""
        rev = int(self._storage.get_trials_revision(self._study_id))
        self.ticks += 1
        if rev != self.rev:
            self.rev = rev
            self.changes += 1
            telemetry.inc("dashboard.poll.changed")
            return True
        telemetry.inc("dashboard.poll.idle")
        return False


# ---------------------------------------------------------------------------
# Per-study analytics engine
# ---------------------------------------------------------------------------


class StudyAnalytics:
    """All five dashboard views for one study, as version-cached columnar
    reductions.  Payloads are plain JSON-safe dicts (see :func:`jsonable`)
    ready for the HTTP service; an unchanged store serves the cached payload
    with zero recomputation."""

    def __init__(
        self,
        study: "Study",
        contour_bins: int = 24,
        slice_bins: int = 10,
        max_curves: int = 48,
        max_slice_params: int = 8,
    ):
        self._study = study
        self._contour_bins = contour_bins
        self._slice_bins = slice_bins
        self._max_curves = max_curves
        self._max_slice_params = max_slice_params
        self._views_cache: "tuple[tuple, dict] | None" = None
        self._imp_cache: "tuple[int, dict] | None" = None

    @property
    def study(self) -> "Study":
        return self._study

    # -- incremental rows (delta endpoint) -----------------------------------

    def delta_rows(self, since_number: int, pending: "Iterable[int]" = ()) -> dict:
        """Finished-trial rows with ``number > since_number`` — O(new
        trials): the store refresh is watermark-incremental and the row walk
        starts at a ``searchsorted`` offset.

        Concurrent workers finish trials out of order, so a trial at or below
        ``last_number`` may not have finished yet (a running, waiting or
        lost trial).  The answer lists such numbers under ``"pending"``, a
        key it holds only when there is one, so the answer for trials that
        finish in number order is the reference's.  A caller that sends them
        back as ``pending`` gets the row of each one that has since finished,
        first, in number order: every row ships exactly once and none waits
        for a trial below it."""
        store = self._study.observations()
        _, states, Vm, arity, numbers, cols = store.snapshot_mo()
        dists = {name: store.distribution(name) for name in cols}
        since_number = int(since_number)
        start = int(np.searchsorted(numbers, since_number, side="right"))
        last_number = int(numbers[-1]) if numbers.size else since_number
        waiting = np.unique(np.asarray([int(p) for p in pending], dtype=np.int64))
        waiting = waiting[waiting <= since_number]  # the cursor ships the rest
        at = np.searchsorted(numbers, waiting)
        done = at < numbers.size
        done[done] = numbers[at[done]] == waiting[done]
        unfinished = np.concatenate(
            [waiting[~done],
             np.setdiff1d(np.arange(since_number + 1, last_number + 1), numbers[start:])])
        values_first = store.values
        m = Vm.shape[1]
        rows = []
        for i in [*at[done].tolist(), *range(start, numbers.size)]:
            params = {}
            for name, col in cols.items():
                xv = col[i]
                if np.isfinite(xv):
                    d = dists.get(name)
                    params[name] = d.to_external_repr(float(xv)) if d is not None else float(xv)
            if int(arity[i]) == m:
                vals = list(Vm[i])
            elif np.isfinite(values_first[i]):
                vals = [float(values_first[i])]
            else:
                vals = []
            rows.append(
                {
                    "number": int(numbers[i]),
                    "state": TrialState(int(states[i])).name,
                    "values": jsonable(vals),
                    "params": jsonable(params),
                }
            )
        payload = {
            "rows": rows,
            "last_number": last_number,
            "n_finished": int(numbers.size),
        }
        if unfinished.size:
            payload["pending"] = unfinished.astype(np.int64).tolist()
        return payload

    # -- full views ----------------------------------------------------------

    def importances(self) -> dict:
        """fANOVA + Spearman importances, cached on the observation store's
        version so an idle study never re-fits the tree ensemble."""
        store = self._study.observations()
        version = store.version
        if self._imp_cache is not None and self._imp_cache[0] == version:
            return self._imp_cache[1]
        n_obj = len(self._study.directions)

        def flatten(res) -> dict:
            # per-objective dicts keyed by stringified index for JSON
            if n_obj > 1:
                return {str(k): jsonable(v) for k, v in res.items()}
            return {"0": jsonable(res)}

        payload = {
            "fanova": flatten(fanova_importances(self._study)),
            "spearman": flatten(spearman_importances(self._study)),
        }
        self._imp_cache = (version, payload)
        return payload

    def views(self) -> dict:
        """All five views as one JSON-safe payload, cached on the
        (observation version, IV version) pair."""
        study = self._study
        store = study.observations()
        iv = study.intermediate_values()
        key = (store.version, iv.version)
        if self._views_cache is not None and self._views_cache[0] == key:
            return self._views_cache[1]

        directions = study.directions
        n_obj = len(directions)
        _, states, Vm, arity, numbers, cols = store.snapshot_mo()
        values_first = store.values

        # optimization history, per objective
        history = []
        for k in range(n_obj):
            col = Vm[:, k] if Vm.shape[1] > k else values_first
            if n_obj == 1:
                col = values_first
            nums, vals, best = running_best(
                numbers, col, states, minimize=(int(directions[k]) == 0)
            )
            history.append(
                {"numbers": jsonable(nums), "values": jsonable(vals), "best": jsonable(best)}
            )

        # contour over the two most important params (fallback: first two)
        names = store.param_names()
        imp = self.importances()["fanova"].get("0", {})
        ranked = [n for n in imp if n in names] + [n for n in names if n not in imp]
        contour = None
        if len(ranked) >= 2 and numbers.size:
            xn, yn = ranked[0], ranked[1]
            xcol, ycol = cols.get(xn), cols.get(yn)
            if xcol is not None and ycol is not None:
                mask = states == _COMPLETE
                xe, ye, grid, counts = contour_reduction(
                    xcol, ycol, values_first, mask,
                    nx=self._contour_bins, ny=self._contour_bins,
                    minimize=(int(directions[0]) == 0),
                )
                contour = {
                    "x_param": xn, "y_param": yn,
                    "x_edges": jsonable(xe), "y_edges": jsonable(ye),
                    "grid": jsonable(grid), "counts": jsonable(counts),
                }

        # slice view per parameter (model space), capped
        slices = []
        mask = states == _COMPLETE
        for name in ranked[: self._max_slice_params]:
            col = cols.get(name)
            if col is None:
                continue
            s = slice_reduction(col, values_first, mask, n_bins=self._slice_bins)
            slices.append({"param": name, **{k: jsonable(v) for k, v in s.items()}})

        # Pareto front (2-objective view)
        pareto = None
        if n_obj == 2:
            pmask = (states == _COMPLETE) & (arity == n_obj)
            front = moo.pareto_front_mask(
                moo.loss_matrix(Vm, directions), mask=pmask
            )
            pareto = {
                "numbers": jsonable(numbers[pmask]),
                "values": jsonable(Vm[pmask]),
                "front_numbers": jsonable(numbers[front]),
            }

        # learning curves (per-objective on vector-reporting studies)
        curves = {"objectives": []}
        iv_obj = iv.n_objectives
        for k in range(iv_obj if iv_obj > 1 else 1):
            lc = learning_curves(
                iv, max_curves=self._max_curves,
                objective=(k if iv_obj > 1 else None),
            )
            curves["objectives"].append(
                {
                    "steps": jsonable(lc["steps"]),
                    "numbers": jsonable(lc["numbers"]),
                    "states": jsonable(lc["states"]),
                    "matrix": jsonable(lc["matrix"]),
                }
            )

        n_by_state: dict[str, int] = {}
        for s in states:
            name = TrialState(int(s)).name
            n_by_state[name] = n_by_state.get(name, 0) + 1
        payload = {
            "study": study.study_name,
            "directions": [d.name.lower() for d in directions],
            "n_finished": int(numbers.size),
            "by_state": n_by_state,
            "history": history,
            "contour": contour,
            "slices": slices,
            "pareto": pareto,
            "curves": curves,
            "importance": self.importances(),
        }
        self._views_cache = (key, payload)
        return payload
