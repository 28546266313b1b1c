"""Hyperparameter importance — feeds the dashboard (paper Fig. 8 style analysis).

Three evaluators, all pandas/sklearn-free:

* :func:`fanova_importances` — **fANOVA** (Hutter et al., ICML'14) on a
  bootstrap ensemble of regression trees fit to the observation store's
  model-space design matrix.  Each tree partitions the unit hypercube into
  leaf boxes; the functional-ANOVA main effect of parameter *j* is the
  variance of the tree's marginal prediction over axis *j* (piecewise
  constant over the tree's axis-*j* split segments), as a fraction of the
  tree's total prediction variance.  Falls back to the Spearman evaluator
  when there is too little data to grow trees.
* :func:`param_importances` — per-parameter *variance explained* by a binned
  conditional-mean model (one-way fANOVA main effect on the empirical
  distribution).
* :func:`spearman_importances` — |Spearman rank correlation| as a
  cross-check.

All operate on completed trials only and normalize to sum 1.  On
multi-objective studies each returns per-objective importances keyed by
objective index (``{0: {...}, 1: {...}}``); pass ``objective=k`` for one
flat dict.  Single-objective results are bit-identical to the historical
single-objective-only evaluators (pinned by ``tests/test_torch_dashboard.py``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from .distributions import CategoricalDistribution
from .frozen import TrialState

if TYPE_CHECKING:
    from .study import Study

__all__ = ["param_importances", "spearman_importances", "fanova_importances"]


def _collect(study: "Study", objective: int = 0):
    trials = [
        t
        for t in study.get_trials(deepcopy=False, states=(TrialState.COMPLETE,))
        if t.values is not None
        and len(t.values) > objective
        and np.isfinite(t.values[objective])
    ]
    names = sorted({n for t in trials for n in t.params})
    return trials, names


def _per_objective(study: "Study", objective, fn):
    """Shared multi-objective dispatch: ``objective=None`` on an MO study
    fans ``fn`` out per objective index; otherwise one flat dict."""
    n_obj = len(study.directions)
    if objective is None and n_obj > 1:
        return {k: fn(k) for k in range(n_obj)}
    return fn(int(objective) if objective is not None else 0)


def param_importances(
    study: "Study", n_bins: int = 8, objective: "int | None" = None
) -> dict:
    """Main-effect variance ratio per parameter (one-way fANOVA on bins).

    Degrades gracefully: studies with fewer than two usable COMPLETE trials
    yield ``{}`` (nothing to attribute) rather than raising.  Multi-objective
    studies return ``{objective_index: {param: importance}}`` unless a single
    ``objective`` is requested.
    """
    return _per_objective(study, objective, lambda k: _binned(study, n_bins, k))


def _binned(study: "Study", n_bins: int, objective: int) -> dict[str, float]:
    trials, names = _collect(study, objective)
    if len(trials) < 2:
        return {}
    if len(trials) < 4:
        return {n: 0.0 for n in names}
    y = np.array([t.values[objective] for t in trials], dtype=float)
    total_var = float(y.var())
    if total_var <= 0:
        return {n: 0.0 for n in names}

    scores: dict[str, float] = {}
    for name in names:
        xs, ys = [], []
        for t, v in zip(trials, y):
            if name in t.params:
                dist = t.distributions[name]
                xs.append(dist.to_internal_repr(t.params[name]))
                ys.append(v)
        if len(xs) < 4:
            scores[name] = 0.0
            continue
        xs = np.asarray(xs)
        ys = np.asarray(ys)
        dist = next(t.distributions[name] for t in trials if name in t.distributions)
        if isinstance(dist, CategoricalDistribution):
            bins = xs.astype(int)
        else:
            lo, hi = xs.min(), xs.max()
            if hi <= lo:
                scores[name] = 0.0
                continue
            if getattr(dist, "log", False):
                xs_t = np.log(np.maximum(xs, 1e-300))
                lo, hi = xs_t.min(), xs_t.max()
                bins = np.minimum(((xs_t - lo) / (hi - lo) * n_bins).astype(int), n_bins - 1)
            else:
                bins = np.minimum(((xs - lo) / (hi - lo) * n_bins).astype(int), n_bins - 1)
        # variance explained by bin-conditional means
        explained = 0.0
        for b in np.unique(bins):
            m = bins == b
            explained += m.sum() * (ys[m].mean() - ys.mean()) ** 2
        scores[name] = float(explained / len(ys) / ys.var()) if ys.var() > 0 else 0.0

    total = sum(scores.values())
    if total > 0:
        scores = {k: v / total for k, v in scores.items()}
    return dict(sorted(scores.items(), key=lambda kv: -kv[1]))


def spearman_importances(study: "Study", objective: "int | None" = None) -> dict:
    """|Spearman rank correlation| per parameter; same degradation rules as
    :func:`param_importances` (``{}`` on <2 trials, per-objective dict on
    multi-objective studies)."""
    return _per_objective(study, objective, lambda k: _spearman(study, k))


def _spearman(study: "Study", objective: int) -> dict[str, float]:
    trials, names = _collect(study, objective)
    if len(trials) < 2:
        return {}
    if len(trials) < 4:
        return {n: 0.0 for n in names}
    y = np.array([t.values[objective] for t in trials], dtype=float)
    out = {}
    for name in names:
        xs, ys = [], []
        for t, v in zip(trials, y):
            if name in t.params:
                xs.append(t.distributions[name].to_internal_repr(t.params[name]))
                ys.append(v)
        if len(xs) < 4 or np.std(xs) == 0:
            out[name] = 0.0
            continue
        rx = np.argsort(np.argsort(xs)).astype(float)
        ry = np.argsort(np.argsort(ys)).astype(float)
        denom = rx.std() * ry.std()
        out[name] = float(abs(np.mean((rx - rx.mean()) * (ry - ry.mean())) / denom)) if denom > 0 else 0.0
    total = sum(out.values())
    if total > 0:
        out = {k: v / total for k, v in out.items()}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# fANOVA on the columnar design matrix
# ---------------------------------------------------------------------------


def _fit_tree(X, y, idx, max_depth: int, min_leaf: int):
    """Grow one variance-reduction regression tree over bootstrap rows
    ``idx`` and return its leaf partition of the unit hypercube as
    ``(lo, hi, value)`` arrays — the only thing fANOVA needs.

    Splits are exact best-SSE scans, vectorized per (node, feature) with
    prefix sums over the sorted column."""
    d = X.shape[1]
    leaves_lo: list[np.ndarray] = []
    leaves_hi: list[np.ndarray] = []
    leaves_v: list[float] = []
    stack = [(idx, np.zeros(d), np.ones(d), 0)]
    while stack:
        rows, lo, hi, depth = stack.pop()
        ys = y[rows]
        split = None
        if depth < max_depth and rows.size >= 2 * min_leaf and ys.max() > ys.min():
            best_sse = np.inf
            m = rows.size
            cuts = np.arange(1, m)
            for j in range(d):
                xs = X[rows, j]
                order = np.argsort(xs, kind="stable")
                xs_s, ys_s = xs[order], ys[order]
                valid = (xs_s[1:] > xs_s[:-1]) & (cuts >= min_leaf) & (m - cuts >= min_leaf)
                if not valid.any():
                    continue
                csum = np.cumsum(ys_s)
                csq = np.cumsum(ys_s * ys_s)
                ls, lq = csum[:-1], csq[:-1]
                rs, rq = csum[-1] - ls, csq[-1] - lq
                with np.errstate(invalid="ignore"):
                    sse = (lq - ls * ls / cuts) + (rq - rs * rs / (m - cuts))
                sse[~valid] = np.inf
                k = int(np.argmin(sse))
                if sse[k] < best_sse:
                    best_sse = float(sse[k])
                    # k indexes cut "left count = k+1": boundary midpoint
                    split = (j, 0.5 * float(xs_s[k] + xs_s[k + 1]))
        if split is None:
            leaves_lo.append(lo)
            leaves_hi.append(hi)
            leaves_v.append(float(ys.mean()))
            continue
        j, thr = split
        go_left = X[rows, j] <= thr
        hi_l = hi.copy()
        hi_l[j] = thr
        lo_r = lo.copy()
        lo_r[j] = thr
        stack.append((rows[go_left], lo, hi_l, depth + 1))
        stack.append((rows[~go_left], lo_r, hi, depth + 1))
    return np.asarray(leaves_lo), np.asarray(leaves_hi), np.asarray(leaves_v)


def _fanova_tree_main_effects(lo, hi, v) -> "tuple[np.ndarray, float]":
    """Per-parameter main-effect variances of one tree's piecewise-constant
    predictor over the unit hypercube.

    With leaf boxes :math:`B_l` (volume = weight :math:`w_l`, value
    :math:`v_l`): total variance :math:`V = \\sum_l w_l v_l^2 - \\mu^2`
    (:math:`\\mu = \\sum_l w_l v_l`), and the axis-*j* marginal
    :math:`f_j(x) = \\sum_{l: x \\in B_l|_j} v_l \\, w_l / |B_l|_j` is
    piecewise constant over the tree's axis-*j* split segments, so
    :math:`V_j = \\int (f_j - \\mu)^2` is an exact sum over segments."""
    d = lo.shape[1]
    w = np.prod(hi - lo, axis=1)
    mu = float((w * v).sum())
    V = float((w * v * v).sum() - mu * mu)
    out = np.zeros(d)
    if V <= 1e-18:
        return out, 0.0
    for j in range(d):
        bounds = np.unique(np.concatenate((lo[:, j], hi[:, j])))
        if bounds.size <= 2:  # never split on j -> flat marginal
            continue
        seg_lo, seg_hi = bounds[:-1], bounds[1:]
        lenj = hi[:, j] - lo[:, j]
        contain = (seg_lo[:, None] >= lo[None, :, j] - 1e-12) & (
            seg_hi[:, None] <= hi[None, :, j] + 1e-12
        )
        f = contain @ (v * w / lenj)
        out[j] = float(((seg_hi - seg_lo) * (f - mu) ** 2).sum())
    return out, V


def fanova_importances(
    study: "Study",
    objective: "int | None" = None,
    n_trees: int = 16,
    max_depth: int = 6,
    min_samples_leaf: int = 3,
    seed: int = 0,
) -> dict:
    """fANOVA importances on the observation store's design matrix.

    Reads the store's model-space columns directly (log-transformed numerics
    / categorical indices — no re-encoding), normalizes each to [0, 1],
    imputes unsuggested cells with the column mean, fits ``n_trees``
    bootstrap regression trees and averages each parameter's main-effect
    variance fraction across the ensemble.  The store is revision-gated, so
    calling this per dashboard poll re-fits only when new trials landed
    (callers cache on ``store.version`` — see ``core/analytics.py``).

    Falls back to :func:`spearman_importances` when fewer than
    ``max(8, 4 * min_samples_leaf)`` usable rows exist or the objective has
    zero variance.  Multi-objective studies return per-objective dicts keyed
    by objective index unless ``objective`` is given.
    """

    def one(k: int) -> dict[str, float]:
        store = study.observations()
        names = store.param_names()
        if not names:
            return {}
        _, states, Vm, arity, _, cols = store.snapshot_mo()
        if Vm.shape[1] <= k:
            return _spearman(study, k)
        y_all = Vm[:, k]
        mask = (states == int(TrialState.COMPLETE)) & np.isfinite(y_all)
        n = int(mask.sum())
        if n < max(8, 4 * min_samples_leaf) or float(y_all[mask].var()) <= 0:
            return _spearman(study, k)
        y = y_all[mask].astype(float)
        X = np.empty((n, len(names)))
        for jcol, name in enumerate(names):
            col = cols.get(name)
            c = (
                col[mask].astype(float).copy()
                if col is not None
                else np.full(n, np.nan)
            )
            obs = np.isfinite(c)
            if obs.any():
                c[~obs] = float(c[obs].mean())
                clo, chi = float(c.min()), float(c.max())
                c = (c - clo) / (chi - clo) if chi > clo else np.full(n, 0.5)
            else:
                c = np.full(n, 0.5)
            X[:, jcol] = c
        rng = np.random.default_rng(seed)
        imp = np.zeros(len(names))
        used = 0
        for _ in range(int(n_trees)):
            idx = rng.integers(0, n, n)
            lo, hi, v = _fit_tree(X, y, idx, int(max_depth), int(min_samples_leaf))
            vj, V = _fanova_tree_main_effects(lo, hi, v)
            if V > 0:
                imp += vj / V
                used += 1
        if used == 0:
            return _spearman(study, k)
        imp /= used
        total = float(imp.sum())
        if total > 0:
            imp = imp / total
        out = {name: float(w) for name, w in zip(names, imp)}
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    return _per_objective(study, objective, one)
