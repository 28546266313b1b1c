"""Multi-objective engine — columnar Pareto/dominance primitives.

Everything multi-objective in the stack funnels through this module:
``Study.best_trials`` / ``Study.pareto_front``, the NSGA-II sampler's
rank+crowding selection, and MOTPE's nondomination split all operate on the
observation store's ``(n_trials, n_objectives)`` values matrix with the
vectorized primitives below, instead of the historical pure-Python pairwise
dominance loop (O(n² · m) interpreter work per call).

Conventions
-----------
* All functions take **loss-oriented** values: every objective is minimized.
  Callers convert maximize objectives by sign (see :func:`loss_matrix`).
* Rows containing NaN follow IEEE comparison semantics: a NaN coordinate is
  neither better nor worse than anything, so it simply contributes no
  evidence either way — exactly what the frozen pairwise loop in ``Study``
  did (its ``dominates`` is ``not any(a > b) and any(a < b)``, and NaN
  comparisons are all False).  Callers that want NaN rows excluded entirely
  mask them out first.

Dominance as a sign-matrix reduction
------------------------------------
``i`` dominates ``j`` iff ``not any(V[i] > V[j])`` and ``any(V[i] < V[j])``
(for NaN-free rows this is the familiar ``all(<=) and any(<)``).
:func:`dominance_matrix` evaluates both reductions for **all** (i, j) pairs
in one broadcasted ``(n, n, m)`` comparison — the multi-objective analogue of
the TPE scorer's one-matrix-op design — with a torch path on the engine's
device for the same reduction.
Front ranks then fall out of iterated masking over the boolean matrix: peel
the non-dominated rows, drop their domination edges, repeat.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.hypervolume import mc_hv_counts, mc_hv_counts_sets
from ..kernels.ref import mc_hv_counts_ref, mc_hv_counts_sets_ref

if TYPE_CHECKING:
    from .frozen import StudyDirection

__all__ = [
    "loss_matrix",
    "dominance_matrix",
    "nondomination_ranks",
    "pareto_front_mask",
    "crowding_distance",
    "hypervolume",
    "hypervolume_contributions",
    "HypervolumeEstimator",
    "solve_hssp",
]

#: rank assigned to rows excluded from the sort (masked out by the caller)
EXCLUDED = -1

_DOM_CHUNK = 256  # rows per broadcasted block: caps the (chunk, n, m) temporary
#: booleans of one (rows, n, m) block of the torch dominance compare
_TORCH_DOM_ELEMS = 1 << 27


def loss_matrix(values: np.ndarray, directions: "Sequence[StudyDirection | int]") -> np.ndarray:
    """Orient a raw ``(n, m)`` values matrix so every column is minimized:
    maximize columns are sign-flipped.  Returns a fresh array."""
    V = np.array(values, dtype=float, copy=True)
    if V.ndim != 2 or V.shape[1] != len(directions):
        raise ValueError(
            f"values matrix shape {V.shape} does not match {len(directions)} directions"
        )
    for j, d in enumerate(directions):
        if int(d) == 1:  # StudyDirection.MAXIMIZE
            V[:, j] = -V[:, j]
    return V


# -- dominance ------------------------------------------------------------------

def _resolve(
    engine: str, work: int, device, ceiling: "int | None" = None
) -> "tuple[str, torch.device | None]":
    """``(engine, device)`` for one reduction of ``work`` units.  A reduction
    that resolves to numpy needs no device; any other resolves its device
    through :func:`kops.resolve_device`, so it raises without a card unless
    the caller passed ``device="cpu"``.  ``ceiling`` sends ``"auto"`` back to
    numpy past that much work on a CPU device."""
    kops.validate_engine(engine)
    if engine == "numpy" or (engine == "auto" and work < kops.DOM_JIT_THRESHOLD):
        return "numpy", None
    dev = kops.resolve_device(engine, device)
    eng = kops.resolve_engine(engine, work, kops.DOM_JIT_THRESHOLD, dev)
    if engine == "auto" and ceiling is not None and dev.type == "cpu" and work > ceiling:
        return "numpy", None
    return eng, dev


def _dominance_torch(V: np.ndarray, device: torch.device) -> np.ndarray:
    """The dominance reduction as a torch broadcast compare on ``device``,
    row block by row block so the working set stays near
    ``_TORCH_DOM_ELEMS`` booleans.  It compares the float64 values as they
    are, so it is bit-identical to the numpy path and to the pairwise loop:
    a float32 cast would merge values that differ only past float32's
    precision into ties and change the front.  There is no hand-written
    kernel: the compare is one elementwise pass."""
    Vt = torch.from_numpy(np.ascontiguousarray(V, dtype=np.float64)).to(device)
    n, m = Vt.shape
    out = torch.empty((n, n), dtype=torch.bool, device=device)
    chunk = max(1, _TORCH_DOM_ELEMS // max(1, n * m))
    for start in range(0, n, chunk):
        a = Vt[start:start + chunk, None, :]
        # not-any(>) rather than all(<=): identical on NaN-free rows, and
        # matches the pairwise reference's NaN semantics otherwise
        no_worse = ~(a > Vt[None, :, :]).any(dim=2)
        better = (a < Vt[None, :, :]).any(dim=2)
        out[start:start + chunk] = no_worse & better
    return out.cpu().numpy()


def dominance_matrix(
    V: np.ndarray, engine: str = "numpy", device: "str | torch.device | None" = None
) -> np.ndarray:
    """Boolean ``(n, n)`` matrix with ``out[i, j]`` True iff row ``i``
    dominates row ``j`` (loss orientation).  The diagonal is always False
    (a row never strictly improves on itself).

    The numpy path evaluates the two sign-matrix reductions in row chunks so
    the broadcasted ``(chunk, n, m)`` temporaries stay cache-sized; the
    ``"torch"`` and ``"cuda"`` engines run the same reduction as a torch
    broadcast compare on ``device`` (``None`` means the card).  ``"auto"``
    picks the device past ``DOM_JIT_THRESHOLD`` rows x objectives, and on a
    CPU device goes back to numpy past ``DOM_CPU_CEILING``.
    """
    V = np.asarray(V, dtype=float)
    n = len(V)
    if n == 0:
        return np.zeros((0, 0), dtype=bool)
    eng, dev = _resolve(engine, n * V.shape[1], device, ceiling=kops.DOM_CPU_CEILING)
    if eng != "numpy":
        return _dominance_torch(V, dev)
    out = np.empty((n, n), dtype=bool)
    m = V.shape[1]
    with np.errstate(invalid="ignore"):
        for start in range(0, n, _DOM_CHUNK):
            stop = min(start + _DOM_CHUNK, n)
            # unrolled over objectives (m is tiny): each pass is one full-speed
            # contiguous (chunk, n) comparison — an order of magnitude faster
            # than broadcasting a (chunk, n, m) cube and reducing its last axis
            any_gt = np.zeros((stop - start, n), dtype=bool)
            any_lt = np.zeros((stop - start, n), dtype=bool)
            scratch = np.empty((stop - start, n), dtype=bool)
            for k in range(m):
                b = V[start:stop, k][:, None]
                c = V[:, k][None, :]
                np.greater(b, c, out=scratch)
                np.logical_or(any_gt, scratch, out=any_gt)
                np.less(b, c, out=scratch)
                np.logical_or(any_lt, scratch, out=any_lt)
            np.logical_not(any_gt, out=any_gt)
            np.logical_and(any_gt, any_lt, out=out[start:stop])
    return out


def nondomination_ranks(
    V: np.ndarray,
    mask: "np.ndarray | None" = None,
    engine: str = "numpy",
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Front rank per row (0 = Pareto front) via iterated masking over the
    dominance matrix: rows not dominated by any active row form the current
    front, are assigned the rank, and drop out of the active set.

    ``mask`` (optional) excludes rows from the sort entirely — they get rank
    :data:`EXCLUDED` and constrain nothing.  NaN rows that *are* included end
    up on front 0 (IEEE semantics, matching the pairwise reference)."""
    V = np.asarray(V, dtype=float)
    n = len(V)
    ranks = np.full(n, EXCLUDED, dtype=np.int64)
    active = np.ones(n, dtype=bool) if mask is None else np.asarray(mask, dtype=bool).copy()
    if not active.any():
        return ranks
    idx = np.flatnonzero(active)
    dom = dominance_matrix(V[idx], engine=engine, device=device)
    # dominated_by[j] = number of active rows dominating j; peel fronts by
    # subtracting the peeled rows' edges instead of re-reducing the matrix
    dominated_by = dom.sum(axis=0).astype(np.int64)
    remaining = np.ones(len(idx), dtype=bool)
    rank = 0
    while remaining.any():
        front = remaining & (dominated_by == 0)
        if not front.any():  # pragma: no cover - cycles are impossible
            front = remaining
        ranks[idx[front]] = rank
        remaining &= ~front
        dominated_by -= dom[front].sum(axis=0)
        rank += 1
    return ranks


_PREFILTER_MIN = 512   # below this a single dominance reduction is cheaper
_PREFILTER_PICKS = 64  # strong-dominator candidates used to thin the field


def _dominated_by_any(V: np.ndarray, D: np.ndarray) -> np.ndarray:
    """``out[i]`` True iff some row of ``D`` dominates ``V[i]`` — evaluated
    per objective like :func:`dominance_matrix`, (n, len(D)) at a time."""
    n, m = V.shape
    any_gt = np.zeros((n, len(D)), dtype=bool)
    any_lt = np.zeros((n, len(D)), dtype=bool)
    scratch = np.empty((n, len(D)), dtype=bool)
    for k in range(m):
        v = V[:, k][:, None]
        d = D[:, k][None, :]
        np.less(d, v, out=scratch)      # dominator strictly better somewhere
        np.logical_or(any_lt, scratch, out=any_lt)
        np.greater(d, v, out=scratch)   # dominator worse somewhere -> no dom
        np.logical_or(any_gt, scratch, out=any_gt)
    return (~any_gt & any_lt).any(axis=1)


def pareto_front_mask(
    V: np.ndarray,
    mask: "np.ndarray | None" = None,
    engine: str = "numpy",
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Boolean mask of the non-dominated rows (front 0), without peeling the
    remaining fronts.

    NaN-free inputs above :data:`_PREFILTER_MIN` rows take a two-stage path:
    a handful of strong dominators (smallest objective sums) eliminate the
    bulk of the field in O(n · picks · m), and the full dominance reduction
    runs only on the survivors.  This is exact because NaN-free dominance is
    transitive — a row dominated by an eliminated row is also dominated by
    whatever eliminated it, so survivors-vs-survivors decides the front.
    NaN rows break transitivity (a NaN coordinate is incomparable either
    way), so any NaN input falls back to the single full reduction, keeping
    bit-parity with the pairwise reference."""
    V = np.asarray(V, dtype=float)
    n = len(V)
    out = np.zeros(n, dtype=bool)
    active = np.ones(n, dtype=bool) if mask is None else np.asarray(mask, dtype=bool)
    idx = np.flatnonzero(active)
    if len(idx) == 0:
        return out
    A = V[idx]
    if len(idx) >= _PREFILTER_MIN and not np.isnan(A).any():
        finite = np.where(np.isfinite(A), A, np.inf)
        # normalize per objective so no single scale dominates the pick
        lo = finite.min(axis=0)
        span = np.where(finite.max(axis=0) > lo, finite.max(axis=0) - lo, 1.0)
        with np.errstate(invalid="ignore"):
            score = ((finite - lo) / span).sum(axis=1)
        picks = A[np.argsort(score, kind="stable")[:_PREFILTER_PICKS]]
        survivors = np.flatnonzero(~_dominated_by_any(A, picks))
        S = A[survivors]
        dom = dominance_matrix(S, engine=engine, device=device)
        out[idx[survivors]] = ~dom.any(axis=0)
        return out
    dom = dominance_matrix(A, engine=engine, device=device)
    out[idx] = ~dom.any(axis=0)
    return out


# -- crowding distance ----------------------------------------------------------

def crowding_distance(V: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance of each row *within the given set* (callers
    pass one front at a time).  Boundary rows per objective get +inf;
    interior rows sum their normalized neighbour gaps.  Vectorized: one
    argsort per objective, no Python loop over rows."""
    V = np.asarray(V, dtype=float)
    n, m = V.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for j in range(m):
        col = V[:, j]
        order = np.argsort(col, kind="stable")
        sorted_col = col[order]
        span = sorted_col[-1] - sorted_col[0]
        gaps = np.empty(n)
        gaps[0] = gaps[-1] = np.inf
        if span > 0 and np.isfinite(span):
            gaps[1:-1] = (sorted_col[2:] - sorted_col[:-2]) / span
        else:
            gaps[1:-1] = 0.0
        dist[order] += gaps
    return dist


# -- hypervolume ----------------------------------------------------------------

def hypervolume(points: np.ndarray, reference: np.ndarray) -> float:
    """Exact hypervolume dominated by ``points`` w.r.t. ``reference`` (loss
    orientation: a point counts iff it is <= the reference in every
    objective).  2-D uses a sorted sweep; higher dimensions run the WFG
    exclusive-volume recursion (While et al., 2012) over the non-dominated
    set — exact for any m, intended for m <= 4 where front sizes keep the
    recursion shallow."""
    points = np.asarray(points, dtype=float)
    reference = np.asarray(reference, dtype=float)
    if points.ndim != 2 or points.shape[1] != len(reference):
        raise ValueError(f"points shape {points.shape} vs reference {reference.shape}")
    # clip to the reference box: points outside contribute only their inside part
    keep = (points <= reference).all(axis=1)
    points = points[keep]
    if len(points) == 0:
        return 0.0
    points = points[pareto_front_mask(points)]
    return float(_wfg(points, reference))


def _wfg(points: np.ndarray, ref: np.ndarray) -> float:
    m = points.shape[1]
    if m == 1:
        return float(ref[0] - points.min())
    if m == 2:
        return _hv2d(points, ref)
    # WFG: sort (heuristically, by first objective) and sum exclusive volumes
    order = np.argsort(points[:, 0], kind="stable")
    points = points[order]
    total = 0.0
    for i in range(len(points)):
        p = points[i]
        rest = points[i + 1:]
        incl = float(np.prod(ref - p))
        if len(rest) == 0:
            total += incl
            continue
        limited = np.maximum(rest, p)            # limit set w.r.t. p
        limited = limited[pareto_front_mask(limited)]
        total += incl - _wfg(limited, ref)
    return total


def _hv2d(points: np.ndarray, ref: np.ndarray) -> float:
    """2-D hypervolume by a single sweep over the front sorted by the first
    objective (the front is already mutually non-dominated, so the second
    objective is strictly decreasing along the sweep)."""
    order = np.lexsort((points[:, 1], points[:, 0]))
    pts = points[order]
    total = 0.0
    prev_y = ref[1]
    for x, y in pts:
        if y < prev_y:
            total += (ref[0] - x) * (prev_y - y)
            prev_y = y
    return float(total)


def hypervolume_contributions(
    points: np.ndarray,
    reference: np.ndarray,
    estimator: "HypervolumeEstimator | None" = None,
) -> np.ndarray:
    """Per-point exclusive hypervolume: ``hv(all) - hv(all minus point)``.
    The MOTPE below-set weights (Ozaki et al., 2020) are these contributions
    normalized to [0, 1].  With an ``estimator`` the call routes through its
    method policy (exact leave-one-out for small m, one Monte-Carlo counting
    pass for many objectives)."""
    if estimator is not None:
        return estimator.contributions(points, reference)
    points = np.asarray(points, dtype=float)
    n = len(points)
    if n == 0:
        return np.zeros(0)
    if n == 1:
        return np.asarray([hypervolume(points, reference)])
    total = hypervolume(points, reference)
    out = np.empty(n)
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        keep[i] = False
        out[i] = total - hypervolume(points[keep], reference)
        keep[i] = True
    return out


# -- Monte-Carlo hypervolume ------------------------------------------------------

def _mc_counts_numpy(
    pts: np.ndarray, samples: np.ndarray
) -> tuple[np.ndarray, float]:
    """Chunked host-side domination counting (the parity reference)."""
    excl = np.zeros(len(pts))
    total = 0.0
    for start in range(0, len(samples), 4096):
        smp = samples[start:start + 4096]
        dom = np.all(pts[None, :, :] <= smp[:, None, :], axis=2)
        cnt = dom.sum(axis=1)
        total += float((cnt > 0).sum())
        excl += (dom & (cnt == 1)[:, None]).sum(axis=0)
    return excl, total


_DRAW_LOCK = threading.Lock()
#: (seed, n_samples, m, device) -> the estimator's uniform draw on that device
_DRAWS: "dict[tuple, torch.Tensor]" = {}


def _uniform_draw(seed: int, n_samples: int, m: int, device: torch.device) -> torch.Tensor:
    """``RandomState(seed).random_sample((n_samples, m))`` as a float64
    tensor on ``device``, drawn once per key and kept.  ``uniform(lo, ref)``
    of the same state is ``lo + (ref - lo) * u`` element by element, so
    every box's samples follow from this one draw."""
    key = (seed, n_samples, m, str(device))
    with _DRAW_LOCK:
        u = _DRAWS.get(key)
        if u is None:
            u = torch.from_numpy(np.random.RandomState(seed).random_sample((n_samples, m)))
            u = _DRAWS[key] = u.to(device)
    return u


class HypervolumeEstimator:
    """Hypervolume / per-point contribution estimator with a method policy.

    The exact WFG recursion is exponential in the objective count: past
    m = 4 front sizes make it intractable, which historically capped MOTPE
    at few-objective studies.  ``method="auto"`` keeps the exact recursion
    where it is cheap (m <= 4) and switches to Monte-Carlo counting above:
    ``n_samples`` points drawn uniformly in the bounding box
    ``[min(points), reference]``, hypervolume estimated from the dominated
    fraction and per-point contributions from the *exclusively* dominated
    fraction (samples covered by exactly one point — in expectation exactly
    ``hv(all) - hv(all minus point)``).  Standard error scales as
    ``box_volume / sqrt(n_samples)`` independent of m.

    The counting pass dispatches through the shared engine policy:
    ``"numpy"`` counts in float64 on the host; ``"torch"`` runs the plain
    PyTorch version and ``"cuda"`` the hand-written kernel
    (``kernels/hypervolume.py``) on ``device`` (``None`` means the card);
    ``"auto"`` stays on numpy below ``DOM_JIT_THRESHOLD`` units of work
    (points x samples) and above it takes ``"cuda"`` on a CUDA device and
    ``"torch"`` on a CPU one.  The sample draw is seeded and happens on the
    host, so repeated calls on one front are deterministic, and the device
    engines see the samples rounded once to float32 there.

    :func:`solve_hssp` evaluates many point sets at once
    (:meth:`_hypervolumes`): the device engines then count all of them in
    one batched call, with the samples made on the device from one cached
    draw (:func:`_uniform_draw`) by the same float64 arithmetic and the same
    float32 rounding, so each set's hypervolume is the float
    :meth:`hypervolume` returns for it."""

    def __init__(
        self,
        method: str = "auto",
        n_samples: int = 8192,
        seed: int = 0,
        engine: str = "auto",
        device: "str | torch.device | None" = None,
    ) -> None:
        if method not in ("auto", "exact", "mc"):
            raise ValueError(f"method must be auto|exact|mc, got {method!r}")
        self._method = method
        self._n_samples = int(n_samples)
        self._seed = int(seed)
        self._engine = kops.validate_engine(engine)
        self._device = device

    def _use_exact(self, m: int) -> bool:
        if self._method == "exact":
            return True
        if self._method == "mc":
            return False
        return m <= 4

    def hypervolume(self, points: np.ndarray, reference: np.ndarray) -> float:
        points = np.asarray(points, dtype=float)
        reference = np.asarray(reference, dtype=float)
        if self._use_exact(points.shape[1] if points.ndim == 2 else len(reference)):
            return hypervolume(points, reference)
        keep = (points <= reference).all(axis=1)
        pts = points[keep]
        if len(pts) == 0:
            return 0.0
        hv, _ = self._mc_stats(pts, reference)
        return hv

    def contributions(self, points: np.ndarray, reference: np.ndarray) -> np.ndarray:
        points = np.asarray(points, dtype=float)
        reference = np.asarray(reference, dtype=float)
        if self._use_exact(points.shape[1] if points.ndim == 2 else len(reference)):
            return hypervolume_contributions(points, reference)
        n = len(points)
        out = np.zeros(n)
        keep = (points <= reference).all(axis=1)
        pts = points[keep]
        if len(pts) == 0:
            # outside-the-box points contribute nothing, same as the exact
            # path where hv(all minus point) == hv(all)
            return out
        _, contrib = self._mc_stats(pts, reference)
        out[keep] = contrib
        return out

    def _mc_stats(
        self, pts: np.ndarray, reference: np.ndarray
    ) -> tuple[float, np.ndarray]:
        """``(hv_estimate, per-point contribution estimates)`` for points
        already clipped inside the reference box."""
        lo = pts.min(axis=0)
        box = float(np.prod(reference - lo))
        if not np.isfinite(box) or box <= 0.0:
            return 0.0, np.zeros(len(pts))
        rng = np.random.RandomState(self._seed)
        samples = rng.uniform(lo, reference, size=(self._n_samples, pts.shape[1]))
        excl, total = self._counts(pts, samples)
        scale = box / self._n_samples
        return float(total) * scale, np.asarray(excl, dtype=float) * scale

    def _counts(
        self, pts: np.ndarray, samples: np.ndarray
    ) -> tuple[np.ndarray, float]:
        eng, dev = _resolve(self._engine, len(pts) * len(samples), self._device)
        if eng == "numpy":
            return _mc_counts_numpy(pts, samples)
        # float64 -> float32 once, on the host, before the copy
        P = torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32)).to(dev)
        S = torch.from_numpy(np.ascontiguousarray(samples, dtype=np.float32)).to(dev)
        counts = mc_hv_counts if eng == "cuda" else mc_hv_counts_ref
        excl, total = counts(P, S)
        return excl.cpu().numpy(), float(total)

    def _hypervolumes(self, sets: np.ndarray, reference: np.ndarray) -> np.ndarray:
        """:meth:`hypervolume` of each set of a ``[G, r, m]`` stack, as
        float64 ``[G]``, bit for bit.  On the device engines the sets with
        points inside a non-empty finite box are counted together, in one
        call a device (the engine still resolved set by set from the set's
        own work); the rest go through :meth:`hypervolume` one by one."""
        sets = np.asarray(sets, dtype=float)
        reference = np.asarray(reference, dtype=float)
        G, _, m = sets.shape
        if self._use_exact(m) or self._engine == "numpy":
            return np.asarray([self.hypervolume(P, reference) for P in sets], dtype=float)
        out = np.zeros(G)
        keep = (sets <= reference).all(axis=2)  # [G, r]: the rows in the reference box
        n = keep.sum(axis=1)
        with np.errstate(invalid="ignore", over="ignore"):
            lo = np.where(keep[..., None], sets, np.inf).min(axis=1)  # [G, m]
            span = reference - lo
            box = np.prod(span, axis=1)
            live = (n > 0) & np.isfinite(box) & (box > 0.0)
        by_device: dict = {}
        for g in np.flatnonzero(live):
            eng, dev = _resolve(self._engine, int(n[g]) * self._n_samples, self._device)
            if eng == "numpy":
                out[g] = self._mc_stats(sets[g][keep[g]], reference)[0]
            else:
                by_device.setdefault((eng, dev), []).append(g)
        for (eng, dev), idx in by_device.items():
            idx = np.asarray(idx)
            pts = sets[idx][keep[idx]]  # the sets' kept rows, set after set
            offsets = np.concatenate([[0], np.cumsum(n[idx])]).astype(np.int32)
            to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
            counts = mc_hv_counts_sets if eng == "cuda" else mc_hv_counts_sets_ref
            _, total = counts(to(pts.astype(np.float32)), to(offsets), to(lo[idx]),
                              to(span[idx]), _uniform_draw(self._seed, self._n_samples, m, dev))
            scale = box[idx] / self._n_samples
            out[idx] = total.cpu().numpy().astype(float) * scale
        return out


def solve_hssp(
    points: np.ndarray,
    k: int,
    reference: np.ndarray,
    estimator: "HypervolumeEstimator | None" = None,
) -> np.ndarray:
    """Greedy hypervolume subset selection: pick ``k`` of ``points``
    approximately maximizing the joint hypervolume (the 1-1/e greedy of
    Guerreiro et al.).  Returns the selected row indices in pick order.
    MOTPE uses it to break ties on the boundary nondomination rank.  With an
    ``estimator`` every subset evaluation routes through its method policy,
    keeping the greedy tractable for many objectives.

    The evaluations come in batches: the singletons, then at each greedy
    step every remaining candidate's set together with the grown selection
    (:meth:`HypervolumeEstimator._hypervolumes`, one counting launch a step
    on the card), each set's hypervolume the float a call of its own
    gives."""
    points = np.asarray(points, dtype=float)
    n = len(points)
    k = min(int(k), n)
    if k <= 0:
        return np.zeros(0, dtype=np.int64)
    if estimator is not None:
        hv_sets = lambda sets: estimator._hypervolumes(sets, reference)  # noqa: E731
    else:
        hv_sets = lambda sets: np.asarray(  # noqa: E731
            [hypervolume(P, reference) for P in sets], dtype=float)
    contrib = hv_sets(points[:, None, :])
    selected: list[int] = []
    hv_selected = 0.0
    picked = np.zeros(n, dtype=bool)
    while len(selected) < k:
        i = int(np.argmax(np.where(picked, -np.inf, contrib)))
        picked[i] = True
        selected.append(i)
        if len(selected) == k:
            break
        # discount every remaining candidate by the volume it shares with the
        # newly picked point, relative to the set selected *before* the pick;
        # the last set is the selection with the pick, the next step's base
        rest = np.flatnonzero(~picked)
        sets = np.empty((len(rest) + 1, len(selected), points.shape[1]))
        sets[:, :-1] = points[selected[:-1]]
        sets[:-1, -1] = np.maximum(points[rest], points[i])
        sets[-1, -1] = points[i]
        hvs = hv_sets(sets)
        contrib[rest] -= hvs[:-1] - hv_selected
        hv_selected = float(hvs[-1])
    return np.asarray(selected, dtype=np.int64)


def default_reference_point(points: np.ndarray) -> np.ndarray:
    """MOTPE's reference-point heuristic: 1.1x the worst observed value per
    objective (0.9x for negative coordinates, epsilon for exact zeros)."""
    worst = np.max(points, axis=0)
    ref = np.maximum(1.1 * worst, 0.9 * worst)
    ref[ref == 0] = 1e-12
    return ref
