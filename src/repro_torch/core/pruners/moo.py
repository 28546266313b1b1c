"""Pareto-aware pruning: scalarize multi-objective reports onto the fused path.

Pruning is a single-objective concept: without a scalarizer a
multi-objective ``Trial.report`` stores a bare intermediate value and
``should_prune`` decides nothing.  :class:`ParetoPruner` closes that gap
without teaching the storage layer about vectors of intermediate values:

* the worker reports a **vector** of per-objective intermediate values;
* the pruner scalarizes it client-side with the augmented Chebyshev
  (reference-point) function — a standard Pareto-compliant scalarization:
  if one vector dominates another, its scalarized value is strictly smaller,
  so ranking scalarized curves never promotes a dominated trial;
* the scalar rides the **existing** fused ``report_and_prune`` storage op,
  with the wrapped single-objective pruner deciding on the scalarized
  stream under an always-MINIMIZE direction.

The scalarized values are what lands in storage (and therefore in the
intermediate-value store's matrix): one consistent stream that every
vectorized pruner can rank, at the cost of not persisting per-objective
learning curves — callers that need those record them as user attrs.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

from ..frozen import FrozenTrial, StudyDirection
from .base import BasePruner

if TYPE_CHECKING:
    from ..records import IntermediateValueStore
    from ..study import Study

__all__ = ["ParetoPruner"]


class ParetoPruner(BasePruner):
    """Wraps a single-objective pruner for multi-objective studies.

    Args:
        wrapped: the pruner judging the scalarized stream (any fusable
            built-in: median/percentile/sha/hyperband/threshold/patient...).
        reference_point: per-objective aspiration levels in **raw study
            orientation** (defaults to all zeros).  Values are oriented to
            minimize-losses before the reference point is subtracted.
        weights: per-objective scalarization weights (default uniform).
        rho: augmentation factor of the Chebyshev term — ``0`` gives the pure
            weighted max, small positive values break ties toward vectors
            better on the remaining objectives.
    """

    def __init__(
        self,
        wrapped: BasePruner,
        reference_point: "Sequence[float] | None" = None,
        weights: "Sequence[float] | None" = None,
        rho: float = 0.05,
    ):
        if wrapped is None:
            raise ValueError("ParetoPruner needs a wrapped single-objective pruner")
        if rho < 0:
            raise ValueError("rho must be >= 0")
        self._wrapped = wrapped
        self._reference = list(reference_point) if reference_point is not None else None
        self._weights = list(weights) if weights is not None else None
        self._rho = float(rho)

    # -- scalarization (the hook Trial.report dispatches on) --------------------

    def scalarize(self, values: Sequence[float], directions: Sequence[StudyDirection]) -> float:
        """Augmented Chebyshev value of one report vector: ``max_k w_k (l_k -
        r_k) + rho * sum_k w_k (l_k - r_k)`` over minimize-oriented losses
        ``l``.  Strictly monotone in every objective, so dominance order is
        preserved on the scalarized stream."""
        m = len(directions)
        if len(values) != m:
            raise ValueError(
                f"report carries {len(values)} values for {m} study directions"
            )
        ref = self._reference if self._reference is not None else [0.0] * m
        w = self._weights if self._weights is not None else [1.0 / m] * m
        if len(ref) != m or len(w) != m:
            raise ValueError("reference_point/weights arity does not match directions")
        terms = []
        for v, d, r, wk in zip(values, directions, ref, w):
            loss = float(v) if d == StudyDirection.MINIMIZE else -float(v)
            terms.append(wk * (loss - r))
        return max(terms) + self._rho * sum(terms)

    # -- pruner interface --------------------------------------------------------

    def spec(self) -> "dict | None":
        if not self._fusable(ParetoPruner):
            return None
        wrapped_spec = self._wrapped.spec()
        if wrapped_spec is None:
            return None  # wrapped pruner cannot cross the wire -> no fusion
        return {
            "name": "pareto",
            "wrapped": wrapped_spec,
            "reference_point": self._reference,
            "weights": self._weights,
            "rho": self._rho,
        }

    def decide(
        self, direction: StudyDirection, store: "IntermediateValueStore",
        trial: FrozenTrial,
    ) -> bool:
        # the stored stream is already scalarized to a loss: the wrapped
        # pruner always judges it as MINIMIZE, whatever the study directions
        return self._wrapped.decide(StudyDirection.MINIMIZE, store, trial)

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        return self._wrapped.decide(
            StudyDirection.MINIMIZE, study.intermediate_values(), trial
        )
