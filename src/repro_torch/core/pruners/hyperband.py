"""Hyperband over ASHA brackets (beyond-paper; Li et al. 2018).

Hyperband hedges SHA's fixed aggressiveness by running several SHA brackets
with different minimum early-stopping rates ``s``.  Each trial is hashed into
a bracket (deterministic in trial number, so distributed workers agree without
coordination), and within a bracket the paper's Algorithm 1 applies.
Bracket sizes follow the standard Hyperband budget allocation.

Vectorized: bracket assignment is one hashed vector op over the store's row
numbers (Knuth multiplicative hash + ``searchsorted`` into the cumulative
bracket weights), producing the peer mask the bracket's SHA decision applies
— the old per-trial study-view filter re-hashed every trial per decision.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import numpy as np

from ..frozen import FrozenTrial, StudyDirection
from .base import BasePruner
from .successive_halving import SuccessiveHalvingPruner

if TYPE_CHECKING:
    from ..records import IntermediateValueStore
    from ..study import Study

__all__ = ["HyperbandPruner"]


class HyperbandPruner(BasePruner):
    def __init__(
        self,
        min_resource: int = 1,
        max_resource: int = 64,
        reduction_factor: int = 4,
    ):
        self._r = min_resource
        self._R = max_resource
        self._eta = reduction_factor
        n_brackets = int(math.log(max(self._R // self._r, 1), self._eta)) + 1
        self._pruners = [
            SuccessiveHalvingPruner(
                min_resource=min_resource,
                reduction_factor=reduction_factor,
                min_early_stopping_rate=s,
            )
            for s in range(n_brackets)
        ]
        # standard hyperband allocation: bracket s gets weight ~ (eta^s)/(s+1)
        weights = [self._eta**s / (s + 1) for s in range(n_brackets)]
        total = sum(weights)
        self._cum = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self._cum.append(acc)
        self._cum_arr = np.asarray(self._cum)

    @property
    def n_brackets(self) -> int:
        return len(self._pruners)

    def spec(self) -> "dict | None":
        if not self._fusable(HyperbandPruner):
            return None
        return {
            "name": "hyperband",
            "min_resource": self._r,
            "max_resource": self._R,
            "reduction_factor": self._eta,
        }

    def bracket_of(self, trial: FrozenTrial) -> int:
        return int(self.brackets_of(np.asarray([trial.number]))[0])

    def brackets_of(self, numbers: np.ndarray) -> np.ndarray:
        """Deterministic, coordination-free bracket assignment, batched:
        h = (number * 2654435761) mod 2^32 / 2^32, first cumulative weight
        >= h wins."""
        h = (numbers.astype(np.int64) * 2654435761) % (2**32) / 2**32
        idx = np.searchsorted(self._cum_arr, h, side="left")
        return np.minimum(idx, len(self._cum) - 1)

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        return self.decide(study.direction, study.intermediate_values(), trial)

    def decide(
        self, direction: StudyDirection, store: "IntermediateValueStore",
        trial: FrozenTrial,
    ) -> bool:
        bracket = self.bracket_of(trial)
        # hold the store lock across mask construction *and* the SHA decision
        # (reentrant), so a concurrent refresh cannot grow the rows between
        # the two and misalign the bracket mask
        with store.lock():
            peer_mask = self.brackets_of(np.arange(store.n_rows)) == bracket
            return self._pruners[bracket]._decide_masked(
                direction, store, trial, peer_mask
            )
