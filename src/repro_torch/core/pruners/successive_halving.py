"""Asynchronous Successive Halving — the paper's Algorithm 1, vectorized.

    Input: target trial `trial`, current step `step`, minimum resource r,
           reduction factor eta, minimum early-stopping rate s.
    Output: true if the trial should be pruned.

    1  rung <- max(0, log_eta(floor(step / r)) - s)
    2  if step != r * eta^(s+rung) then return false
    5  value <- get_trial_intermediate_value(trial, step)
    6  values <- get_all_trials_intermediate_values(step)
    7  top_k_values <- top_k(values, floor(|values| / eta))
    8  if top_k_values = empty then top_k_values <- top_k(values, 1)
    11 return value not in top_k_values

Line 6 is one column slice of the intermediate-value store (the exact-step
column, masked by state), and lines 7-11 reduce to an ``np.partition`` for
the k-th best — no sort, no per-trial dict walk.

Properties the tests pin down:

* **asynchronous** — a worker decides from whatever peer values exist *now*;
  it never waits for a rung cohort to fill (linear scaling, paper §5.3).
  Peer semantics (pinned by the reference's ``tests/test_pruners.py``): the peer set
  includes **RUNNING** trials (plus COMPLETE and PRUNED) — ASHA ranks
  against in-flight reports by design, unlike
  :class:`~.median.PercentilePruner`, whose peers are COMPLETE only.
* **no repechage** — a pruned trial is never resumed, so no snapshots of
  model state need to be stored (paper §3.2).
* when fewer than eta trials reached a rung, the best one is still promoted
  (line 8-10).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import numpy as np

from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import BasePruner

if TYPE_CHECKING:
    from ..records import IntermediateValueStore
    from ..study import Study

__all__ = ["SuccessiveHalvingPruner"]


class SuccessiveHalvingPruner(BasePruner):
    def __init__(
        self,
        min_resource: int = 1,
        reduction_factor: int = 4,
        min_early_stopping_rate: int = 0,
    ):
        if min_resource < 1:
            raise ValueError("min_resource must be >= 1")
        if reduction_factor < 2:
            raise ValueError("reduction_factor must be >= 2")
        if min_early_stopping_rate < 0:
            raise ValueError("min_early_stopping_rate must be >= 0")
        self._r = min_resource
        self._eta = reduction_factor
        self._s = min_early_stopping_rate

    def spec(self) -> "dict | None":
        if not self._fusable(SuccessiveHalvingPruner):
            return None
        return {
            "name": "successive_halving",
            "min_resource": self._r,
            "reduction_factor": self._eta,
            "min_early_stopping_rate": self._s,
        }

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        return self.decide(study.direction, study.intermediate_values(), trial)

    def decide(
        self, direction: StudyDirection, store: "IntermediateValueStore",
        trial: FrozenTrial,
    ) -> bool:
        return self._decide_masked(direction, store, trial, None)

    def _decide_masked(
        self, direction: StudyDirection, store: "IntermediateValueStore",
        trial: FrozenTrial, peer_mask: "np.ndarray | None",
    ) -> bool:
        """Algorithm 1 with an optional extra row mask (Hyperband restricts
        peers to the trial's bracket this way — no study-view indirection)."""
        step = trial.last_step
        if step is None:
            return False

        r, eta, s = self._r, self._eta, self._s

        # line 1: rung <- max(0, log_eta(floor(step/r)) - s)
        if step < r:
            return False
        rung = max(0, int(math.log(step // r, eta)) - s)

        # line 2: only act exactly at rung boundaries step == r * eta^(s+rung)
        if step != r * eta ** (s + rung):
            return False

        value = trial.intermediate_values[step]
        if value != value:  # NaN never survives a rung
            return True

        # line 6: all peer values at this step — one masked column slice
        with store.lock():
            col_vals = store.step_column(step)
            if col_vals is None:
                peer_vals = np.empty(0)
            else:
                states = store.states
                mask = (
                    (states == int(TrialState.COMPLETE))
                    | (states == int(TrialState.PRUNED))
                    | (states == int(TrialState.RUNNING))
                ) & (store.trial_ids != trial.trial_id) & ~np.isnan(col_vals)
                if peer_mask is not None:
                    mask &= peer_mask
                peer_vals = col_vals[mask]
        all_values = np.append(peer_vals, value)

        # lines 7-10: keep top floor(n/eta); if that's empty, keep the single
        # best — the k-th best is one np.partition, no full sort
        k = len(all_values) // eta
        if k == 0:
            k = 1
        if direction == StudyDirection.MINIMIZE:
            kth = np.partition(all_values, k - 1)[k - 1]
            return not value <= kth
        kth = np.partition(all_values, len(all_values) - k)[len(all_values) - k]
        return not value >= kth
