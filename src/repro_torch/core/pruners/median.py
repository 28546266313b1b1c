"""Median / percentile pruning — the Vizier-style baseline of Fig. 11a.

Vectorized: one decision is a column slice of the intermediate-value store's
cached best-so-far matrix plus one ``np.percentile`` — O(n_trials) numpy work
instead of a Python re-walk of every peer's ``intermediate_values`` dict
(the reference's parity suite asserts bit-identical decisions against its
scalar twin).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import BasePruner

if TYPE_CHECKING:
    from ..records import IntermediateValueStore
    from ..study import Study

__all__ = ["MedianPruner", "PercentilePruner"]


def _best_until(trial: FrozenTrial, upto: int, minimize: bool) -> "float | None":
    vals = [v for s, v in trial.intermediate_values.items() if s <= upto and v == v]
    if not vals:
        return None
    return min(vals) if minimize else max(vals)


class PercentilePruner(BasePruner):
    """Prune if the trial's best-so-far intermediate value is worse than the
    given percentile of peer best-so-far values at the same step.

    Peer semantics (pinned by the reference's ``tests/test_pruners.py``): the peer set is
    **COMPLETE trials only** — RUNNING and PRUNED trials are excluded,
    matching Optuna's percentile/median pruners.  Contrast with
    :class:`~.successive_halving.SuccessiveHalvingPruner`, which by ASHA's
    asynchronous design ranks against RUNNING (and PRUNED) peers as well.
    """

    def __init__(
        self,
        percentile: float,
        n_startup_trials: int = 5,
        n_warmup_steps: int = 0,
        interval_steps: int = 1,
    ):
        if not 0.0 <= percentile <= 100.0:
            raise ValueError("percentile must be in [0, 100]")
        if n_startup_trials < 0 or n_warmup_steps < 0 or interval_steps < 1:
            raise ValueError("invalid pruner configuration")
        self._q = percentile
        self._n_startup = n_startup_trials
        self._warmup = n_warmup_steps
        self._interval = interval_steps

    def spec(self) -> "dict | None":
        if not self._fusable(PercentilePruner, MedianPruner):
            return None
        return {
            "name": "percentile",
            "percentile": self._q,
            "n_startup_trials": self._n_startup,
            "n_warmup_steps": self._warmup,
            "interval_steps": self._interval,
        }

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        return self.decide(study.direction, study.intermediate_values(), trial)

    def decide(
        self, direction: StudyDirection, store: "IntermediateValueStore",
        trial: FrozenTrial,
    ) -> bool:
        step = trial.last_step
        if step is None or step < self._warmup:
            return False
        if (step - self._warmup) % self._interval != 0:
            return False

        minimize = direction == StudyDirection.MINIMIZE
        with store.lock():
            col = store.index_upto(step)
            if col < 0:
                peers = np.empty(0)
            else:
                bsf = store.best_so_far(minimize)[:, col]
                mask = (store.states == int(TrialState.COMPLETE)) & (
                    store.trial_ids != trial.trial_id
                )
                peers = bsf[mask]
                peers = peers[~np.isnan(peers)]
        if len(peers) < self._n_startup:
            return False

        mine = _best_until(trial, step, minimize)
        if mine is None:
            return False
        if mine != mine:  # NaN
            return True
        cutoff = float(np.percentile(peers, self._q if minimize else 100.0 - self._q))
        return mine > cutoff if minimize else mine < cutoff


class MedianPruner(PercentilePruner):
    """PercentilePruner at the median (the pruner Vizier features; paper
    Fig. 11a shows ASHA dominating it)."""

    def __init__(
        self, n_startup_trials: int = 5, n_warmup_steps: int = 0, interval_steps: int = 1
    ):
        super().__init__(50.0, n_startup_trials, n_warmup_steps, interval_steps)
