"""Sampler interface.

The split mirrors the paper's two sampling families (§3.1):

* ``sample_independent`` — per-parameter sampling (random, TPE), invoked for
  every parameter not covered by the relational stage.
* ``infer_relative_search_space`` + ``sample_relative`` — relational sampling
  over the inferred concurrence relations (CMA-ES, GP), invoked once per
  trial before any suggest call resolves.
* ``sample_joint`` — block sampling: one call covers **all pending trials**
  of a batched ``Study.ask(n)`` for one co-observed parameter group
  (``search_space.ParamGroup``), returning an ``(n, len(group))`` matrix of
  model-space rows.  The define-by-run ``suggest_*`` API then *slices* the
  precomputed block instead of sampling per (trial, parameter); trials whose
  runtime search space diverges from the group prediction fall back to
  scalar sampling (see ``Trial._sample``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np

from ..distributions import BaseDistribution
from ..frozen import FrozenTrial

if TYPE_CHECKING:
    from ..search_space import ParamGroup
    from ..study import Study

__all__ = ["BaseSampler", "sample_uniform_internal"]


class BaseSampler:
    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        return {}

    def sample_relative(
        self, study: "Study", trial: FrozenTrial, search_space: dict[str, BaseDistribution]
    ) -> dict[str, Any]:
        return {}

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        raise NotImplementedError

    # -- block (joint) sampling -------------------------------------------------

    def joint_enabled(self) -> bool:
        """Whether ``Study.ask(n)`` should presample joint blocks with this
        sampler at all.  The default detects a ``sample_joint`` override, so
        custom samplers keep the per-trial path untouched; samplers with a
        mode switch (TPE's ``multivariate=``) override this with the flag."""
        return type(self).sample_joint is not BaseSampler.sample_joint

    def sample_joint(
        self,
        study: "Study",
        group: "ParamGroup",
        n: int,
        trial_ids: "list[int] | None" = None,
        first_number: "int | None" = None,
    ) -> "np.ndarray | None":
        """Sample one ``(n, len(group.names))`` block of **model-space** rows
        for ``n`` pending trials of one co-observed parameter group.

        Return ``None`` to decline the whole group (no joint model yet —
        startup, warmup, ...): those parameters then go through the ordinary
        per-trial relational/independent path.  A returned block may carry
        ``NaN`` cells to decline individual columns (e.g. CMA-ES excludes
        categoricals); NaN cells silently fall back to scalar sampling
        without counting as a group-prediction miss.

        ``trial_ids`` are the storage ids of the pending trials, for
        samplers whose joint draw has per-trial side effects (the grid
        sampler claims one cell per trial).  ``first_number`` is the first
        pending trial's storage-assigned number — the wave's RNG key for
        samplers that derive per-wave streams deterministically (CMA-ES):
        concurrent workers hold disjoint numbers, so identical histories no
        longer yield identical blocks.  Column order is ``group.names``;
        row ``i`` belongs to pending trial ``i``.
        """
        return None

    def joint_wave_size(self, study: "Study", requested: int) -> int:
        """Preferred ``ask(n)`` wave size, given the caller wants up to
        ``requested`` trials.  Generation-based samplers (CMA-ES, NSGA-II)
        cap this at their population size so every wave maps onto exactly one
        generation — asking past it would draw from a stale replayed state
        that a between-wave refit will contradict.  Batched loops
        (``Study.optimize(ask_batch=)``) consult this before each
        ``ask(n)``; plain callers of ``ask(n)`` are unaffected."""
        return requested

    def reseed_rng(self, seed: int | None = None) -> None:
        """Re-seed internal RNGs.  Workers call this with a distinct per-worker
        seed so exploration streams are deterministic but non-overlapping;
        ``None`` reseeds from OS entropy."""

    def after_trial(self, study: "Study", trial: FrozenTrial, state, values) -> None:
        pass


def sample_uniform_internal(rng: np.random.RandomState, dist: BaseDistribution) -> float:
    """Uniform sample in *internal* representation, honoring log/step.

    Thin scalar wrapper over the vectorized ``BaseDistribution.sample_uniform``
    codec — the ``size=1`` draw consumes the RNG stream exactly as the
    historical scalar implementation did, so seeded studies reproduce."""
    return float(dist.sample_uniform(rng, 1)[0])
