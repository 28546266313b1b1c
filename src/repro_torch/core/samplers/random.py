"""Uniform-random independent sampler (the paper's §5.1 baseline)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np

from ..distributions import BaseDistribution, CategoricalDistribution
from ..frozen import FrozenTrial
from .base import BaseSampler, sample_uniform_internal

if TYPE_CHECKING:
    from ..search_space import ParamGroup
    from ..study import Study

__all__ = ["RandomSampler"]


class RandomSampler(BaseSampler):
    def __init__(self, seed: int | None = None):
        self._rng = np.random.RandomState(seed)

    def reseed_rng(self, seed: int | None = None) -> None:
        self._rng = np.random.RandomState(seed)

    def sample_joint(
        self, study: "Study", group: "ParamGroup", n: int,
        trial_ids: "list[int] | None" = None,
        first_number: "int | None" = None,
    ) -> np.ndarray:
        """Uniform block: one vectorized ``sample_uniform`` draw per column
        instead of n x p scalar RNG calls."""
        block = np.empty((n, len(group.names)))
        for j, name in enumerate(group.names):
            dist = group.dists[name]
            draws = dist.sample_uniform(self._rng, n)
            if isinstance(dist, CategoricalDistribution):
                block[:, j] = draws  # already model-space choice indices
            else:
                block[:, j] = dist.to_internal(draws)
        return block

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        internal = sample_uniform_internal(self._rng, param_distribution)
        return param_distribution.to_external_repr(internal)
