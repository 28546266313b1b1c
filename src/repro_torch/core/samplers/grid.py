"""Exhaustive grid sampler.

The grid is declared up front (it cannot be define-by-run by nature), but the
objective remains define-by-run: parameters outside the grid fall back to the
independent sampler.  Grid slots are claimed through study system attrs so
distributed workers never evaluate the same cell twice.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Any, Mapping, Sequence

import numpy as np

from ..distributions import BaseDistribution
from ..frozen import FrozenTrial, TrialState
from ..records import _GRID_ATTR as _GRID_KEY  # one key, shared with the store
from .base import BaseSampler, sample_uniform_internal

if TYPE_CHECKING:
    from ..search_space import ParamGroup
    from ..study import Study

__all__ = ["GridSampler"]


class GridSampler(BaseSampler):
    def __init__(self, search_space: Mapping[str, Sequence[Any]], seed: int | None = None):
        self._space = {k: list(v) for k, v in sorted(search_space.items())}
        self._grid = list(itertools.product(*self._space.values()))
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self._grid)

    def _taken(self, study: "Study") -> set[int]:
        """Claimed grid cells: finished trials' ids come straight off the
        observation store's ``grid_ids`` column (one vector op, incremental);
        only the handful of live RUNNING trials still need a per-trial look."""
        obs = getattr(study, "observations", None)
        if not callable(obs):  # duck-typed study: scalar fallback
            taken: set[int] = set()
            for t in study.get_trials(deepcopy=False):
                gid = t.system_attrs.get(_GRID_KEY)
                if gid is not None and (t.state.is_finished() or t.state == TrialState.RUNNING):
                    taken.add(int(gid))
            return taken
        gids = obs().grid_ids
        taken = set(np.unique(gids[gids >= 0]).tolist())
        for t in study.get_trials(deepcopy=False, states=(TrialState.RUNNING,)):
            gid = t.system_attrs.get(_GRID_KEY)
            if gid is not None:
                taken.add(int(gid))
        return taken

    def sample_joint(
        self, study: "Study", group: "ParamGroup", n: int,
        trial_ids: "list[int] | None" = None,
        first_number: "int | None" = None,
    ) -> "np.ndarray | None":
        """Claim ``n`` distinct free cells with **one** ``_taken`` scan and
        one batched attr write, instead of n independent scan+claim rounds.
        Only the grid's own parameters are filled; co-observed off-grid
        columns stay NaN (scalar uniform fallback, matching
        ``sample_independent``)."""
        gnames = list(self._space.keys())
        cols = {name: j for j, name in enumerate(group.names)}
        if trial_ids is None or not all(name in cols for name in gnames):
            # the grid is claimed all-or-nothing: a group covering only part
            # of it (can't happen for self-consistent objectives) or a caller
            # without trial ids falls back to the per-trial claim path
            return None
        taken = self._taken(study)
        free = [i for i in range(len(self._grid)) if i not in taken]
        gids = free[:n]
        while len(gids) < n:  # exhausted: re-visit at random (keeps totals)
            gids.append(int(self._rng.randint(len(self._grid))))
        storage = study._storage
        call_batch = getattr(storage, "call_batch", None)
        claims = [
            ("set_trial_system_attr", (tid, _GRID_KEY, gid))
            for tid, gid in zip(trial_ids, gids)
        ]
        if call_batch is not None and len(claims) > 1:
            call_batch(claims)  # one frame claims the whole wave
        else:
            for method, params in claims:
                getattr(storage, method)(*params)
        block = np.full((n, len(group.names)), np.nan)
        for k, name in enumerate(gnames):
            dist = group.dists[name]
            values = [self._grid[gid][k] for gid in gids]
            block[:, cols[name]] = dist.to_internal(values)
        return block

    def sample_relative(
        self, study: "Study", trial: FrozenTrial, search_space: dict[str, BaseDistribution]
    ) -> dict[str, Any]:
        taken = self._taken(study)
        free = [i for i in range(len(self._grid)) if i not in taken]
        if not free:
            # grid exhausted: re-visit at random (keeps optimize(n_trials=...) total)
            gid = int(self._rng.randint(len(self._grid)))
        else:
            gid = free[0]
        study._storage.set_trial_system_attr(trial.trial_id, _GRID_KEY, gid)
        return dict(zip(self._space.keys(), self._grid[gid]))

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        # the relative params are injected by value; no distribution needed
        return {}

    def sample_independent(
        self, study: "Study", trial: FrozenTrial, param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        internal = sample_uniform_internal(self._rng, param_distribution)
        return param_distribution.to_external_repr(internal)

    def is_exhausted(self, study: "Study") -> bool:
        return len(self._taken(study)) >= len(self._grid)
