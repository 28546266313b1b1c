"""Gaussian-process BO sampler (the paper's GPyOpt adversary, §5.1).

A compact GP-EI implementation: Matérn-5/2 kernel on [0,1]^d normalized
coordinates, cholesky posterior, expected-improvement acquisition optimized
by random multistart + coordinate refinement.  Sample-efficient but an order
of magnitude slower per suggest than TPE — exactly the trade-off the paper
measures (Fig. 10).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any

import numpy as np

from ..distributions import BaseDistribution, CategoricalDistribution
from ..frozen import FrozenTrial, StudyDirection
from ..search_space import IntersectionSearchSpace
from .base import BaseSampler
from .cmaes import _from_unit
from .random import RandomSampler

if TYPE_CHECKING:
    from ..search_space import ParamGroup
    from ..study import Study

__all__ = ["GPSampler"]


def _matern52(X: np.ndarray, Y: np.ndarray, ls: float) -> np.ndarray:
    d = np.sqrt(np.maximum(((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1), 1e-30)) / ls
    s5 = math.sqrt(5.0)
    return (1 + s5 * d + 5.0 / 3.0 * d * d) * np.exp(-s5 * d)


class GPSampler(BaseSampler):
    def __init__(
        self,
        n_startup_trials: int = 10,
        n_candidates: int = 512,
        seed: int | None = None,
        noise: float = 1e-6,
    ):
        self._n_startup = n_startup_trials
        self._n_candidates = n_candidates
        self._rng = np.random.RandomState(seed)
        self._noise = noise
        self._fallback = RandomSampler(seed=seed)
        self._space_calc = IntersectionSearchSpace()

    def reseed_rng(self, seed: int | None = None) -> None:
        self._rng = np.random.RandomState(seed)
        self._fallback.reseed_rng(seed)

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        space = self._space_calc.calculate(study)
        return {
            n: d
            for n, d in space.items()
            if not isinstance(d, CategoricalDistribution) and not d.single()
        }

    def _ei_candidates(
        self, study: "Study", names: list[str], search_space: dict[str, BaseDistribution]
    ) -> "tuple[np.ndarray, np.ndarray] | None":
        """Fit the GP once and return ``(candidates, ei)`` over the random
        candidate set in [0,1]^d, or None while still in startup."""
        sign = 1.0 if study.direction == StudyDirection.MINIMIZE else -1.0
        # design matrix straight from the columnar observation store: model
        # space -> [0,1] via the vectorized per-distribution codec
        Xi, y0 = study.observations().design_matrix(names)
        if len(Xi) < self._n_startup:
            return None
        X = np.empty_like(Xi)
        for j, n in enumerate(names):
            X[:, j] = search_space[n].internal_to_unit(Xi[:, j])
        y = sign * y0
        # standardize targets
        mu, std = y.mean(), max(y.std(), 1e-12)
        yz = (y - mu) / std

        # lightweight lengthscale selection by marginal likelihood over a grid
        best_ls, best_ml = 0.5, -np.inf
        for ls in (0.1, 0.2, 0.5, 1.0):
            K = _matern52(X, X, ls) + self._noise * np.eye(len(X))
            try:
                L = np.linalg.cholesky(K)
            except np.linalg.LinAlgError:
                continue
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, yz))
            ml = -0.5 * yz @ alpha - np.log(np.diag(L)).sum()
            if ml > best_ml:
                best_ml, best_ls = ml, ls
        ls = best_ls
        K = _matern52(X, X, ls) + self._noise * np.eye(len(X))
        L = np.linalg.cholesky(K + 1e-10 * np.eye(len(X)))
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yz))

        # EI over random candidates
        C = self._rng.uniform(size=(self._n_candidates, len(names)))
        Ks = _matern52(C, X, ls)
        mean = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.maximum(1.0 - (v**2).sum(0), 1e-12)
        sd = np.sqrt(var)
        best = yz.min()
        z = (best - mean) / sd
        ei = sd * (z * _ncdf(z) + _npdf(z))
        return C, ei

    def sample_relative(
        self, study: "Study", trial: FrozenTrial, search_space: dict[str, BaseDistribution]
    ) -> dict[str, Any]:
        if not search_space:
            return {}
        names = sorted(search_space)
        fitted = self._ei_candidates(study, names, search_space)
        if fitted is None:
            return {}
        C, ei = fitted
        x = C[int(np.argmax(ei))]
        return {n: _from_unit(search_space[n], float(u)) for n, u in zip(names, x)}

    def sample_joint(
        self, study: "Study", group: "ParamGroup", n: int,
        trial_ids: "list[int] | None" = None,
        first_number: "int | None" = None,
    ) -> "np.ndarray | None":
        """One GP fit per wave; the ``n`` pending trials take the top-n EI
        candidates (distinct acquisition optima) instead of re-fitting the
        posterior per trial.  Columns outside the GP space stay NaN."""
        space = {
            name: dist
            for name, dist in self._space_calc.calculate(study).items()
            if not isinstance(dist, CategoricalDistribution) and not dist.single()
        }
        if not space or not set(space) <= set(group.names):
            return None
        names = sorted(space)
        fitted = self._ei_candidates(study, names, space)
        if fitted is None:
            return None
        C, ei = fitted
        top = np.argsort(ei, kind="stable")[::-1][:n]
        cols = {name: j for j, name in enumerate(group.names)}
        block = np.full((n, len(group.names)), np.nan)
        for i, c in enumerate(top):
            for name, u in zip(names, C[c]):
                dist = space[name]
                ext = _from_unit(dist, float(u))
                block[i, cols[name]] = float(dist.to_internal([ext])[0])
        # fewer candidates than pending trials: recycle the best row
        for i in range(len(top), n):
            block[i] = block[i % max(len(top), 1)]
        return block

    def sample_independent(
        self, study: "Study", trial: FrozenTrial, param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        return self._fallback.sample_independent(study, trial, param_name, param_distribution)


def _ncdf(x: np.ndarray) -> np.ndarray:
    return 0.5 * (1 + np.vectorize(math.erf)(x / math.sqrt(2)))


def _npdf(x: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)
