"""CMA-ES relational sampler over the inferred concurrence relations.

Implements the full (mu/mu_w, lambda)-CMA-ES of Hansen & Ostermeier (2001)
with rank-one + rank-mu covariance updates and step-size control (CSA), on
the intersection search space (paper §3.1): after enough independently
sampled trials reveal which parameters co-occur in every trial, CMA-ES takes
over those parameters; anything conditional falls back to the independent
sampler.

Distributed-safety: instead of persisting mutable optimizer state (which
races under async workers), the CMA state is *deterministically replayed*
from the completed-trial history in generation batches of ``popsize`` — every
worker reconstructs the same state from the same storage contents, so no
coordination beyond the storage is needed.  Replay is O(n_trials · d²),
negligible next to a training trial.

``TPESampler`` + ``CmaEsSampler(warmup_trials=40)`` reproduces the paper's
§5.1 "TPE+CMA-ES" mixture: TPE explores for the first 40 trials, CMA-ES
exploits after.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any

import numpy as np

from ..distributions import (
    BaseDistribution,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
    round_to_step,
)
from ..frozen import FrozenTrial, StudyDirection
from ..search_space import IntersectionSearchSpace
from .base import BaseSampler
from .random import RandomSampler

if TYPE_CHECKING:
    from ..search_space import ParamGroup
    from ..study import Study

__all__ = ["CmaEsSampler", "CMA"]


class CMA:
    """Minimal-state CMA-ES engine on [0,1]^d (normalized coordinates)."""

    def __init__(self, mean: np.ndarray, sigma: float, seed: int | None = None):
        d = len(mean)
        self.dim = d
        self.mean = mean.astype(float).copy()
        self.sigma = float(sigma)
        self.C = np.eye(d)
        self.pc = np.zeros(d)
        self.ps = np.zeros(d)
        self.generation = 0

        self.popsize = 4 + int(3 * math.log(d)) if d > 0 else 4
        mu = self.popsize // 2
        w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        self.weights = w / w.sum()
        self.mu_eff = 1.0 / np.sum(self.weights**2)

        self.c_sigma = (self.mu_eff + 2) / (d + self.mu_eff + 5)
        self.d_sigma = (
            1 + 2 * max(0.0, math.sqrt((self.mu_eff - 1) / (d + 1)) - 1) + self.c_sigma
        )
        self.c_c = (4 + self.mu_eff / d) / (d + 4 + 2 * self.mu_eff / d)
        self.c_1 = 2 / ((d + 1.3) ** 2 + self.mu_eff)
        self.c_mu = min(
            1 - self.c_1,
            2 * (self.mu_eff - 2 + 1 / self.mu_eff) / ((d + 2) ** 2 + self.mu_eff),
        )
        self.chi_n = math.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d * d))
        self._eig_cache: tuple[np.ndarray, np.ndarray] | None = None

    def _eig(self) -> tuple[np.ndarray, np.ndarray]:
        if self._eig_cache is None:
            self.C = 0.5 * (self.C + self.C.T)
            vals, vecs = np.linalg.eigh(self.C)
            vals = np.maximum(vals, 1e-20)
            self._eig_cache = (vals, vecs)
        return self._eig_cache

    def ask(self, rng: np.random.RandomState) -> np.ndarray:
        vals, vecs = self._eig()
        z = rng.standard_normal(self.dim)
        y = vecs @ (np.sqrt(vals) * z)
        x = self.mean + self.sigma * y
        return np.clip(x, 0.0, 1.0)

    def tell(self, solutions: list[tuple[np.ndarray, float]]) -> None:
        """Update with one full generation: [(x in [0,1]^d, loss)], len==popsize."""
        solutions = sorted(solutions, key=lambda s: s[1])
        mu = len(self.weights)
        xs = np.stack([s[0] for s in solutions[:mu]])
        y_w = (xs - self.mean[None, :]) / max(self.sigma, 1e-30)
        y_mean = self.weights @ y_w

        vals, vecs = self._eig()
        inv_sqrt = vecs @ np.diag(1.0 / np.sqrt(vals)) @ vecs.T

        self.mean = self.mean + self.sigma * y_mean
        self.ps = (1 - self.c_sigma) * self.ps + math.sqrt(
            self.c_sigma * (2 - self.c_sigma) * self.mu_eff
        ) * (inv_sqrt @ y_mean)
        ps_norm = float(np.linalg.norm(self.ps))
        h_sigma = ps_norm / math.sqrt(
            1 - (1 - self.c_sigma) ** (2 * (self.generation + 1))
        ) < (1.4 + 2 / (self.dim + 1)) * self.chi_n
        self.pc = (1 - self.c_c) * self.pc + (
            math.sqrt(self.c_c * (2 - self.c_c) * self.mu_eff) * y_mean if h_sigma else 0.0
        )
        delta_h = (1 - h_sigma) * self.c_c * (2 - self.c_c)
        rank_one = np.outer(self.pc, self.pc)
        rank_mu = (y_w * self.weights[:, None]).T @ y_w
        self.C = (
            (1 + self.c_1 * delta_h - self.c_1 - self.c_mu) * self.C
            + self.c_1 * rank_one
            + self.c_mu * rank_mu
        )
        self.sigma = self.sigma * math.exp(
            (self.c_sigma / self.d_sigma) * (ps_norm / self.chi_n - 1)
        )
        self.sigma = float(np.clip(self.sigma, 1e-8, 1e3))
        self.generation += 1
        self._eig_cache = None


class CmaEsSampler(BaseSampler):
    def __init__(
        self,
        warmup_trials: int = 40,
        independent_sampler: BaseSampler | None = None,
        seed: int | None = None,
        sigma0: float = 0.25,
    ):
        """Args:
            warmup_trials: trials sampled by ``independent_sampler`` before
                CMA-ES engages (the paper used TPE for the first 40 steps).
            independent_sampler: fallback for warmup + conditional params
                (defaults to :class:`RandomSampler`).
        """
        self._warmup = warmup_trials
        self._independent = independent_sampler or RandomSampler(seed=seed)
        self._seed = seed
        self._sigma0 = sigma0
        self._space_calc = IntersectionSearchSpace()

    def reseed_rng(self, seed: int | None = None) -> None:
        self._seed = seed
        self._independent.reseed_rng(seed)

    # -- relational interface ----------------------------------------------------

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        space = self._space_calc.calculate(study)
        # CMA-ES needs >= 2 numeric dims; categoricals are excluded (handled
        # independently), single-point domains carry no information.
        out = {}
        for name, dist in space.items():
            if isinstance(dist, CategoricalDistribution) or dist.single():
                continue
            out[name] = dist
        return out if len(out) >= 2 else {}

    def _replayed_cma(
        self, study: "Study", names: list[str], search_space: dict[str, BaseDistribution]
    ) -> "tuple[CMA, int] | None":
        """Deterministically replay the completed-trial history into a CMA
        state (see the module docstring), or None while still in warmup.
        Returns ``(cma, n_observations)``; the observation count keys the
        joint path's per-wave RNG."""
        # the design matrix comes straight from the columnar observation
        # store (model space, trial-number order) — no FrozenTrial re-walk
        Xi, y0 = study.observations().design_matrix(names)
        if len(Xi) < self._warmup:
            return None

        sign = 1.0 if study.direction == StudyDirection.MINIMIZE else -1.0
        U = np.empty_like(Xi)
        for j, n in enumerate(names):
            U[:, j] = search_space[n].internal_to_unit(Xi[:, j])
        losses = sign * y0

        # feed completed post-warmup trials to CMA in generation batches of
        # popsize, in trial-number order
        cma = CMA(
            mean=np.full(len(names), 0.5),
            sigma=self._sigma0,
            seed=self._seed,
        )
        start = self._warmup - 1 if self._warmup > 0 else 0
        batch: list[tuple[np.ndarray, float]] = []
        for i in range(start, len(U)):
            batch.append((U[i], float(losses[i])))
            if len(batch) == cma.popsize:
                cma.tell(batch)
                batch = []
        return cma, len(U)

    def sample_relative(
        self, study: "Study", trial: FrozenTrial, search_space: dict[str, BaseDistribution]
    ) -> dict[str, Any]:
        if not search_space:
            return {}
        names = sorted(search_space.keys())
        replayed = self._replayed_cma(study, names, search_space)
        if replayed is None:
            return {}
        cma, _ = replayed
        rng = np.random.RandomState(
            None if self._seed is None else (self._seed + 7919 * trial.number)
        )
        x = cma.ask(rng)
        return {n: _from_unit(search_space[n], float(v)) for n, v in zip(names, x)}

    def _cma_space(self, study: "Study") -> dict[str, BaseDistribution]:
        return {
            name: dist
            for name, dist in self._space_calc.calculate(study).items()
            if not isinstance(dist, CategoricalDistribution) and not dist.single()
        }

    def joint_wave_size(self, study: "Study", requested: int) -> int:
        """Cap batched waves at the CMA population size so each ``ask(n)``
        block is one generation: a wave larger than popsize would draw its
        surplus rows from the same replayed state, even though the first
        popsize results will move the mean/covariance before those rows
        could have been sampled in sequential CMA-ES.  The popsize formula
        needs only the space dimension, so no history replay happens here."""
        d = len(self._cma_space(study))
        if d < 2:
            return requested  # CMA not engaged: no generation structure
        popsize = 4 + int(3 * math.log(d))
        return min(requested, popsize)

    def sample_joint(
        self, study: "Study", group: "ParamGroup", n: int,
        trial_ids: "list[int] | None" = None,
        first_number: "int | None" = None,
    ) -> "np.ndarray | None":
        """One history replay per wave (instead of per trial), then ``n``
        population draws.  Columns outside the CMA space — categoricals,
        single-point domains, conditional params — stay NaN and fall back to
        per-trial independent sampling, mirroring the scalar path."""
        space = self._cma_space(study)
        if len(space) < 2 or not set(space) <= set(group.names):
            return None
        names = sorted(space.keys())
        replayed = self._replayed_cma(study, names, space)
        if replayed is None:
            return None
        cma, n_obs = replayed
        # wave-deterministic stream keyed on the first pending trial's number
        # (the same 7919 multiplier the scalar path applies per trial):
        # concurrent workers claim disjoint numbers, so identical histories
        # no longer collapse into identical blocks.  History length remains
        # the fallback for callers that invoke the block contract directly.
        key = first_number if first_number is not None else n_obs
        rng = np.random.RandomState(
            None if self._seed is None else (self._seed + 7919 * key)
        )
        cols = {name: j for j, name in enumerate(group.names)}
        block = np.full((n, len(group.names)), np.nan)
        for i in range(n):
            x = cma.ask(rng)
            for name, u in zip(names, x):
                dist = space[name]
                ext = _from_unit(dist, float(u))
                block[i, cols[name]] = float(dist.to_internal([ext])[0])
        return block

    def sample_independent(
        self, study: "Study", trial: FrozenTrial, param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        return self._independent.sample_independent(
            study, trial, param_name, param_distribution
        )


def _to_unit(dist: BaseDistribution, external: Any) -> float:
    """Scalar external -> [0,1].  The batched path goes through the
    observation store + ``BaseDistribution.internal_to_unit`` instead."""
    v = dist.to_internal_repr(external)
    if isinstance(dist, (FloatDistribution, IntDistribution)):
        lo, hi = float(dist.low), float(dist.high)
        if dist.log:
            lo, hi = math.log(lo), math.log(hi)
            v = math.log(max(v, 1e-300))
        return (v - lo) / (hi - lo) if hi > lo else 0.5
    return v


def _from_unit(dist: BaseDistribution, u: float) -> Any:
    u = float(np.clip(u, 0.0, 1.0))
    lo, hi = float(dist.low), float(dist.high)
    if dist.log:
        lo_, hi_ = math.log(lo), math.log(hi)
        v = math.exp(lo_ + u * (hi_ - lo_))
    else:
        v = lo + u * (hi - lo)
    if isinstance(dist, IntDistribution):
        return int(np.clip(round_to_step(v, dist.low, dist.high, dist.step), dist.low, dist.high))
    if isinstance(dist, FloatDistribution) and dist.step is not None:
        return float(np.clip(round_to_step(v, dist.low, dist.high, dist.step), dist.low, dist.high))
    return float(np.clip(v, lo, hi))
