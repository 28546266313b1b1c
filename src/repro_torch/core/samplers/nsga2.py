"""NSGA-II multi-objective sampler (Deb et al., 2002) on the columnar engine.

Selection runs entirely on the observation store's ``(n_trials,
n_objectives)`` values matrix: one vectorized non-dominated sort + per-front
crowding distances (``core/moo.py``) rank the whole history, the best
``population_size`` rows form the elite pool, and parents come from binary
rank/crowding tournaments.  Variation happens in **model space** on the
store's parameter matrix — simulated binary crossover (SBX) + polynomial
mutation for numeric columns, uniform crossover + resample mutation for
categorical columns — so offspring feed straight back through the joint
block contract with no external-repr round trip.

The sampler implements ``sample_joint`` natively: one ``Study.ask(n)`` wave
is one generation (``joint_wave_size`` caps waves at ``population_size``),
produced by a single ranking + ``n`` vectorized tournaments/crossovers,
instead of n independent selection rounds.  The scalar path
(``sample_relative`` over the intersection space) produces one offspring per
trial through the same machinery.  Below ``population_size`` observations
the sampler declines and the uniform fallback seeds generation zero.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from ...kernels import ops as kops
from .. import moo
from ..distributions import BaseDistribution, CategoricalDistribution
from ..frozen import FrozenTrial, TrialState
from ..search_space import IntersectionSearchSpace
from .base import BaseSampler, sample_uniform_internal

if TYPE_CHECKING:
    from ..search_space import ParamGroup
    from ..study import Study

__all__ = ["NSGAIISampler"]


class NSGAIISampler(BaseSampler):
    def __init__(
        self,
        population_size: int = 24,
        crossover_prob: float = 0.9,
        swapping_prob: float = 0.5,
        mutation_prob: "float | None" = None,
        eta_crossover: float = 20.0,
        eta_mutation: float = 20.0,
        seed: int | None = None,
        engine: str = "auto",
        device: "str | torch.device | None" = None,
    ):
        """Args:
            population_size: elite pool size; also the generation (wave) size.
            crossover_prob: probability an offspring is crossed at all
                (otherwise it clones its first parent before mutation).
            swapping_prob: per-dimension probability of taking the second
                parent's SBX child / categorical gene.
            mutation_prob: per-dimension mutation probability
                (default ``1 / n_dims``).
            eta_crossover / eta_mutation: SBX / polynomial distribution
                indices (larger = offspring closer to parents).
            engine: ``"auto"`` (default) dispatches the non-dominated sort
                to the torch dominance compare on ``device`` once the
                history crosses the shared work threshold;
                ``"numpy"``/``"torch"``/``"cuda"`` force a path (see
                ``kernels/ops.py``).
            device: where the device engines run; ``None`` means the card.
                Every engine but ``"numpy"`` raises without a CUDA device
                unless ``device="cpu"`` is passed.
        """
        if population_size < 2:
            raise ValueError("population_size must be >= 2")
        if not 0.0 <= crossover_prob <= 1.0:
            raise ValueError("crossover_prob must be in [0, 1]")
        if not 0.0 <= swapping_prob <= 1.0:
            raise ValueError("swapping_prob must be in [0, 1]")
        if mutation_prob is not None and not 0.0 <= mutation_prob <= 1.0:
            raise ValueError("mutation_prob must be in [0, 1]")
        self._population_size = int(population_size)
        self._crossover_prob = float(crossover_prob)
        self._swapping_prob = float(swapping_prob)
        self._mutation_prob = mutation_prob
        self._eta_x = float(eta_crossover)
        self._eta_m = float(eta_mutation)
        self._engine = kops.validate_engine(engine)
        self._device = kops.resolve_device(engine, device)
        self._rng = np.random.RandomState(seed)
        self._space_calc = IntersectionSearchSpace()

    def reseed_rng(self, seed: int | None = None) -> None:
        self._rng = np.random.RandomState(seed)

    # -- selection on the columnar engine ---------------------------------------

    def _elite(self, study: "Study", names: list[str]):
        """``(P, ranks, crowd)`` — the elite pool's model-space parameter
        rows with their nondomination ranks and crowding distances — or
        ``None`` while generation zero is still being seeded.  One store
        snapshot, one dominance reduction, one crowding pass per front."""
        store = study.observations()
        version, states, Vmat, arity, _, cols = store.snapshot_mo()
        directions = study.directions
        with np.errstate(invalid="ignore"):
            valid = (
                (states == int(TrialState.COMPLETE))
                & (arity == len(directions))
                & np.isfinite(Vmat).all(axis=1)
            )
        n_rows = len(states)
        M = (
            np.stack([cols.get(n, np.full(n_rows, np.nan)) for n in names], axis=1)
            if names and n_rows else np.empty((n_rows, len(names)))
        )
        rows = valid & ~np.isnan(M).any(axis=1)
        idx = np.flatnonzero(rows)
        if len(idx) < self._population_size:
            return None
        L = moo.loss_matrix(Vmat[idx], directions)
        ranks = moo.nondomination_ranks(L, engine=self._engine, device=self._device)
        crowd = np.empty(len(idx))
        for r in np.unique(ranks):
            members = ranks == r
            crowd[members] = moo.crowding_distance(L[members])
        # elite = best population_size rows by (rank asc, crowding desc)
        order = np.lexsort((-crowd, ranks))[: self._population_size]
        return M[idx][order], ranks[order], crowd[order]

    def _tournament(self, ranks: np.ndarray, crowd: np.ndarray, n: int) -> np.ndarray:
        """``n`` binary-tournament winners (indices into the elite pool):
        lower rank wins, crowding distance breaks ties — all vectorized."""
        pool = len(ranks)
        a = self._rng.randint(pool, size=n)
        b = self._rng.randint(pool, size=n)
        a_wins = (ranks[a] < ranks[b]) | (
            (ranks[a] == ranks[b]) & (crowd[a] >= crowd[b])
        )
        return np.where(a_wins, a, b)

    # -- variation in model space ------------------------------------------------

    def _offspring(
        self, P: np.ndarray, ranks: np.ndarray, crowd: np.ndarray,
        dists: "list[BaseDistribution]", n: int,
    ) -> np.ndarray:
        """``n`` offspring rows from the elite pool: vectorized tournament
        selection, SBX + polynomial mutation on numeric columns, uniform
        crossover + resample mutation on categorical columns."""
        d = P.shape[1]
        rng = self._rng
        p1 = P[self._tournament(ranks, crowd, n)]
        p2 = P[self._tournament(ranks, crowd, n)]
        cat = np.asarray([isinstance(ds, CategoricalDistribution) for ds in dists])
        lows = np.empty(d)
        highs = np.empty(d)
        for j, ds in enumerate(dists):
            if cat[j]:
                lows[j], highs[j] = 0.0, float(len(ds.choices) - 1)  # type: ignore[attr-defined]
            else:
                lows[j], highs[j] = ds.internal_bounds(expand_int=True)
        span = np.where(highs > lows, highs - lows, 1.0)

        child = p1.copy()
        crossed = rng.uniform(size=n) < self._crossover_prob
        swap = rng.uniform(size=(n, d)) < self._swapping_prob

        # SBX on numeric columns: both children computed per pair, the swap
        # mask picks one per dimension
        u = rng.uniform(size=(n, d))
        beta = np.where(
            u <= 0.5,
            (2.0 * u) ** (1.0 / (self._eta_x + 1.0)),
            (1.0 / np.maximum(2.0 * (1.0 - u), 1e-12)) ** (1.0 / (self._eta_x + 1.0)),
        )
        c1 = 0.5 * ((1.0 + beta) * p1 + (1.0 - beta) * p2)
        c2 = 0.5 * ((1.0 - beta) * p1 + (1.0 + beta) * p2)
        sbx = np.where(swap, c2, c1)
        num = ~cat
        mix = crossed[:, None] & num[None, :]
        child[mix] = sbx[mix]
        # categorical columns: uniform crossover (take p2's gene where swapped)
        mixc = crossed[:, None] & cat[None, :] & swap
        child[mixc] = p2[mixc]

        # polynomial mutation (numeric) / resample mutation (categorical)
        p_mut = self._mutation_prob if self._mutation_prob is not None else 1.0 / max(d, 1)
        mut = rng.uniform(size=(n, d)) < p_mut
        um = rng.uniform(size=(n, d))
        delta = np.where(
            um < 0.5,
            (2.0 * um) ** (1.0 / (self._eta_m + 1.0)) - 1.0,
            1.0 - (2.0 * (1.0 - um)) ** (1.0 / (self._eta_m + 1.0)),
        )
        mutated = child + delta * span[None, :]
        mn = mut & num[None, :]
        child[mn] = mutated[mn]
        resample = lows[None, :] + rng.uniform(size=(n, d)) * (highs - lows + 1.0)[None, :]
        mc = mut & cat[None, :]
        child[mc] = np.floor(np.minimum(resample, highs[None, :] + 0.999))[mc]
        np.clip(child, lows[None, :], highs[None, :], out=child)
        return child

    # -- block (joint) contract ---------------------------------------------------

    def joint_enabled(self) -> bool:
        return True

    def joint_wave_size(self, study: "Study", requested: int) -> int:
        """One wave = one generation: never hand out more than
        ``population_size`` offspring from a single ranking."""
        return min(requested, self._population_size)

    def sample_joint(
        self, study: "Study", group: "ParamGroup", n: int,
        trial_ids: "list[int] | None" = None,
        first_number: "int | None" = None,
    ) -> "np.ndarray | None":
        names = list(group.names)
        elite = self._elite(study, names)
        if elite is None:
            return None
        P, ranks, crowd = elite
        dists = [group.dists[name] for name in names]
        return self._offspring(P, ranks, crowd, dists, n)

    # -- scalar path ---------------------------------------------------------------

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        return {
            n: d for n, d in self._space_calc.calculate(study).items() if not d.single()
        }

    def sample_relative(
        self, study: "Study", trial: FrozenTrial, search_space: dict[str, BaseDistribution]
    ) -> dict[str, Any]:
        if not search_space:
            return {}
        names = sorted(search_space)
        elite = self._elite(study, names)
        if elite is None:
            return {}
        P, ranks, crowd = elite
        dists = [search_space[n] for n in names]
        row = self._offspring(P, ranks, crowd, dists, 1)[0]
        return {
            name: ds.to_external_repr(float(ds.from_internal(np.asarray([v]))[0]))
            for name, ds, v in zip(names, dists, row)
        }

    def sample_independent(
        self, study: "Study", trial: FrozenTrial, param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        # generation zero + conditional params: uniform exploration
        internal = sample_uniform_internal(self._rng, param_distribution)
        return param_distribution.to_external_repr(internal)
