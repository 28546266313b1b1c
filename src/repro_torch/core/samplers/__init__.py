"""Samplers of the port: random, TPE (with MOTPE), NSGA-II, CMA-ES, GP and
grid, with the reference package's names and defaults."""

from __future__ import annotations

import torch

from .base import BaseSampler
from .cmaes import CMA, CmaEsSampler
from .gp import GPSampler
from .grid import GridSampler
from .nsga2 import NSGAIISampler
from .random import RandomSampler
from .tpe import TPESampler

__all__ = [
    "BaseSampler",
    "RandomSampler",
    "GridSampler",
    "TPESampler",
    "CmaEsSampler",
    "CMA",
    "GPSampler",
    "NSGAIISampler",
    "make_sampler",
]


def make_sampler(
    name: str,
    seed: int | None = None,
    search_space: "dict | None" = None,
    engine: str = "auto",
    device: "str | torch.device | None" = None,
) -> BaseSampler:
    """Factory used by CLIs and benchmarks (``--sampler tpe+cmaes`` etc.).

    ``grid`` needs the grid declared up front (it cannot be define-by-run):
    pass ``search_space={"param": [choices, ...], ...}``.  ``engine`` and
    ``device`` go to the samplers that have a device engine (TPE, MOTPE,
    NSGA-II); as there, every engine but ``"numpy"`` needs a CUDA device
    unless ``device="cpu"`` is passed.
    """
    name = name.lower()
    if name == "random":
        return RandomSampler(seed=seed)
    if name == "tpe":
        return TPESampler(seed=seed, engine=engine, device=device)
    if name == "cmaes":
        return CmaEsSampler(seed=seed, warmup_trials=10)
    if name in ("tpe+cmaes", "tpe_cmaes"):
        # the paper's §5.1 mixture: TPE for the first 40 trials, CMA-ES after
        return CmaEsSampler(
            warmup_trials=40,
            independent_sampler=TPESampler(seed=seed, engine=engine, device=device),
            seed=seed,
        )
    if name == "gp":
        return GPSampler(seed=seed)
    if name == "nsga2":
        return NSGAIISampler(seed=seed, engine=engine, device=device)
    if name == "motpe":
        # MOTPE rides the multivariate joint path so batched waves get the
        # one-fit-per-group treatment on multi-objective studies too
        return TPESampler(
            seed=seed, multi_objective=True, multivariate=True, engine=engine, device=device
        )
    if name == "grid":
        if search_space is None:
            raise ValueError(
                "the grid sampler needs its cells declared up front: "
                "make_sampler('grid', search_space={'param': [values, ...]})"
            )
        return GridSampler(search_space, seed=seed)
    raise ValueError(f"unknown sampler {name!r}")
