"""Samplers of this slice: random and TPE (CMA-ES, GP, grid and NSGA-II
arrive with later slices of the port)."""

from __future__ import annotations

from .base import BaseSampler
from .random import RandomSampler
from .tpe import TPESampler

__all__ = ["BaseSampler", "RandomSampler", "TPESampler"]
