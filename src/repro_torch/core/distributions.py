"""Parameter distributions for the define-by-run search space.

A distribution describes the domain a single ``trial.suggest_*`` call samples
from.  Because the search space is constructed *dynamically* (define-by-run),
distributions are recorded per-(trial, parameter) in storage, and the
intersection over completed trials recovers the concurrence relations the
relational samplers (CMA-ES, GP) need (paper §3.1).

Internal representation
-----------------------
Every parameter value is stored as a float ("internal repr"):

* Float  -> the value itself
* Int    -> float(value)
* Categorical -> float(index into ``choices``)

``to_external_repr``/``to_internal_repr`` convert between the two.  This is
the same trick Optuna uses so that storage backends only ever persist floats.

Model space (array codecs)
--------------------------
Samplers model parameters in a second, *model-space* encoding where numeric
domains are additionally log-transformed when ``log=True`` (categoricals stay
choice indices).  The vectorized codecs convert whole arrays at once — this
is the encoding the columnar observation store (``core/records.py``) keeps
its ``(n_trials, n_params)`` matrix in:

* ``to_internal(xs)``     external values -> model-space float array
* ``from_internal(xs)``   model-space array -> internal-repr float array
  (exp of log space, step rounding, clipping to the domain)
* ``internal_bounds()``   the model-space domain, with the TPE-style ±0.5
  integer expansion available via ``expand_int=True``
* ``internal_to_unit()``  model space -> [0, 1] (the CMA-ES/GP coordinate)
* ``sample_uniform(rng, size)``  vectorized uniform draws in internal repr
"""

from __future__ import annotations

import json
import math
from typing import Any, Sequence

import numpy as np

__all__ = [
    "BaseDistribution",
    "FloatDistribution",
    "IntDistribution",
    "CategoricalDistribution",
    "distribution_to_json",
    "json_to_distribution",
    "check_distribution_compatibility",
    "round_to_step",
]

_EPS = 1e-12


def round_to_step(x, low: float, high: float, step: "float | int"):
    """Snap ``x`` (scalar or array) onto the grid ``low + k*step``."""
    if isinstance(x, np.ndarray):
        return low + np.round((x - low) / step) * step
    return low + round((x - low) / step) * step


class BaseDistribution:
    """Base class of parameter distributions."""

    def to_external_repr(self, internal: float) -> Any:
        return internal

    def to_internal_repr(self, external: Any) -> float:
        return float(external)

    # -- vectorized model-space codecs ----------------------------------------

    def to_internal(self, external: Sequence[Any]) -> np.ndarray:
        """Vectorized: external values -> model-space float array."""
        raise NotImplementedError

    def from_internal(self, internal: np.ndarray) -> np.ndarray:
        """Vectorized: model-space array -> internal-repr float array
        (rounded onto the domain; convert each element with
        ``to_external_repr`` to recover external values)."""
        raise NotImplementedError

    def internal_bounds(self, expand_int: bool = False) -> tuple[float, float]:
        """The model-space domain ``[low, high]``.  ``expand_int=True`` widens
        integer domains by ±0.5 (the continuous relaxation TPE models)."""
        raise NotImplementedError

    def internal_to_unit(self, internal: np.ndarray) -> np.ndarray:
        """Model space -> [0, 1] coordinates (CMA-ES/GP design matrices)."""
        low, high = self.internal_bounds()
        xs = np.asarray(internal, dtype=float)
        if high > low:
            return (xs - low) / (high - low)
        return np.full_like(xs, 0.5)

    def sample_uniform(self, rng: np.random.RandomState, size: int) -> np.ndarray:
        """Vectorized uniform draws in *internal repr* (honoring log/step).
        Stream-compatible with the historical scalar draws: ``size=1``
        consumes the RNG exactly as one scalar call did."""
        raise NotImplementedError

    def single(self) -> bool:
        """True if the domain contains exactly one value."""
        raise NotImplementedError

    def _contains(self, internal: float) -> bool:
        raise NotImplementedError

    def _asdict(self) -> dict:
        raise NotImplementedError

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and self._asdict() == other._asdict()  # type: ignore[attr-defined]

    def __hash__(self) -> int:
        return hash((type(self).__name__, json.dumps(self._asdict(), sort_keys=True, default=str)))

    def __repr__(self) -> str:
        kwargs = ", ".join(f"{k}={v!r}" for k, v in self._asdict().items())
        return f"{type(self).__name__}({kwargs})"


class FloatDistribution(BaseDistribution):
    """A continuous domain ``[low, high]``.

    Args:
        low/high: inclusive bounds.
        log: sample in log space (requires ``low > 0``).
        step: discretization step (mutually exclusive with ``log``).
    """

    def __init__(self, low: float, high: float, log: bool = False, step: float | None = None):
        if math.isnan(low) or math.isnan(high):
            raise ValueError("low/high must not be NaN")
        if low > high:
            raise ValueError(f"low={low} must be <= high={high}")
        if log and step is not None:
            raise ValueError("log and step are mutually exclusive")
        if log and low <= 0.0:
            raise ValueError(f"low={low} must be > 0 with log=True")
        if step is not None and step <= 0:
            raise ValueError(f"step={step} must be > 0")
        self.low = float(low)
        self.high = float(high)
        self.log = bool(log)
        self.step = float(step) if step is not None else None

    def single(self) -> bool:
        if self.step is not None:
            return self.high - self.low < self.step
        return self.low == self.high

    def _contains(self, internal: float) -> bool:
        return self.low <= internal <= self.high

    def to_external_repr(self, internal: float) -> float:
        return float(internal)

    def to_internal(self, external: Sequence[Any]) -> np.ndarray:
        xs = np.asarray(external, dtype=float)
        if self.log:
            return np.log(np.maximum(xs, _EPS))
        return xs

    def from_internal(self, internal: np.ndarray) -> np.ndarray:
        xs = np.asarray(internal, dtype=float)
        if self.log:
            xs = np.exp(xs)
        if self.step is not None:
            xs = round_to_step(xs, self.low, self.high, self.step)
        return np.clip(xs, self.low, self.high)

    def internal_bounds(self, expand_int: bool = False) -> tuple[float, float]:
        if self.log:
            return math.log(self.low), math.log(self.high)
        return self.low, self.high

    def sample_uniform(self, rng: np.random.RandomState, size: int) -> np.ndarray:
        if self.log:
            return np.exp(rng.uniform(np.log(self.low), np.log(self.high), size=size))
        if self.step is not None:
            n = int(np.floor((self.high - self.low) / self.step + 1e-12)) + 1
            return self.low + rng.randint(n, size=size) * self.step
        return rng.uniform(self.low, self.high, size=size)

    def _asdict(self) -> dict:
        return {"low": self.low, "high": self.high, "log": self.log, "step": self.step}


class IntDistribution(BaseDistribution):
    """An integer domain ``{low, low+step, ..., high}`` (or log-uniform ints)."""

    def __init__(self, low: int, high: int, log: bool = False, step: int = 1):
        if low > high:
            raise ValueError(f"low={low} must be <= high={high}")
        if log and low <= 0:
            raise ValueError(f"low={low} must be > 0 with log=True")
        if step <= 0:
            raise ValueError(f"step={step} must be > 0")
        if log and step != 1:
            raise ValueError("log and step!=1 are mutually exclusive")
        self.low = int(low)
        self.high = int(high)
        self.log = bool(log)
        self.step = int(step)

    def single(self) -> bool:
        return self.high - self.low < self.step

    def _contains(self, internal: float) -> bool:
        v = int(round(internal))
        return self.low <= v <= self.high

    def to_external_repr(self, internal: float) -> int:
        return int(round(internal))

    def to_internal(self, external: Sequence[Any]) -> np.ndarray:
        xs = np.asarray(external, dtype=float)
        if self.log:
            return np.log(np.maximum(xs, _EPS))
        return xs

    def from_internal(self, internal: np.ndarray) -> np.ndarray:
        xs = np.asarray(internal, dtype=float)
        if self.log:
            xs = np.exp(xs)
        xs = round_to_step(xs, self.low, self.high, self.step)
        return np.clip(xs, self.low, self.high)

    def internal_bounds(self, expand_int: bool = False) -> tuple[float, float]:
        low, high = float(self.low), float(self.high)
        if expand_int:
            low, high = low - 0.5, high + 0.5
            if self.log:
                low = max(low, 0.5)
        if self.log:
            return math.log(low), math.log(high)
        return low, high

    def sample_uniform(self, rng: np.random.RandomState, size: int) -> np.ndarray:
        if self.log:
            lo, hi = np.log(self.low - 0.5), np.log(self.high + 0.5)
            v = np.clip(np.round(np.exp(rng.uniform(lo, hi, size=size))), self.low, self.high)
            return v.astype(float)
        n = (self.high - self.low) // self.step + 1
        return (self.low + rng.randint(n, size=size) * self.step).astype(float)

    def _asdict(self) -> dict:
        return {"low": self.low, "high": self.high, "log": self.log, "step": self.step}


class CategoricalDistribution(BaseDistribution):
    """A finite unordered set of choices.

    Choices must be json-serializable (None, bool, int, float, str); this is
    what lets every storage backend persist them.
    """

    def __init__(self, choices: Sequence[Any]):
        if len(choices) == 0:
            raise ValueError("choices must not be empty")
        for c in choices:
            if c is not None and not isinstance(c, (bool, int, float, str)):
                raise ValueError(
                    f"categorical choice {c!r} of type {type(c).__name__} is not "
                    "json-serializable; use None/bool/int/float/str"
                )
        self.choices = tuple(choices)

    def single(self) -> bool:
        return len(self.choices) == 1

    def _contains(self, internal: float) -> bool:
        idx = int(round(internal))
        return 0 <= idx < len(self.choices)

    def to_external_repr(self, internal: float) -> Any:
        return self.choices[int(round(internal))]

    def to_internal_repr(self, external: Any) -> float:
        # type-aware match: in Python 0 == False, so .index() would conflate
        # int and bool choices (hypothesis-found edge case)
        for i, c in enumerate(self.choices):
            if type(c) is type(external) and c == external:
                return float(i)
        for i, c in enumerate(self.choices):  # fall back to plain equality
            if c == external:
                return float(i)
        raise ValueError(f"{external!r} is not one of the choices {self.choices!r}")

    def to_internal(self, external: Sequence[Any]) -> np.ndarray:
        # choice matching is type-aware (see to_internal_repr) so this stays a
        # per-element loop; it only runs on the few rows of an incremental
        # ingest, never on the ask hot path
        return np.asarray([self.to_internal_repr(v) for v in external], dtype=float)

    def from_internal(self, internal: np.ndarray) -> np.ndarray:
        xs = np.round(np.asarray(internal, dtype=float))
        return np.clip(xs, 0.0, float(len(self.choices) - 1))

    def internal_bounds(self, expand_int: bool = False) -> tuple[float, float]:
        return 0.0, float(len(self.choices) - 1)

    def internal_to_unit(self, internal: np.ndarray) -> np.ndarray:
        # CMA-ES/GP exclude categoricals; the unit coordinate is the index
        return np.asarray(internal, dtype=float)

    def sample_uniform(self, rng: np.random.RandomState, size: int) -> np.ndarray:
        return rng.randint(len(self.choices), size=size).astype(float)

    def _asdict(self) -> dict:
        return {"choices": list(self.choices)}


_CLASSES = {
    "FloatDistribution": FloatDistribution,
    "IntDistribution": IntDistribution,
    "CategoricalDistribution": CategoricalDistribution,
}


def distribution_to_json(dist: BaseDistribution) -> str:
    return json.dumps({"name": type(dist).__name__, "attributes": dist._asdict()})


def json_to_distribution(s: str) -> BaseDistribution:
    obj = json.loads(s)
    cls = _CLASSES[obj["name"]]
    return cls(**obj["attributes"])


def check_distribution_compatibility(old: BaseDistribution, new: BaseDistribution) -> None:
    """Raise if a parameter is re-suggested with an incompatible domain.

    Define-by-run allows the *structure* of the space to change across trials,
    but a given parameter name must keep the same distribution *type* (and the
    same choices for categoricals) so sampler history stays meaningful.
    Bounds of numeric domains may move (Optuna semantics).
    """
    if type(old) is not type(new):
        raise ValueError(
            f"inconsistent distribution types for one parameter: {old!r} vs {new!r}"
        )
    if isinstance(old, CategoricalDistribution) and old != new:
        raise ValueError(f"inconsistent categorical choices: {old!r} vs {new!r}")
