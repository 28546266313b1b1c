from __future__ import annotations

from .base import BasePruner, NopPruner
from .hyperband import HyperbandPruner
from .median import MedianPruner, PercentilePruner
from .misc import PatientPruner, ThresholdPruner
from .moo import ParetoPruner
from .successive_halving import SuccessiveHalvingPruner

__all__ = [
    "BasePruner",
    "NopPruner",
    "SuccessiveHalvingPruner",
    "MedianPruner",
    "PercentilePruner",
    "HyperbandPruner",
    "ThresholdPruner",
    "PatientPruner",
    "ParetoPruner",
    "make_pruner",
    "pruner_from_spec",
]


def make_pruner(name: str, **kwargs) -> BasePruner:
    name = name.lower()
    if name in ("none", "nop"):
        return NopPruner()
    if name in ("asha", "sha", "successive_halving"):
        return SuccessiveHalvingPruner(**kwargs)
    if name == "median":
        return MedianPruner(**kwargs)
    if name == "hyperband":
        return HyperbandPruner(**kwargs)
    if name == "percentile":
        return PercentilePruner(**kwargs)
    if name == "threshold":
        return ThresholdPruner(**kwargs)
    raise ValueError(f"unknown pruner {name!r}")


def pruner_from_spec(spec: dict) -> BasePruner:
    """Rebuild a pruner from its ``BasePruner.spec()`` wire form.

    This is the server side of the fused ``report_and_prune`` storage op:
    the worker ships ``{"name": ..., **constructor_kwargs}``, the backend
    reconstructs the pruner and evaluates its vectorized ``decide`` against
    its own intermediate-value store.  Specs are tiny and pruners are cheap
    to build, so no instance caching is needed.
    """
    if not isinstance(spec, dict) or "name" not in spec:
        raise ValueError(f"malformed pruner spec: {spec!r}")
    kwargs = {k: v for k, v in spec.items() if k != "name"}
    if spec["name"] == "patient":
        wrapped = kwargs.pop("wrapped", None)
        return PatientPruner(
            pruner_from_spec(wrapped) if wrapped is not None else None, **kwargs
        )
    if spec["name"] == "pareto":
        wrapped = kwargs.pop("wrapped", None)
        if wrapped is None:
            raise ValueError("pareto spec needs a wrapped pruner spec")
        return ParetoPruner(pruner_from_spec(wrapped), **kwargs)
    return make_pruner(spec["name"], **kwargs)
