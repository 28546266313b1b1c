"""Concurrence-relation inference for relational sampling (paper §3.1).

In a define-by-run framework the search space is only revealed by running
trials.  Relational samplers (CMA-ES, GP) need a *fixed* joint space, so we
infer the **intersection search space**: the set of parameters that occurred
in *every* completed trial so far, with their (latest) distributions.  After
a few independently-sampled trials this recovers the stable joint structure,
and the relational sampler takes over for those parameters while independent
sampling covers the conditional remainder.

Joint-sampling **groups** generalize the intersection: instead of keeping
only the parameters present in *every* trial, :func:`observed_groups`
partitions all observed parameters into connected components of the
co-occurrence relation ("suggested together by at least one trial",
Optuna's ``group=True`` decomposition).  Each group can then be modeled
jointly — one ``BaseSampler.sample_joint`` call per group covers every
pending trial of a batched ``Study.ask(n)`` — while parameters from
different groups never constrain each other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from .distributions import BaseDistribution
from .frozen import FrozenTrial, TrialState

if TYPE_CHECKING:
    from .records import ObservationStore
    from .study import Study

__all__ = [
    "intersection_search_space",
    "IntersectionSearchSpace",
    "ParamGroup",
    "observed_groups",
]


@dataclass(frozen=True)
class ParamGroup:
    """One connected component of co-observed parameters.

    ``names`` is sorted; ``dists`` maps each name to the *predicted*
    distribution (the latest one observed in storage).  The prediction is
    what a joint sampler models; a trial whose define-by-run objective
    diverges from it at runtime falls back to scalar sampling (see
    ``Trial._sample``)."""

    names: tuple[str, ...]
    dists: dict[str, BaseDistribution] = field(hash=False)

    def __len__(self) -> int:
        return len(self.names)


def observed_groups(store: "ObservationStore") -> list[ParamGroup]:
    """Group decomposition over a columnar observation store.

    Connected components of the co-occurrence mask (one vectorized boolean
    matmul over the store's dist-type rows, see
    ``ObservationStore.co_occurrence``), joined by union-find.  Parameters
    that were never observed in a COMPLETE/PRUNED trial form no group and
    stay on the per-trial scalar path.  Groups are returned sorted by their
    first parameter name, names sorted within each group."""
    names, mask = store.co_occurrence()
    observed = [i for i in range(len(names)) if mask[i, i]]
    if not observed:
        return []
    parent = list(range(len(names)))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in observed:
        for j in mask[i].nonzero()[0]:
            ri, rj = find(i), find(int(j))
            if ri != rj:
                parent[rj] = ri

    components: dict[int, list[str]] = {}
    for i in observed:
        components.setdefault(find(i), []).append(names[i])
    groups = []
    for members in components.values():
        members = sorted(members)
        dists = {n: store.distribution(n) for n in members}
        if any(d is None for d in dists.values()):  # pragma: no cover - racing delete
            continue
        groups.append(ParamGroup(tuple(members), dists))
    return sorted(groups, key=lambda g: g.names[0])


def intersection_search_space(
    trials: list[FrozenTrial], include_pruned: bool = False
) -> dict[str, BaseDistribution]:
    states = (TrialState.COMPLETE, TrialState.PRUNED) if include_pruned else (
        TrialState.COMPLETE,
    )
    space: dict[str, BaseDistribution] | None = None
    for t in trials:
        if t.state not in states:
            continue
        if space is None:
            space = dict(t.distributions)
            continue
        # keep only params present in every trial, with matching dist types
        keep = {}
        for name, dist in space.items():
            other = t.distributions.get(name)
            if other is not None and type(other) is type(dist):
                keep[name] = other  # latest distribution (bounds may drift)
        space = keep
        if not space:
            break
    return dict(sorted((space or {}).items()))


class IntersectionSearchSpace:
    """Intersection space of a study's finished trials (avoids re-scanning
    all trials on every ask; important when studies grow to 10^4+ trials).

    The calculation rides the columnar observation store: per parameter, one
    vector op over the store's distribution-type rows decides survival
    (present in every included trial, single type), and the store hands back
    the latest included distribution — no ``FrozenTrial`` materialization at
    all.
    """

    def __init__(self, include_pruned: bool = False):
        self._include_pruned = include_pruned

    def calculate(self, study: "Study") -> dict[str, BaseDistribution]:
        return study.observations().intersection_space(self._include_pruned)
