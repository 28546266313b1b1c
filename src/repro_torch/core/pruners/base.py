from __future__ import annotations

from typing import TYPE_CHECKING

from ..frozen import FrozenTrial, StudyDirection

if TYPE_CHECKING:
    from ..records import IntermediateValueStore
    from ..study import Study

__all__ = ["BasePruner", "NopPruner"]


class BasePruner:
    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        """Return True iff ``trial`` should be stopped now, judging from its
        reported intermediate values and the study history (paper Fig. 5)."""
        raise NotImplementedError

    def decide(
        self, direction: StudyDirection, store: "IntermediateValueStore",
        trial: FrozenTrial,
    ) -> bool:
        """Vectorized decision against an intermediate-value store.

        Peer data comes from ``store`` (already refreshed by the caller);
        the target trial's own reported values come from ``trial`` — its row
        in the store is always excluded, so a value fresher than the store's
        snapshot still decides correctly.  Both ``prune`` (client side,
        through ``Study.intermediate_values()``) and the fused
        ``report_and_prune`` storage op (server side, against the backend's
        own store) funnel into this method.
        """
        raise NotImplementedError

    def spec(self) -> "dict | None":
        """JSON-serializable description of this pruner for the fused
        ``report_and_prune`` wire format (see ``pruner_from_spec``).  ``None``
        disables fusion: ``Trial.report`` falls back to a plain
        ``set_trial_intermediate_value`` and ``should_prune`` evaluates the
        pruner client-side."""
        return None

    def _fusable(self, *exact_types: type) -> bool:
        """Built-in ``spec()`` implementations guard on this: a user subclass
        (which may override ``prune``/``decide``) must NOT ship the parent's
        spec — the deciding side would rebuild the plain built-in and
        silently bypass the override — so fusion is limited to the exact
        built-in classes and subclasses fall back to client-side
        evaluation."""
        return type(self) in exact_types


class NopPruner(BasePruner):
    """Never prunes (the paper's 'no pruning' baseline in Fig. 11a)."""

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        return False

    def decide(self, direction, store, trial) -> bool:
        return False

    def spec(self) -> "dict | None":
        # shipping the nop spec lets report+should_prune collapse to the one
        # fused round trip too (backends short-circuit it after the write)
        return {"name": "nop"} if self._fusable(NopPruner) else None
