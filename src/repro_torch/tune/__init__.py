"""``repro_torch.tune`` — define-by-run objectives over the model zoo.

``TrialSliceScheduler`` (device slices for a fleet of trials) belongs to the
storage and HPO-surfaces slice of the port."""

from __future__ import annotations

from .objective import LMTuneSpec, make_lm_objective

__all__ = ["LMTuneSpec", "make_lm_objective"]
