"""``repro_torch.tune`` — define-by-run objectives over the model zoo, and
``TrialSliceScheduler``, which runs a study's trials concurrently on device
slices."""

from __future__ import annotations

from .objective import LMTuneSpec, make_lm_objective
from .scheduler import TrialSliceScheduler

__all__ = ["LMTuneSpec", "make_lm_objective", "TrialSliceScheduler"]
