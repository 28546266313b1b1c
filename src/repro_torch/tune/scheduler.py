"""Trial-parallel scheduling onto device slices.

The HPO analogue of data parallelism: the cards are split into K slices;
each concurrently-running trial trains on one slice.  When ASHA prunes a
trial, its slice is freed and immediately backfilled with a fresh
``study.ask()`` — elastic scaling at the trial level with no global barrier
(pruning *is* the straggler mitigation).

Each entry of ``meshes`` (the name kept from the reference's API, where it
is a jax ``Mesh``) is a list of ``torch.device``s; the scheduler never looks
inside one, it hands it to ``run_trial(trial, slice)``.  Several slices may
name the same card: K trials then train concurrently on one device, each in
its own thread on that device's current stream.  On the CPU the tests use
``[torch.device("cpu")]`` slices.
"""

from __future__ import annotations

import threading
from typing import Callable

from .. import core as hpo
from ..core import telemetry
from ..core.frozen import TrialState

__all__ = ["TrialSliceScheduler"]


class TrialSliceScheduler:
    def __init__(
        self,
        study: hpo.Study,
        meshes: list,
        run_trial: Callable,  # (trial, slice) -> float  (raises TrialPruned)
        backfill_batch: int = 1,
    ):
        """``backfill_batch > 1`` claims replacement trials in waves of that
        size through ``study.ask(n)`` instead of one scalar ask per freed
        slice: each wave is one storage round trip *and* one joint-sampling
        block per parameter group (``BaseSampler.sample_joint``), so a
        multivariate sampler fits its Parzen/posterior once per wave rather
        than once per backfill.  The default of 1 keeps the fully elastic
        per-slice behavior."""
        self.study = study
        self.meshes = meshes
        self.run_trial = run_trial
        self.backfill_batch = max(1, int(backfill_batch))
        self._prefetched: list = []
        self._events: list = []
        self._lock = threading.Lock()

    def _log(self, kind: str, slice_id: int, trial_number: int) -> None:
        with self._lock:
            self._events.append((kind, slice_id, trial_number))
        if telemetry.enabled():  # start/done/pruned/failed per-slice throughput
            telemetry.inc(f"scheduler.{kind}")

    @property
    def events(self) -> list:
        return list(self._events)

    def run(self, n_trials: int) -> None:
        """Run ``n_trials`` total across the slices; each slice loops
        ask -> train -> tell, backfilling as soon as its trial finishes or is
        pruned.

        The opening wave is claimed with one batched ``study.ask(n)`` — one
        storage round trip seeds every slice — after which backfill stays
        elastic (one ask per freed slice, no global barrier)."""
        budget = [n_trials]
        lock = threading.Lock()

        seed_want = min(n_trials, len(self.meshes))
        if seed_want > 0:
            # the seed wave honors generation alignment too: on a warm study
            # a popsize-aware sampler must not draw one oversized block
            seed_want = max(1, min(
                seed_want, self.study.sampler.joint_wave_size(self.study, seed_want)
            ))
        seeded: list = list(self.study.ask(seed_want))

        def take() -> bool:
            with lock:
                if budget[0] <= 0:
                    return False
                budget[0] -= 1
                return True

        def next_trial():
            with lock:
                if seeded:
                    return seeded.pop(0)
                if self._prefetched:
                    return self._prefetched.pop(0)
                if self.backfill_batch > 1:
                    # claim a whole backfill wave in one round trip; peers
                    # freed while this ask is in flight drain the surplus.
                    # Generation-based samplers (CMA-ES, NSGA-II) cap the
                    # wave at their population size so each block aligns
                    # with exactly one generation.
                    want = max(1, min(
                        self.backfill_batch,
                        self.study.sampler.joint_wave_size(self.study, self.backfill_batch),
                    ))
                    self._prefetched.extend(self.study.ask(want))
                    return self._prefetched.pop(0)
            return self.study.ask()

        def slice_worker(slice_id: int, mesh) -> None:
            while take():
                trial = next_trial()
                self._log("start", slice_id, trial.number)
                try:
                    value = self.run_trial(trial, mesh)
                except hpo.TrialPruned:
                    # record the highest-step reported value as the final
                    # value (matching Study._run_one's last_step choice); the
                    # report path already tracked it locally, so no storage
                    # refetch is needed.  A NaN final report is recorded with
                    # no value (Study.tell would reclassify NaN as FAIL).
                    last = trial.last_reported
                    final = last[1] if last is not None and last[1] == last[1] else None
                    self.study.tell(trial, final, state=TrialState.PRUNED)
                    self._log("pruned", slice_id, trial.number)
                    continue
                except Exception:
                    # the reference's function: an objective that raised is a
                    # FAIL trial, and the slice goes on to the next one
                    self.study.tell(trial, state=TrialState.FAIL)
                    self._log("failed", slice_id, trial.number)
                    continue
                self.study.tell(trial, value)
                self._log("done", slice_id, trial.number)

        threads = [
            threading.Thread(target=slice_worker, args=(i, m), daemon=True)
            for i, m in enumerate(self.meshes)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # return unevaluated claims (seed leftovers on early stop, surplus
        # from the last backfill wave) to the WAITING queue
        leftovers = seeded + self._prefetched
        self._prefetched = []
        if leftovers:
            self.study._release_unrun(leftovers)
