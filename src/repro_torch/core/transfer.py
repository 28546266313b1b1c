"""Carry a finished trial history into a study of this package.

A TPE sampler's state is its study's history: the estimators it fits are a
function of the finished trials alone.  So a history exported from any
Optuna-style study as plain rows, and imported here, lets a sampler of this
package continue exactly where the other one stood — the HPO counterpart of
loading transferred weights.
"""

from __future__ import annotations

import datetime
from typing import Any, Iterable

from .distributions import json_to_distribution
from .frozen import FrozenTrial, TrialState

__all__ = ["import_trials"]


def import_trials(study, rows: Iterable[dict[str, Any]]) -> list[int]:
    """Write ``rows`` into ``study``'s storage as trials; returns their ids.

    Each row is a plain dict with keys ``number`` (int), ``state`` (the int
    of a :class:`TrialState`), ``values`` (list of floats, or None),
    ``params`` (name -> external value), ``distributions`` (name -> the JSON
    of ``distribution_to_json``) and ``intermediate_values`` (step ->
    float).  Rows must continue the study's trial numbering in order, so
    that recency weights and tie-breaks see the same history."""
    storage = study._storage
    study_id = study._study_id
    next_number = storage.get_n_trials(study_id)
    ids = []
    for row in rows:
        if int(row["number"]) != next_number:
            raise ValueError(
                f"row number {row['number']} does not continue the study's "
                f"numbering (next is {next_number}): rows must come in order"
            )
        next_number += 1
        state = TrialState(int(row["state"]))
        values = row.get("values")
        finished = datetime.datetime.now() if state.is_finished() else None
        template = FrozenTrial(
            number=int(row["number"]),
            state=state,
            values=None if values is None else [float(v) for v in values],
            params=dict(row.get("params") or {}),
            distributions={
                name: json_to_distribution(js)
                for name, js in (row.get("distributions") or {}).items()
            },
            intermediate_values={
                int(step): float(v)
                for step, v in (row.get("intermediate_values") or {}).items()
            },
            datetime_complete=finished,
        )
        ids.append(storage.create_new_trial(study_id, template_trial=template))
    return ids
