"""The port's study loop against the reference, end to end.

* Seeded ``engine="numpy"`` studies are bit-identical between ``repro`` and
  ``repro_torch``: params, values, states and pruned counts.
* The ``"torch"`` engine on ``device="cpu"`` picks the reference
  ``"pallas"`` engine's parameters within rtol 1e-5 on a short study.
* A 1000-trial history built in ``repro`` and carried across with
  ``transfer.import_trials`` gives both packages the same TPE fits: the
  next ``ask(32)`` wave is bit-identical on numpy, and the device engines'
  scores agree within atol 2e-4 / rtol 1e-4 (float32 on both sides; long
  device runs are held per call, not per trajectory, since an argmax near a
  float32 tie may flip).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.core as ref_hpo  # noqa: E402
from repro.core.distributions import distribution_to_json  # noqa: E402
from repro.core.samplers import tpe as ref_tpe  # noqa: E402
import repro_torch.core as port_hpo  # noqa: E402
from repro_torch.core.samplers import tpe as port_tpe  # noqa: E402

ATOL, RTOL = 2e-4, 1e-4


def quickstart_objective(hpo):
    """``examples/quickstart.py``'s objective, reporting a learning curve."""

    def objective(trial) -> float:
        n_layers = trial.suggest_int("n_layers", 1, 4)
        widths = [trial.suggest_int(f"n_units_l{i}", 4, 128, log=True) for i in range(n_layers)]
        lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
        activation = trial.suggest_categorical("activation", ["relu", "tanh"])
        err = 0.3 * abs(n_layers - 2)
        err += 0.2 * abs(np.log2(np.mean(widths)) - 5)
        err += 0.5 * abs(np.log10(lr) + 2)
        err += 0.1 * (activation == "tanh")
        err = float(err + 0.01 * np.random.RandomState(trial.number).randn())
        for step in range(4):
            trial.report(err * (1.0 + 0.5 / (step + 1)), step)
            if trial.should_prune():
                raise hpo.TrialPruned()
        return err

    return objective


def _history(study):
    trials = study.trials
    return (
        [t.params for t in trials],
        np.array([t.value if t.values else np.nan for t in trials]),
        np.array([int(t.state) for t in trials]),
    )


@pytest.mark.parametrize(
    "pruner",
    [
        lambda hpo: hpo.MedianPruner(n_startup_trials=5),
        lambda hpo: hpo.SuccessiveHalvingPruner(min_resource=1, reduction_factor=2),
        lambda hpo: hpo.HyperbandPruner(min_resource=1, max_resource=4, reduction_factor=2),
        # a subclass ships no fused spec, so ``should_prune`` calls its
        # ``prune`` against ``Study.intermediate_values()`` client side
        lambda hpo: type("ClientSideMedian", (hpo.MedianPruner,), {})(n_startup_trials=5),
    ],
    ids=["median", "successive_halving", "hyperband", "median_client_side"],
)
def test_numpy_study_bit_identical(pruner):
    out = {}
    for name, hpo in (("ref", ref_hpo), ("port", port_hpo)):
        study = hpo.create_study(
            sampler=hpo.TPESampler(seed=0, engine="numpy"), pruner=pruner(hpo)
        )
        study.optimize(quickstart_objective(hpo), n_trials=60)
        out[name] = _history(study)
    (p_ref, v_ref, s_ref), (p_port, v_port, s_port) = out["ref"], out["port"]
    assert p_ref == p_port
    assert np.array_equal(v_ref, v_port, equal_nan=True)
    assert np.array_equal(s_ref, s_port)
    n_pruned = int((s_ref == int(ref_hpo.TrialState.PRUNED)).sum())
    assert n_pruned == int((s_port == int(port_hpo.TrialState.PRUNED)).sum())
    assert n_pruned > 0


def test_torch_engine_agrees_with_reference_pallas_engine():
    """The reference's 14-trial engine-agreement study."""
    objective = lambda t: t.suggest_float("x", -4, 4) ** 2  # noqa: E731
    ref = ref_hpo.create_study(sampler=ref_hpo.TPESampler(seed=11, engine="pallas"))
    ref.optimize(objective, n_trials=14)
    port = port_hpo.create_study(
        sampler=port_hpo.TPESampler(seed=11, engine="torch", device="cpu")
    )
    port.optimize(objective, n_trials=14)
    np.testing.assert_allclose(
        [t.params["x"] for t in port.trials], [t.params["x"] for t in ref.trials], rtol=1e-5
    )


def test_default_study_runs_on_cpu_when_asked():
    study = port_hpo.create_study(device="cpu", pruner=port_hpo.MedianPruner())
    study.optimize(quickstart_objective(port_hpo), n_trials=25, ask_batch=5)
    assert len(study.trials) == 25
    assert math.isfinite(study.best_value)
    values, numbers = study.pareto_front()  # one objective: the best trial
    assert numbers.tolist() == [study.best_trial.number]
    assert values[:, 0].tolist() == [study.best_value]


# -- a history carried across ------------------------------------------------------


def _export_rows(study):
    """A reference study's history as the plain rows ``import_trials`` takes."""
    return [
        {
            "number": t.number,
            "state": int(t.state),
            "values": t.values,
            "params": dict(t.params),
            "distributions": {k: distribution_to_json(d) for k, d in t.distributions.items()},
            "intermediate_values": dict(t.intermediate_values),
        }
        for t in study.trials
    ]


@pytest.fixture(scope="module")
def reference_history():
    study = ref_hpo.create_study(
        sampler=ref_hpo.RandomSampler(seed=0), pruner=ref_hpo.MedianPruner()
    )
    study.optimize(quickstart_objective(ref_hpo), n_trials=1000)
    states = {int(t.state) for t in study.trials}
    assert {int(ref_hpo.TrialState.COMPLETE), int(ref_hpo.TrialState.PRUNED)} <= states
    return _export_rows(study)


def _study_from_rows(hpo, rows, sampler):
    study = hpo.create_study(sampler=sampler, pruner=hpo.MedianPruner())
    if hpo is port_hpo:
        hpo.import_trials(study, rows)
    else:  # the reference side replays the same rows through its storage
        from repro.core.distributions import json_to_distribution
        from repro.core.frozen import FrozenTrial

        for row in rows:
            study._storage.create_new_trial(study._study_id, template_trial=FrozenTrial(
                number=row["number"], state=ref_hpo.TrialState(row["state"]),
                values=row["values"], params=row["params"],
                distributions={k: json_to_distribution(v) for k, v in row["distributions"].items()},
                intermediate_values=row["intermediate_values"],
            ))
    return study


def _ask_wave(study, n=32):
    """The next wave of ``n`` trials, sampled against one history version."""
    out = []
    for trial in study.ask(n):
        n_layers = trial.suggest_int("n_layers", 1, 4)
        widths = [trial.suggest_int(f"n_units_l{i}", 4, 128, log=True) for i in range(n_layers)]
        out.append((n_layers, widths, trial.suggest_float("lr", 1e-5, 1e-1, log=True),
                    trial.suggest_categorical("activation", ["relu", "tanh"])))
    return out


def test_imported_history_matches_reference(reference_history):
    rows = reference_history
    port = _study_from_rows(port_hpo, rows, port_hpo.TPESampler(seed=3, engine="numpy"))
    ref = _study_from_rows(ref_hpo, rows, ref_hpo.TPESampler(seed=3, engine="numpy"))
    assert [t.params for t in port.trials] == [r["params"] for r in rows]
    assert [int(t.state) for t in port.trials] == [r["state"] for r in rows]
    assert [t.intermediate_values for t in port.trials] == [
        {int(k): v for k, v in r["intermediate_values"].items()} for r in rows
    ]
    assert _ask_wave(port) == _ask_wave(ref)


def test_import_rejects_rows_out_of_order(reference_history):
    study = port_hpo.create_study(sampler=port_hpo.RandomSampler(seed=0))
    with pytest.raises(ValueError):
        port_hpo.import_trials(study, reference_history[1:3])


@pytest.mark.parametrize("param", ["lr", "n_units_l0"])
def test_imported_history_device_scores_match_reference(reference_history, param):
    """Both packages fit the same estimators from the carried history; the
    port's ``"torch"`` engine scores them as the reference's ``"pallas"``
    engine does, at the direct and the score-table shape."""
    port_s = port_hpo.TPESampler(seed=3, engine="torch", device="cpu", consider_pruned_trials=True)
    ref_s = ref_hpo.TPESampler(seed=3, engine="pallas", consider_pruned_trials=True)
    port = _study_from_rows(port_hpo, reference_history, port_s)
    ref = _study_from_rows(ref_hpo, reference_history, ref_s)
    split_port = port_s._trial_fit(port, None).split(param)
    split_ref = ref_s._trial_fit(ref, None).split(param)
    assert split_port[0] == split_ref[0] > 500
    for a, b in zip(split_port[1:], split_ref[1:]):
        assert np.array_equal(a, b)
    dist = port.trials[0].distributions[param]
    low, high = dist.internal_bounds(expand_int=True)
    _, below, above, w_below, w_above = split_port
    ests = {
        pkg: (mod._ParzenEstimator(below, low, high, w_below),
              mod._ParzenEstimator(above, low, high, w_above))
        for pkg, mod in (("port", port_tpe), ("ref", ref_tpe))
    }
    for cands in (ests["port"][0].sample(np.random.RandomState(0), 24),
                  np.linspace(low, high, 4096)):
        got = port_s._score_inner(*ests["port"], cands)
        want = ref_s._score_inner(*ests["ref"], cands)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("include_pruned", [False, True])
def test_intersection_search_space_matches_reference(include_pruned):
    """The conditional quickstart space (``n_units_l*`` depend on
    ``n_layers``) intersects to the same distributions in both packages."""
    from repro_torch.core.distributions import distribution_to_json as port_to_json

    spaces = {}
    for name, hpo, to_json in (
        ("ref", ref_hpo, distribution_to_json), ("port", port_hpo, port_to_json),
    ):
        study = hpo.create_study(
            sampler=hpo.RandomSampler(seed=3), pruner=hpo.MedianPruner(n_startup_trials=2)
        )
        study.optimize(quickstart_objective(hpo), n_trials=30)
        space = hpo.IntersectionSearchSpace(include_pruned).calculate(study)
        spaces[name] = {k: to_json(d) for k, d in space.items()}
    assert spaces["ref"] == spaces["port"]
    assert "lr" in spaces["port"] and "n_units_l0" in spaces["port"]
