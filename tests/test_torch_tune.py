"""The port's HPO-over-training loop (``repro_torch.tune``) on the CPU: twins
of ``tests/test_tune_integration.py`` with ``families=("dense",)`` and
``device="cpu"``, ``("dense", "mamba2")``, ``("dense", "mlstm")`` and
``("dense", "moe")`` studies, and the spaces held equal to the reference's.
The full study also renders the dashboard, as the reference's test does."""

import dataclasses

import numpy as np
import pytest

import repro.core as ref_hpo
import repro_torch.core as hpo
from repro.tune import LMTuneSpec as RefLMTuneSpec
from repro.tune.objective import suggest_model_config as ref_suggest_model_config
from repro.tune.objective import suggest_train_config as ref_suggest_train_config
from repro_torch.core.frozen import TrialState
from repro_torch.tune import LMTuneSpec, make_lm_objective
from repro_torch.tune.objective import suggest_model_config, suggest_train_config

SPEC = LMTuneSpec(
    vocab=64, seq=32, batch=4, total_steps=12, eval_every=3,
    max_layers=2, max_width=64, families=("dense",),
)


def test_define_by_run_space_is_conditional():
    """Different families produce different parameter sets (paper Fig. 3)."""
    spec = dataclasses.replace(SPEC, families=LMTuneSpec.families)
    seen_params = {}
    study = hpo.create_study(sampler=hpo.RandomSampler(seed=0))
    for _ in range(12):
        t = study.ask()
        cfg = suggest_model_config(t, spec)
        seen_params[cfg.name] = set(t.params)
        study.tell(t, 0.0)
    families = {t.params["family"] for t in study.trials}
    assert len(families) >= 2
    moe_sets = [v for k, v in seen_params.items() if "moe" in k]
    dense_sets = [v for k, v in seen_params.items() if "dense" in k]
    if moe_sets and dense_sets:
        assert any("n_experts" in s for s in moe_sets)
        assert all("n_experts" not in s for s in dense_sets)


def test_spaces_equal_the_reference():
    """The same seeded random study in both packages asks the same
    parameters and builds the same model and train configs."""
    spec = dataclasses.replace(SPEC, families=LMTuneSpec.families)
    ref_spec = RefLMTuneSpec(**dataclasses.asdict(spec))
    ref_study = ref_hpo.create_study(sampler=ref_hpo.RandomSampler(seed=3))
    study = hpo.create_study(sampler=hpo.RandomSampler(seed=3))
    for _ in range(10):
        rt, t = ref_study.ask(), study.ask()
        ref_cfg, cfg = ref_suggest_model_config(rt, ref_spec), suggest_model_config(t, spec)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert (dataclasses.asdict(suggest_train_config(t, spec))
                == dataclasses.asdict(ref_suggest_train_config(rt, ref_spec)))
        assert t.params == rt.params
        ref_study.tell(rt, 0.0)
        study.tell(t, 0.0)


def test_full_study_with_pruning_and_deploy():
    study = hpo.create_study(
        sampler=hpo.TPESampler(seed=0, n_startup_trials=3, device="cpu"),
        pruner=hpo.SuccessiveHalvingPruner(min_resource=3, reduction_factor=2),
    )
    objective = make_lm_objective(SPEC, device="cpu")
    study.optimize(objective, n_trials=8)

    states = [t.state for t in study.trials]
    assert states.count(TrialState.COMPLETE) >= 1
    assert TrialState.FAIL not in states
    assert np.isfinite(study.best_value)
    for t in study.trials:
        if t.state == TrialState.COMPLETE:
            assert len(t.intermediate_values) >= 2
            assert t.user_attrs["final_step"] == SPEC.total_steps

    # deploy: re-run the best config through the SAME objective via FixedTrial
    best = study.best_trial
    value = objective(hpo.FixedTrial(best.params))
    assert np.isfinite(value)
    assert value == pytest.approx(best.value, rel=1e-6)  # seeded init and data: the same run

    # dashboard renders with learning curves
    html = hpo.render_dashboard(study)
    assert "Learning curves" in html


def test_train_config_space():
    study = hpo.create_study(sampler=hpo.RandomSampler(seed=1))
    t = study.ask()
    tcfg = suggest_train_config(t, SPEC)
    assert 1e-4 <= tcfg.lr <= 1e-1
    assert 0 <= tcfg.warmup_steps <= 20
    assert tcfg.total_steps == SPEC.total_steps


def test_dense_and_mamba2_study_runs():
    """Both families train, report and get pruned; no trial raises."""
    spec = dataclasses.replace(SPEC, families=("dense", "mamba2"))
    study = hpo.create_study(
        sampler=hpo.TPESampler(seed=1, n_startup_trials=3, device="cpu"),
        pruner=hpo.SuccessiveHalvingPruner(min_resource=3, reduction_factor=2),
    )
    objective = make_lm_objective(spec, device="cpu")
    study.optimize(objective, n_trials=8)
    states = [t.state for t in study.trials]
    assert TrialState.FAIL not in states
    assert set(states) <= {TrialState.COMPLETE, TrialState.PRUNED}
    assert {t.params["family"] for t in study.trials} == {"dense", "mamba2"}
    assert np.isfinite(study.best_value)
    fixed = {"family": "mamba2", "n_layers": 2, "width_exp": 5, "ssm_state": 16, "lr": 3e-3,
             "warmup": 0, "weight_decay": 0.01}
    assert np.isfinite(objective(hpo.FixedTrial(fixed)))


@pytest.mark.parametrize("proj_factor,heads", [(1, 2), (2, 4)])
def test_mlstm_family_trains(proj_factor, heads):
    """An ``mlstm`` trial builds and trains: a finite loss."""
    fixed = {"family": "mlstm", "n_layers": 2, "width_exp": 5, "ssm_heads": heads,
             "proj_factor": proj_factor, "lr": 3e-3, "warmup": 0, "weight_decay": 0.01}
    objective = make_lm_objective(dataclasses.replace(SPEC, families=("mlstm",)), device="cpu")
    assert np.isfinite(objective(hpo.FixedTrial(fixed)))


def test_dense_and_mlstm_study_runs():
    """Both families train, report and get pruned; no trial raises."""
    spec = dataclasses.replace(SPEC, families=("dense", "mlstm"))
    study = hpo.create_study(
        sampler=hpo.TPESampler(seed=1, n_startup_trials=3, device="cpu"),
        pruner=hpo.SuccessiveHalvingPruner(min_resource=3, reduction_factor=2),
    )
    study.optimize(make_lm_objective(spec, device="cpu"), n_trials=8)
    states = [t.state for t in study.trials]
    assert set(states) <= {TrialState.COMPLETE, TrialState.PRUNED}
    assert {t.params["family"] for t in study.trials} == {"dense", "mlstm"}
    assert np.isfinite(study.best_value)


# the name and id are those the case had when the moe family raised
@pytest.mark.parametrize("family,params", [("moe", {"n_experts": 4, "top_k": 1})],
                         ids=["moe-params0-MLA/MoE"])
def test_later_families_raise_naming_their_slice(family, params):
    """The ``moe`` family trains: a CPU study over ``("dense", "moe")``
    whose ``moe`` trials complete or are pruned, and a fixed ``moe`` trial
    with a finite loss."""
    spec = dataclasses.replace(SPEC, families=("dense", family))
    study = hpo.create_study(
        sampler=hpo.TPESampler(seed=2, n_startup_trials=3, device="cpu"),
        pruner=hpo.SuccessiveHalvingPruner(min_resource=3, reduction_factor=2),
    )
    objective = make_lm_objective(spec, device="cpu")
    study.optimize(objective, n_trials=8)
    states = {t.state for t in study.trials if t.params["family"] == family}
    assert states and states <= {TrialState.COMPLETE, TrialState.PRUNED}, states
    assert TrialState.FAIL not in {t.state for t in study.trials}
    fixed = {"family": family, "n_layers": 1, "width_exp": 5, "lr": 1e-3, "warmup": 0,
             "weight_decay": 0.01, **params}
    assert np.isfinite(objective(hpo.FixedTrial(fixed)))
