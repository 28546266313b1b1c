"""The port's multi-objective samplers and pruner against the reference.

Seeded studies through the normal entry points (``create_study`` +
``optimize`` / ``ask``-``tell``) on DTLZ2 (Deb, Thiele, Laumanns, Zitzler
2005) with 5 objectives (the Monte-Carlo hypervolume path) and 3 (the exact
path):

* ``engine="numpy"`` picks bit-identical parameters in both packages: MOTPE
  (univariate, and ``make_sampler("motpe")``'s joint waves), NSGA-II, and the
  pure-numpy CMA-ES, GP and grid samplers;
* the port's ``"torch"`` engine on ``device="cpu"`` picks the reference's
  ``"pallas"`` engine's parameters within rtol 1e-5;
* ``ParetoPruner(MedianPruner())`` prunes the same trials.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.core as ref_hpo  # noqa: E402
import repro_torch.core as port_hpo  # noqa: E402
from repro_torch.core.samplers import tpe as port_tpe  # noqa: E402

PACKAGES = (("ref", ref_hpo), ("port", port_hpo))
N_VARS_EXTRA = 2  # DTLZ2's k, cut to keep the studies small


def dtlz2(x: np.ndarray, m: int) -> list[float]:
    """DTLZ2 objective vector of ``x`` in [0, 1]^(m - 1 + k)."""
    g = float(np.sum((x[m - 1:] - 0.5) ** 2))
    out = []
    for i in range(m):
        v = 1.0 + g
        for j in range(m - 1 - i):
            v *= np.cos(x[j] * np.pi / 2)
        if i > 0:
            v *= np.sin(x[m - 1 - i] * np.pi / 2)
        out.append(float(v))
    return out


def dtlz2_objective(m: int):
    def objective(trial):
        x = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(m - 1 + N_VARS_EXTRA)])
        return dtlz2(x, m)

    return objective


def _params(study) -> np.ndarray:
    return np.array([[v for _, v in sorted(t.params.items())] for t in study.trials])


def _run(hpo, sampler, m, n_trials, ask_batch=1):
    study = hpo.create_study(directions=["minimize"] * m, sampler=sampler)
    study.optimize(dtlz2_objective(m), n_trials=n_trials, ask_batch=ask_batch)
    assert len(study.trials) == n_trials
    return study


@pytest.mark.parametrize("m", [3, 5])
def test_motpe_numpy_bit_identical(m):
    out = {
        name: _params(_run(hpo, hpo.TPESampler(seed=0, multi_objective=True, engine="numpy"), m, 22))
        for name, hpo in PACKAGES
    }
    assert np.array_equal(out["ref"], out["port"])


@pytest.mark.parametrize("m", [3, 5])
def test_motpe_torch_engine_matches_reference_pallas(m):
    ref = _run(ref_hpo, ref_hpo.TPESampler(seed=0, multi_objective=True, engine="pallas"), m, 22)
    port = _run(
        port_hpo,
        port_hpo.TPESampler(seed=0, multi_objective=True, engine="torch", device="cpu"), m, 22,
    )
    np.testing.assert_allclose(_params(port), _params(ref), rtol=1e-5)


def test_make_sampler_motpe_joint_waves_bit_identical():
    """``make_sampler("motpe")`` is MOTPE on the joint path; the reference's
    factory takes no engine, so its side is built with the same settings."""
    port = port_hpo.make_sampler("motpe", seed=1, engine="numpy")
    ref = ref_hpo.TPESampler(seed=1, multi_objective=True, multivariate=True, engine="numpy")
    assert port._multivariate and port._multi_objective
    out = {name: _params(_run(hpo, s, 5, 24, ask_batch=6))
           for (name, hpo), s in zip(PACKAGES, (ref, port))}
    assert np.array_equal(out["ref"], out["port"])


def test_motpe_split_matches_reference_engines():
    """The split itself: numpy bit-identical, the torch engine identical to
    the reference's pallas engine (integer counts of the same float32
    samples), on a 5-objective history past the estimator's threshold."""
    from repro.core.samplers import tpe as ref_tpe

    rng = np.random.RandomState(0)
    L = np.array([dtlz2(x, 5) for x in rng.uniform(size=(30, 5 - 1 + N_VARS_EXTRA))])
    b_np = port_tpe._motpe_split(L, 5, engine="numpy")
    r_np = ref_tpe._motpe_split(L, 5, engine="numpy")
    b_t = port_tpe._motpe_split(L, 5, engine="torch", device="cpu")
    r_p = ref_tpe._motpe_split(L, 5, engine="pallas")
    for got, want in ((b_np, r_np), (b_t, r_p)):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2])
    assert len(b_t[0]) == 5


@pytest.mark.parametrize("m", [3, 5])
def test_nsga2_numpy_bit_identical_and_torch_engine(m):
    runs = {
        name: _run(hpo, hpo.NSGAIISampler(population_size=8, seed=0, engine="numpy"), m, 32,
                   ask_batch=8)
        for name, hpo in PACKAGES
    }
    assert np.array_equal(_params(runs["ref"]), _params(runs["port"]))
    port_torch = _run(
        port_hpo,
        port_hpo.NSGAIISampler(population_size=8, seed=0, engine="torch", device="cpu"),
        m, 32, ask_batch=8,
    )
    assert np.array_equal(_params(port_torch), _params(runs["port"]))
    assert [t.number for t in runs["port"].best_trials] == [
        t.number for t in runs["ref"].best_trials
    ]


@pytest.mark.parametrize(
    "make",
    [
        lambda hpo, **kw: hpo.CmaEsSampler(seed=0, warmup_trials=5),
        lambda hpo, **kw: hpo.GPSampler(seed=0),
        lambda hpo, **kw: hpo.GridSampler({"x0": [0.0, 0.5, 1.0], "x1": [0.25, 0.75]}, seed=0),
        lambda hpo, **kw: hpo.CmaEsSampler(
            warmup_trials=10, independent_sampler=hpo.TPESampler(seed=0, **kw), seed=0
        ),
    ],
    ids=["cmaes", "gp", "grid", "tpe+cmaes"],
)
def test_single_objective_samplers_bit_identical(make):
    def objective(trial):
        x0 = trial.suggest_float("x0", 0.0, 1.0)
        x1 = trial.suggest_float("x1", 0.0, 1.0)
        return (x0 - 0.3) ** 2 + (x1 - 0.6) ** 2

    out = {}
    for name, hpo in PACKAGES:
        sampler = make(hpo, engine="numpy")
        study = hpo.create_study(sampler=sampler, engine="numpy")
        study.optimize(objective, n_trials=6 if isinstance(sampler, hpo.GridSampler) else 20)
        out[name] = (_params(study), [t.value for t in study.trials])
    assert np.array_equal(out["ref"][0], out["port"][0])
    assert out["ref"][1] == out["port"][1]


def test_make_sampler_names():
    for name in ("random", "tpe", "cmaes", "tpe+cmaes", "gp", "nsga2", "motpe"):
        sampler = port_hpo.make_sampler(name, seed=0, engine="numpy")
        assert type(sampler).__name__ == type(ref_hpo.make_sampler(name, seed=0)).__name__
    grid = port_hpo.make_sampler("grid", search_space={"x": [0, 1]})
    assert isinstance(grid, port_hpo.GridSampler)
    with pytest.raises(ValueError):
        port_hpo.make_sampler("grid")
    with pytest.raises(ValueError):
        port_hpo.make_sampler("nope")


@pytest.mark.parametrize("m", [3, 5])
def test_pareto_pruner_prunes_the_same_trials(m):
    def objective_for(hpo):
        def objective(trial):
            x = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0)
                          for i in range(m - 1 + N_VARS_EXTRA)])
            final = dtlz2(x, m)
            for step in range(4):
                trial.report([v * (1.0 + 0.5 / (step + 1)) for v in final], step)
                if trial.should_prune():
                    raise hpo.TrialPruned()
            return final

        return objective

    states = {}
    for name, hpo in PACKAGES:
        study = hpo.create_study(
            directions=["minimize"] * m,
            sampler=hpo.TPESampler(seed=0, multi_objective=True, engine="numpy"),
            pruner=hpo.ParetoPruner(hpo.MedianPruner(n_startup_trials=4)),
        )
        study.optimize(objective_for(hpo), n_trials=24)
        states[name] = [int(t.state) for t in study.trials]
        states[name + "-params"] = _params(study)
    assert states["ref"] == states["port"]
    assert np.array_equal(states["ref-params"], states["port-params"])
    assert states["port"].count(int(port_hpo.TrialState.PRUNED)) > 0
