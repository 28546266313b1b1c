"""The port's columnar plot reductions and importances (``repro_torch.core.
analytics``, ``repro_torch.core.importance``), held to the reference.

* The reference's own suite (``tests/test_analytics.py``), each test under
  its reference name: every reduction against a brute-force per-trial loop
  on randomized inputs with NaN and pruned rows, both directions, and the
  remote-vs-inmemory equivalence of the delta payloads.
* Same payloads: on the same seeded ``engine="numpy"`` study in both
  packages, ``StudyAnalytics.views()``, ``delta_rows()`` and
  ``importances()`` serialize to the same JSON text, single- and
  multi-objective.
* fANOVA is bit-identical: the importances, and each tree's leaf partition
  and main effects on the same design matrix.
"""

import json
import math

import numpy as np
import pytest

import repro_torch.core as hpo
from repro_torch.core import importance, moo
from repro_torch.core.analytics import (
    RevisionPoller,
    StudyAnalytics,
    contour_reduction,
    jsonable,
    running_best,
    slice_reduction,
)
from repro_torch.core.frozen import TrialState

_COMPLETE = int(TrialState.COMPLETE)
_PRUNED = int(TrialState.PRUNED)


def _reference():
    """``repro.core`` (the JAX package); the cross-package cases skip without jax."""
    pytest.importorskip("jax")
    import repro.core as ref

    return ref


def _random_columns(rng, n):
    """Randomized (numbers, values, states, x, y) with NaN and pruned rows."""
    numbers = np.arange(n)
    values = rng.normal(size=n)
    values[rng.random(n) < 0.15] = np.nan
    states = np.where(rng.random(n) < 0.25, _PRUNED, _COMPLETE)
    x = rng.uniform(-2, 5, size=n)
    y = rng.uniform(0, 1, size=n)
    x[rng.random(n) < 0.1] = np.nan
    y[rng.random(n) < 0.1] = np.nan
    return numbers, values, states, x, y


# -- the reference's suite (tests/test_analytics.py) ---------------------------


class TestRunningBest:
    @pytest.mark.parametrize("minimize", [True, False])
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_parity_vs_loop(self, minimize, seed):
        rng = np.random.default_rng(seed)
        numbers, values, states, _, _ = _random_columns(rng, 120)
        nums, vals, best = running_best(numbers, values, states, minimize)

        ref_nums, ref_vals, ref_best = [], [], []
        cur = None
        for i in range(len(numbers)):
            v = values[i]
            if states[i] != _COMPLETE or not math.isfinite(v):
                continue
            cur = v if cur is None else (min(cur, v) if minimize else max(cur, v))
            ref_nums.append(numbers[i])
            ref_vals.append(v)
            ref_best.append(cur)
        assert nums.tolist() == ref_nums
        np.testing.assert_array_equal(vals, ref_vals)
        np.testing.assert_array_equal(best, ref_best)

    def test_empty(self):
        nums, vals, best = running_best(
            np.empty(0, dtype=int), np.empty(0), np.empty(0, dtype=int), True
        )
        assert nums.size == 0 and vals.size == 0 and best.size == 0


class TestContourReduction:
    @pytest.mark.parametrize("minimize", [True, False])
    @pytest.mark.parametrize("seed", [0, 7])
    def test_parity_vs_loop(self, minimize, seed):
        rng = np.random.default_rng(seed)
        _, values, states, x, y = _random_columns(rng, 200)
        mask = states == _COMPLETE
        nx = ny = 6
        xe, ye, grid, counts = contour_reduction(x, y, values, mask, nx, ny, minimize)

        ref = np.full((ny, nx), np.nan)
        ref_counts = np.zeros((ny, nx), dtype=int)
        xlo, xhi = xe[0], xe[-1]
        ylo, yhi = ye[0], ye[-1]
        for i in range(len(values)):
            if not mask[i]:
                continue
            if not (math.isfinite(x[i]) and math.isfinite(y[i]) and math.isfinite(values[i])):
                continue
            cx = min(int((x[i] - xlo) / (xhi - xlo) * nx), nx - 1)
            cy = min(int((y[i] - ylo) / (yhi - ylo) * ny), ny - 1)
            ref_counts[cy, cx] += 1
            z = ref[cy, cx]
            if math.isnan(z):
                ref[cy, cx] = values[i]
            else:
                ref[cy, cx] = min(z, values[i]) if minimize else max(z, values[i])
        np.testing.assert_array_equal(counts, ref_counts)
        np.testing.assert_array_equal(grid, ref)

    def test_empty_and_degenerate(self):
        xe, ye, grid, counts = contour_reduction(
            np.empty(0), np.empty(0), np.empty(0), np.empty(0, dtype=bool), 4, 4
        )
        assert np.isnan(grid).all() and counts.sum() == 0
        n = 10
        xe, ye, grid, counts = contour_reduction(
            np.full(n, 2.0), np.full(n, 3.0), np.arange(n, dtype=float),
            np.ones(n, dtype=bool), 4, 4,
        )
        assert counts.sum() == n
        assert np.nanmin(grid) == 0.0


class TestSliceReduction:
    @pytest.mark.parametrize("seed", [0, 5])
    def test_band_quantiles_vs_loop(self, seed):
        rng = np.random.default_rng(seed)
        _, values, states, x, _ = _random_columns(rng, 150)
        mask = states == _COMPLETE
        out = slice_reduction(x, values, mask, n_bins=5)
        xs, zs = out["x"], out["z"]
        assert np.isfinite(xs).all() and np.isfinite(zs).all()

        bins = out["bins"]
        blo, bhi = xs.min(), xs.max()
        for c, med, lo, hi, cnt in zip(
            bins["centers"], bins["med"], bins["lo"], bins["hi"], bins["counts"]
        ):
            b = min(int((c - blo) / (bhi - blo) * 5), 4)
            sel = [z for xx, z in zip(xs, zs)
                   if min(int((xx - blo) / (bhi - blo) * 5), 4) == b]
            assert cnt == len(sel)
            assert med == pytest.approx(np.median(sel))
            assert lo == pytest.approx(np.percentile(sel, 25))
            assert hi == pytest.approx(np.percentile(sel, 75))

    def test_empty(self):
        out = slice_reduction(np.empty(0), np.empty(0), np.empty(0, dtype=bool))
        assert out["x"].size == 0 and out["bins"]["centers"].size == 0


class TestParetoViewParity:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_front_mask_vs_pairwise_loop(self, seed):
        rng = np.random.default_rng(seed)
        n = 60
        V = rng.normal(size=(n, 2))
        mask = rng.random(n) < 0.8
        directions = [0, 1]  # minimize, maximize
        L = moo.loss_matrix(V, directions)
        front = moo.pareto_front_mask(L, mask=mask)

        def dominates(a, b):
            return bool(np.all(L[a] <= L[b]) and np.any(L[a] < L[b]))

        for i in range(n):
            if not mask[i]:
                assert not front[i]
                continue
            dominated = any(
                dominates(j, i) for j in range(n) if j != i and mask[j]
            )
            assert front[i] == (not dominated)


class TestJsonable:
    def test_nan_and_numpy(self):
        out = jsonable(
            {
                "a": np.float64(1.5),
                "b": float("nan"),
                "c": np.array([1.0, np.nan, np.inf]),
                "d": np.int64(3),
                "e": [np.float32(2.0), {"f": -np.inf}],
            }
        )
        assert out == {"a": 1.5, "b": None, "c": [1.0, None, None],
                       "d": 3, "e": [2.0, {"f": None}]}
        json.dumps(out, allow_nan=False)  # strict-JSON safe


class TestStudyAnalytics:
    def _study(self, storage=None, n=40, name="an"):
        s = hpo.create_study(
            study_name=name, storage=storage, sampler=hpo.RandomSampler(seed=4)
        )
        s.optimize(
            lambda t: (t.suggest_float("x", -3, 3)) ** 2 + t.suggest_float("y", 0, 1),
            n_trials=n,
        )
        return s

    def test_views_cached_until_new_trial(self):
        s = self._study()
        sa = StudyAnalytics(s)
        v1 = sa.views()
        assert sa.views() is v1  # same object: version-cache hit
        s.optimize(lambda t: t.suggest_float("x", -3, 3) ** 2
                   + t.suggest_float("y", 0, 1), n_trials=1)
        v2 = sa.views()
        assert v2 is not v1
        assert v2["n_finished"] == v1["n_finished"] + 1

    def test_delta_rows_incremental(self):
        s = self._study(n=10)
        sa = StudyAnalytics(s)
        d = sa.delta_rows(-1)
        assert len(d["rows"]) == 10 and d["last_number"] == 9
        assert [r["number"] for r in d["rows"]] == list(range(10))
        s.optimize(lambda t: t.suggest_float("x", -3, 3) ** 2
                   + t.suggest_float("y", 0, 1), n_trials=3)
        d2 = sa.delta_rows(d["last_number"])
        assert [r["number"] for r in d2["rows"]] == [10, 11, 12]
        for r in d2["rows"]:
            assert set(r["params"]) == {"x", "y"}
            assert r["state"] == "COMPLETE"
            assert len(r["values"]) == 1

    def test_remote_vs_inmemory_delta_equivalence(self):
        """Seeded study through a real server == same study inmemory, row for
        row (the wire adds nothing and loses nothing)."""
        local = self._study(hpo.InMemoryStorage(), n=25, name="eq")
        with hpo.StorageServer(hpo.InMemoryStorage()) as server:
            remote = self._study(hpo.RemoteStorage(server.url), n=25, name="eq")
            d_local = StudyAnalytics(local).delta_rows(-1)
            d_remote = StudyAnalytics(remote).delta_rows(-1)
        assert d_local == d_remote

    def test_poller_revision_gating(self):
        storage = hpo.InMemoryStorage()
        s = self._study(storage, n=3)
        p = RevisionPoller(storage, s._study_id)
        assert p.poll() is True  # first poll always reports change
        assert p.poll() is False
        assert p.poll() is False
        s.optimize(lambda t: t.suggest_float("x", -3, 3) ** 2
                   + t.suggest_float("y", 0, 1), n_trials=1)
        assert p.poll() is True
        assert p.poll() is False
        assert p.ticks == 5 and p.changes == 2

    def test_mo_views(self):
        s = hpo.create_study(
            directions=["minimize", "maximize"], sampler=hpo.RandomSampler(seed=2)
        )
        s.optimize(
            lambda t: (t.suggest_float("x", 0, 1), t.suggest_float("y", 0, 1)),
            n_trials=20,
        )
        v = StudyAnalytics(s).views()
        assert len(v["history"]) == 2
        best = v["history"][1]["best"]
        assert all(b2 >= b1 for b1, b2 in zip(best, best[1:]))
        assert v["pareto"] is not None
        assert set(v["pareto"]["front_numbers"]) <= set(v["pareto"]["numbers"])
        assert sorted(v["importance"]["fanova"]) == ["0", "1"]


# -- the same payloads as the reference's ----------------------------------------


def _objective_of(pkg):
    """A conditional space (float, log float, int, categorical) with
    reports, so the views have every kind of column and learning curves."""

    def objective(t):
        x = t.suggest_float("x", -3, 3)
        lr = t.suggest_float("lr", 1e-4, 1e-1, log=True)
        depth = t.suggest_int("depth", 1, 6)
        kind = t.suggest_categorical("kind", ["a", "b", "c"])
        value = (x * x + 0.3 * math.log10(lr) ** 2 + 0.1 * depth
                 + {"a": 0.0, "b": 0.5, "c": 1.0}[kind])
        for step in range(4):
            t.report(value + 1.0 / (step + 1), step)
            if t.should_prune():
                raise pkg.TrialPruned()
        return value

    return objective


def _mo_objective(t):
    x, y = t.suggest_float("x", 0, 1), t.suggest_float("y", 0, 1)
    return x + 0.2 * y, (1 - x) ** 2 + 0.1 * y


def _seeded(pkg, directions=None, n=48):
    if directions is None:
        study = pkg.create_study(
            study_name="seeded",
            sampler=pkg.TPESampler(seed=0, n_startup_trials=8, engine="numpy"),
            pruner=pkg.MedianPruner(n_startup_trials=4, n_warmup_steps=1),
        )
        study.optimize(_objective_of(pkg), n_trials=n)
    else:
        study = pkg.create_study(study_name="seeded", directions=directions,
                                 sampler=pkg.TPESampler(seed=1, n_startup_trials=8,
                                                        engine="numpy"))
        study.optimize(_mo_objective, n_trials=n)
    return study


def _text(payload) -> str:
    return json.dumps(payload, sort_keys=True, allow_nan=False)


@pytest.mark.parametrize("directions", [None, ["minimize", "maximize"]],
                         ids=["single", "two-objective"])
def test_views_delta_and_importances_equal_the_reference(directions):
    ref = _reference()
    from repro.core.analytics import StudyAnalytics as RefStudyAnalytics

    ours = StudyAnalytics(_seeded(hpo, directions))
    theirs = RefStudyAnalytics(_seeded(ref, directions))
    states = {t.state.name for t in ours.study.trials}
    assert states == ({"COMPLETE", "PRUNED"} if directions is None else {"COMPLETE"})
    assert _text(ours.views()) == _text(theirs.views())
    assert _text(ours.importances()) == _text(theirs.importances())
    for since in (-1, 0, 17, 46, 47):
        assert _text(ours.delta_rows(since)) == _text(theirs.delta_rows(since))


@pytest.mark.parametrize("directions", [None, ["minimize", "maximize"]],
                         ids=["single", "two-objective"])
def test_importances_bit_identical(directions):
    ref = _reference()
    ours, theirs = _seeded(hpo, directions), _seeded(ref, directions)

    def bits(res):
        if res and isinstance(next(iter(res.values())), dict):
            return {k: bits(v) for k, v in res.items()}
        return [(name, float(w).hex()) for name, w in res.items()]  # order kept

    for name in ("fanova_importances", "param_importances", "spearman_importances"):
        mine, want = getattr(hpo, name)(ours), getattr(ref, name)(theirs)
        assert bits(mine) == bits(want), name
    assert sum(hpo.fanova_importances(ours, objective=0).values()) == pytest.approx(1.0)
    for seed in (0, 3):
        a = hpo.fanova_importances(ours, objective=0, seed=seed, n_trees=4, max_depth=3)
        b = ref.fanova_importances(theirs, objective=0, seed=seed, n_trees=4, max_depth=3)
        assert bits(a) == bits(b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fanova_trees_bit_identical(seed):
    """One tree's leaf boxes and main effects on a random design matrix with
    ties (a categorical column) equal the reference's bit for bit."""
    _reference()
    from repro.core import importance as ref_importance

    rng = np.random.default_rng(seed)
    n, d = 64, 4
    X = rng.random((n, d))
    X[:, 2] = rng.integers(0, 3, n) / 2.0
    y = np.sin(4 * X[:, 0]) + X[:, 1] ** 2 + 0.3 * X[:, 2] + 0.01 * rng.normal(size=n)
    idx = rng.integers(0, n, n)
    mine = importance._fit_tree(X, y, idx, 6, 3)
    want = ref_importance._fit_tree(X, y, idx, 6, 3)
    for a, b in zip(mine, want):
        assert a.tobytes() == b.tobytes()
    (vj, V), (rvj, rV) = (importance._fanova_tree_main_effects(*mine),
                          ref_importance._fanova_tree_main_effects(*want))
    assert vj.tobytes() == rvj.tobytes() and float(V).hex() == float(rV).hex()
    assert V > 0 and vj.argmax() in (0, 1)


# -- out-of-order finishes ---------------------------------------------------------


def _poll(sa, cursor):
    """One delta poll that carries the cursor and the pending numbers back,
    as the live page does; returns the numbers of the rows shipped."""
    d = sa.delta_rows(cursor["num"], cursor["pending"])
    cursor.update(num=d["last_number"], pending=d.get("pending", []))
    return [r["number"] for r in d["rows"]]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_out_of_order_finishes_ship_each_row_once(seed):
    """Trials told in a shuffled order, a delta poll after each tell: every
    finished row ships exactly once, at the first poll after it finished.
    The reference's cursor alone skips the trials that finish after a
    higher-numbered one was shipped; the pending numbers ship them."""
    shipped = {}
    for pkg_name in ("port", "reference"):
        pkg = hpo if pkg_name == "port" else _reference()
        if pkg_name == "port":
            analytics = StudyAnalytics
        else:
            from repro.core.analytics import StudyAnalytics as analytics
        study = pkg.create_study(sampler=pkg.RandomSampler(seed=seed))
        trials = study.ask(12)
        for t in trials:
            t.suggest_float("x", 0, 1)
        sa = analytics(study)
        cursor, rows = {"num": -1, "pending": []}, []
        for i in np.random.default_rng(seed).permutation(12):
            if i % 4:
                study.tell(trials[i], float(i))
            else:
                study.tell(trials[i], float(i), state=pkg.TrialState.PRUNED)
            if pkg_name == "port":
                assert _poll(sa, cursor) == [i]
            else:
                d = sa.delta_rows(cursor["num"])
                rows += [r["number"] for r in d["rows"]]
                cursor["num"] = d["last_number"]
        shipped[pkg_name] = rows
        if pkg_name == "port":
            assert cursor["pending"] == []
    assert sorted(set(shipped["reference"])) == shipped["reference"]
    assert len(shipped["reference"]) < 12  # the skipped trials


@pytest.mark.parametrize("storage", ["inmemory", "sqlite"])
@pytest.mark.parametrize("unfinished", ["running", "released"])
def test_unfinished_trial_holds_no_row_back(unfinished, storage, tmp_path):
    """A trial below finished ones that does not finish (a worker lost with
    its trial RUNNING, or a batch-asked trial released to WAITING at a
    deadline) holds no later row back: each poll ships the rows finished
    since the last one, lists the unfinished number as pending, and ships
    its row once it finishes."""
    url = None if storage == "inmemory" else f"sqlite:///{tmp_path}/s.db"
    study = hpo.create_study(storage=url, sampler=hpo.RandomSampler(seed=0))
    trials = study.ask(5)
    for t in trials:
        t.suggest_float("x", 0, 1)
    if unfinished == "released":
        study._release_unrun([trials[1]])
    want_state = TrialState.RUNNING if unfinished == "running" else TrialState.WAITING
    sa, cursor = StudyAnalytics(study), {"num": -1, "pending": []}
    study.tell(trials[0], 0.0)
    assert _poll(sa, cursor) == [0] and cursor["pending"] == []
    for told in ([2], [3, 4]):
        for i in told:
            study.tell(trials[i], float(i))
        assert _poll(sa, cursor) == told and cursor["pending"] == [1]
    assert _poll(sa, cursor) == [] and cursor["pending"] == [1]
    assert study.trials[1].state == want_state
    study._storage.set_trial_state_values(trials[1]._trial_id, TrialState.COMPLETE, [1.0])
    assert _poll(sa, cursor) == [1] and cursor["pending"] == []
    assert _poll(sa, cursor) == []
