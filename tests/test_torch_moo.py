"""The port's multi-objective engine against the reference and brute force.

* Dominance, ranks, fronts, crowding, exact hypervolume and HSSP on the
  port's numpy engine are bit-identical to the reference's numpy engine and
  match the brute-force pairwise references (both directions, duplicates,
  NaN rows).
* The port's ``"torch"`` engine on ``device="cpu"`` equals the reference's
  ``"jax"`` / ``"pallas"`` engines: identical booleans and counts, Monte-Carlo
  contributions within atol 1e-5 of the numpy engine as the reference holds
  its own device engines (``tests/test_engine.py``).  The port's dominance
  compare keeps the values' float64 precision, so it also equals the numpy
  engine where a float32 cast would tie two values.
* ``Study.best_trials`` is bit-identical to ``_pairwise_best_trials`` in both
  packages and across them.
* A device engine never runs without a card unless ``device="cpu"`` is given.
"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.core as ref_hpo  # noqa: E402
from repro.core import moo as ref_moo  # noqa: E402
from repro.core.study import _pairwise_best_trials as ref_pairwise  # noqa: E402
import repro_torch.core as hpo  # noqa: E402
from repro_torch.core import moo  # noqa: E402
from repro_torch.core.frozen import StudyDirection, TrialState  # noqa: E402
from repro_torch.core.study import _pairwise_best_trials  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

CPU = {"engine": "torch", "device": "cpu"}


# -- brute-force references -------------------------------------------------------


def dominates(a, b) -> bool:
    """Scalar pairwise dominance (loss orientation), NaN-safe per IEEE."""
    better = False
    for av, bv in zip(a, b):
        if av > bv:
            return False
        if av < bv:
            better = True
    return better


def brute_ranks(V) -> np.ndarray:
    n = len(V)
    ranks = np.full(n, -1)
    remaining = set(range(n))
    rank = 0
    while remaining:
        front = [
            i for i in remaining
            if not any(dominates(V[j], V[i]) for j in remaining if j != i)
        ]
        for i in front:
            ranks[i] = rank
            remaining.discard(i)
        rank += 1
    return ranks


def grid_hypervolume(points, ref) -> float:
    """Exact hypervolume for integer-coordinate points by unit-cell counting."""
    points = np.asarray(points, float)
    lo = points.min(axis=0).astype(int)
    axes = [range(int(l), int(r)) for l, r in zip(lo, ref)]
    count = 0
    for cell in itertools.product(*axes):
        c = np.asarray(cell, float)
        if ((points <= c).all(axis=1)).any():
            count += 1
    return float(count)


def random_values(rng, n, m, duplicates=True, nan_rows=False):
    if duplicates:
        V = rng.randint(0, 4, size=(n, m)).astype(float)
    else:
        V = rng.uniform(-5, 5, size=(n, m))
    if nan_rows and n > 2:
        V[rng.choice(n, size=max(1, n // 8), replace=False), rng.randint(m)] = np.nan
    return V


# -- dominance / ranks --------------------------------------------------------------


class TestDominance:
    @pytest.mark.parametrize("seed", range(5))
    @pytest.mark.parametrize("m", [2, 3, 4])
    def test_ranks_match_brute_force_and_reference(self, seed, m):
        rng = np.random.RandomState(seed)
        V = random_values(rng, 40, m, duplicates=seed % 2 == 0)
        ranks = moo.nondomination_ranks(V)
        assert np.array_equal(ranks, brute_ranks(V))
        assert np.array_equal(ranks, ref_moo.nondomination_ranks(V))
        assert np.array_equal(moo.nondomination_ranks(V, **CPU), ranks)

    def test_ranks_with_nan_rows(self):
        rng = np.random.RandomState(7)
        V = random_values(rng, 30, 3, nan_rows=True)
        assert np.array_equal(moo.nondomination_ranks(V), brute_ranks(V))
        assert np.array_equal(moo.nondomination_ranks(V, **CPU), brute_ranks(V))

    def test_ranks_with_mask(self):
        rng = np.random.RandomState(3)
        V = random_values(rng, 25, 2)
        mask = rng.uniform(size=25) < 0.6
        for kw in ({}, CPU):
            ranks = moo.nondomination_ranks(V, mask=mask, **kw)
            assert (ranks[~mask] == moo.EXCLUDED).all()
            assert np.array_equal(ranks[mask], brute_ranks(V[mask]))

    def test_front_mask_is_rank_zero(self):
        rng = np.random.RandomState(11)
        V = random_values(rng, 50, 3)
        front = moo.pareto_front_mask(V)
        assert np.array_equal(front, moo.nondomination_ranks(V) == 0)
        assert np.array_equal(front, ref_moo.pareto_front_mask(V))
        assert np.array_equal(moo.pareto_front_mask(V, **CPU), front)

    def test_duplicates_share_the_front(self):
        V = np.asarray([[1.0, 2.0], [1.0, 2.0], [0.5, 3.0]])
        assert moo.pareto_front_mask(V).all()
        assert moo.pareto_front_mask(V, **CPU).all()

    def test_single_objective_ranks_are_sorted_order(self):
        V = np.asarray([[3.0], [1.0], [2.0], [1.0]])
        assert np.array_equal(moo.nondomination_ranks(V), [2, 0, 1, 0])
        assert np.array_equal(moo.nondomination_ranks(V, **CPU), [2, 0, 1, 0])

    def test_chunked_paths_match_small(self, monkeypatch):
        rng = np.random.RandomState(5)
        V = random_values(rng, 40, 2)
        monkeypatch.setattr(moo, "_DOM_CHUNK", 7)
        monkeypatch.setattr(moo, "_TORCH_DOM_ELEMS", 40 * 2 * 7)
        assert np.array_equal(moo.nondomination_ranks(V), brute_ranks(V))
        assert np.array_equal(moo.nondomination_ranks(V, **CPU), brute_ranks(V))

    def test_prefilter_path_matches_full_reduction(self, monkeypatch):
        rng = np.random.RandomState(21)
        for m in (2, 3):
            V = rng.uniform(size=(moo._PREFILTER_MIN + 100, m))
            V[:5] = V[5:10]  # duplicated rows survive together
            fast = moo.pareto_front_mask(V)
            assert np.array_equal(fast, ref_moo.pareto_front_mask(V))
            assert np.array_equal(moo.pareto_front_mask(V, **CPU), fast)
            with monkeypatch.context() as mp:
                mp.setattr(moo, "_PREFILTER_MIN", 10**9)
                assert np.array_equal(moo.pareto_front_mask(V), fast)


class TestLossMatrix:
    def test_sign_flip_on_maximize(self):
        V = np.asarray([[1.0, 2.0], [3.0, 4.0]])
        L = moo.loss_matrix(V, [StudyDirection.MINIMIZE, StudyDirection.MAXIMIZE])
        assert np.array_equal(L, [[1.0, -2.0], [3.0, -4.0]])
        assert np.array_equal(V, [[1.0, 2.0], [3.0, 4.0]])  # input untouched

    def test_arity_mismatch_raises(self):
        with pytest.raises(ValueError):
            moo.loss_matrix(np.zeros((3, 2)), [StudyDirection.MINIMIZE])


class TestDominanceParity:
    """The port's torch engine against the reference's jax engine."""

    @pytest.mark.parametrize("n,m", [(17, 2), (33, 3), (64, 5)])
    def test_torch_equals_reference_jax(self, n, m):
        rng = np.random.RandomState(n * m)
        V = rng.randn(n, m)
        # duplicated + dominated rows exercise ties
        V[3] = V[0]
        V[5] = V[1] + 1.0
        ref = ref_moo.dominance_matrix(V, engine="jax")
        assert np.array_equal(moo.dominance_matrix(V, **CPU), ref)
        assert np.array_equal(moo.dominance_matrix(V), ref_moo.dominance_matrix(V))
        assert np.array_equal(
            moo.nondomination_ranks(V, **CPU), ref_moo.nondomination_ranks(V, engine="jax")
        )

    def test_device_engine_keeps_float64_precision(self):
        # rows apart in float64 but equal in float32: the torch compare
        # works on the float64 values, like numpy and the pairwise loop
        V = np.asarray([[1.0, 2.0], [1.0 + 1e-12, 2.0], [0.5, 3.0]])
        dom = moo.dominance_matrix(V, **CPU)
        assert dom[0, 1] and not dom[1, 0]
        assert np.array_equal(dom, moo.dominance_matrix(V))
        assert np.array_equal(moo.nondomination_ranks(V, **CPU), brute_ranks(V))

    def test_nan_rows_agree(self):
        rng = np.random.RandomState(5)
        V = rng.randn(21, 3)
        V[2, 1] = np.nan
        V[9] = np.nan
        ref = ref_moo.dominance_matrix(V, engine="jax")
        assert np.array_equal(moo.dominance_matrix(V, **CPU), ref)
        assert np.array_equal(moo.dominance_matrix(V), ref)

    def test_both_orientations_agree(self):
        rng = np.random.RandomState(8)
        V = rng.randn(25, 2)
        for dirs in (
            [StudyDirection.MINIMIZE, StudyDirection.MAXIMIZE],
            [StudyDirection.MAXIMIZE, StudyDirection.MAXIMIZE],
        ):
            L = moo.loss_matrix(V, dirs)
            assert np.array_equal(moo.pareto_front_mask(L, **CPU), moo.pareto_front_mask(L))

    def test_auto_engine_policy(self, monkeypatch):
        """``"auto"`` stays on numpy below the threshold, takes the torch
        compare past it, and on a CPU device goes back to numpy past the
        ceiling; a reduction that stays on numpy needs no device."""
        calls = []
        real = moo._dominance_torch
        monkeypatch.setattr(moo, "_dominance_torch", lambda V, d: calls.append(d) or real(V, d))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        small = np.random.RandomState(0).rand(kops.DOM_JIT_THRESHOLD // 4 - 1, 4)
        moo.dominance_matrix(small, engine="auto")  # no device needed
        assert calls == []
        mid = np.random.RandomState(1).rand(kops.DOM_JIT_THRESHOLD // 4 + 1, 4)
        with pytest.raises(RuntimeError, match="CUDA"):
            moo.dominance_matrix(mid, engine="auto")
        assert np.array_equal(
            moo.dominance_matrix(mid, engine="auto", device="cpu"), moo.dominance_matrix(mid)
        )
        assert calls == [torch.device("cpu")]
        past = kops.DOM_CPU_CEILING + 1
        assert moo._resolve("auto", past, "cpu", kops.DOM_CPU_CEILING) == ("numpy", None)
        assert moo._resolve("torch", past, "cpu", kops.DOM_CPU_CEILING)[0] == "torch"

    @pytest.mark.parametrize("engine", ["torch", "cuda"])
    def test_device_engines_need_cuda_or_an_explicit_cpu(self, monkeypatch, engine):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        V = np.random.RandomState(0).rand(5, 2)
        with pytest.raises(RuntimeError):
            moo.dominance_matrix(V, engine=engine)
        with pytest.raises(RuntimeError):
            moo.HypervolumeEstimator(method="mc", engine=engine).hypervolume(V, np.ones(2) * 2)
        if engine == "torch":
            moo.dominance_matrix(V, engine=engine, device="cpu")
        else:
            with pytest.raises(RuntimeError):
                moo.dominance_matrix(V, engine="cuda", device="cpu")


# -- crowding -----------------------------------------------------------------------


class TestCrowding:
    def test_boundary_points_are_infinite(self):
        V = np.asarray([[0.0, 3.0], [1.0, 2.0], [2.0, 1.0], [3.0, 0.0]])
        d = moo.crowding_distance(V)
        assert np.isinf(d[0]) and np.isinf(d[3])
        assert np.isfinite(d[1]) and np.isfinite(d[2])

    def test_matches_brute_force_and_reference(self):
        def brute_crowding(V):
            n, m = V.shape
            if n <= 2:
                return np.full(n, np.inf)
            out = np.zeros(n)
            for j in range(m):
                order = np.argsort(V[:, j], kind="stable")
                span = V[order[-1], j] - V[order[0], j]
                out[order[0]] = out[order[-1]] = np.inf
                for k in range(1, n - 1):
                    if span > 0:
                        out[order[k]] += (V[order[k + 1], j] - V[order[k - 1], j]) / span
            return out

        rng = np.random.RandomState(2)
        V = rng.uniform(size=(20, 3))
        assert np.allclose(moo.crowding_distance(V), brute_crowding(V))
        assert np.array_equal(moo.crowding_distance(V), ref_moo.crowding_distance(V))

    def test_constant_objective_contributes_nothing(self):
        V = np.asarray([[1.0, 0.0], [1.0, 0.5], [1.0, 1.0]])
        d = moo.crowding_distance(V)
        assert np.isinf(d[0]) and np.isinf(d[2]) and d[1] == 1.0


# -- hypervolume --------------------------------------------------------------------


class TestHypervolume:
    def test_2d_staircase_closed_form(self):
        for n in (2, 5, 17):
            ref = n * np.ones(2)
            pts = np.asarray([[n - 1 - i, i] for i in range(n)], dtype=float)
            assert moo.hypervolume(pts, ref) == n * n - n * (n - 1) // 2

    @pytest.mark.parametrize("m", [2, 3, 4])
    def test_unit_corners_closed_form(self, m):
        pts = np.eye(m)
        assert moo.hypervolume(pts, 2.0 * np.ones(m)) == 2**m - 1

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("m", [2, 3])
    def test_matches_grid_counting_and_reference(self, seed, m):
        rng = np.random.RandomState(seed)
        pts = rng.randint(0, 5, size=(8, m)).astype(float)
        ref = 6 * np.ones(m)
        hv = moo.hypervolume(pts, ref)
        assert hv == pytest.approx(grid_hypervolume(pts, ref))
        assert hv == ref_moo.hypervolume(pts, ref)

    def test_dominated_and_outside_points_are_free(self):
        ref = np.asarray([4.0, 4.0])
        base = np.asarray([[1.0, 1.0]])
        noisy = np.asarray([[1.0, 1.0], [2.0, 2.0], [5.0, 0.0], [1.0, 1.0]])
        assert moo.hypervolume(base, ref) == moo.hypervolume(noisy, ref)

    def test_empty_and_outside_only(self):
        ref = np.asarray([1.0, 1.0])
        assert moo.hypervolume(np.empty((0, 2)), ref) == 0.0
        assert moo.hypervolume(np.asarray([[2.0, 2.0]]), ref) == 0.0

    def test_contributions_bit_identical_to_reference(self):
        rng = np.random.RandomState(9)
        pts = rng.uniform(0, 1, size=(10, 4))
        ref = np.ones(4) * 1.2
        assert np.array_equal(
            moo.hypervolume_contributions(pts, ref),
            ref_moo.hypervolume_contributions(pts, ref),
        )
        assert np.array_equal(moo.default_reference_point(pts), ref_moo.default_reference_point(pts))


class TestHypervolumeParity:
    @pytest.mark.parametrize("m", [5, 6])
    def test_mc_engines_agree(self, m):
        rng = np.random.RandomState(m)
        pts = rng.rand(24, m)
        ref = np.full(m, 1.1)
        outs = {}
        for name, mod, engine, kw in (
            ("numpy", moo, "numpy", {}),
            ("torch", moo, "torch", {"device": "cpu"}),
            ("ref-numpy", ref_moo, "numpy", {}),
            ("ref-jax", ref_moo, "jax", {}),
            ("ref-pallas", ref_moo, "pallas", {}),
        ):
            est = mod.HypervolumeEstimator(method="mc", n_samples=4096, engine=engine, **kw)
            outs[name] = (est.hypervolume(pts, ref), est.contributions(pts, ref))
        # numpy is bit-identical across the packages, and so is the torch
        # engine to the reference's device engines (same float32 inputs,
        # integer counts)
        assert outs["numpy"][0] == outs["ref-numpy"][0]
        assert np.array_equal(outs["numpy"][1], outs["ref-numpy"][1])
        for dev in ("ref-jax", "ref-pallas"):
            assert outs["torch"][0] == outs[dev][0]
            assert np.array_equal(outs["torch"][1], outs[dev][1])
        assert abs(outs["torch"][0] - outs["numpy"][0]) < 1e-4
        np.testing.assert_allclose(outs["torch"][1], outs["numpy"][1], atol=1e-5)

    def test_mc_tracks_exact(self):
        rng = np.random.RandomState(1)
        pts = rng.rand(30, 3)
        ref = np.full(3, 1.1)
        est = moo.HypervolumeEstimator(method="mc", n_samples=100_000, **CPU)
        hv_exact = moo.hypervolume(pts, ref)
        assert abs(est.hypervolume(pts, ref) - hv_exact) / hv_exact < 0.05
        front = pts[moo.pareto_front_mask(pts)]
        c_exact = moo.hypervolume_contributions(front, ref)
        np.testing.assert_allclose(est.contributions(front, ref), c_exact, atol=5e-3)

    def test_auto_method_switch(self):
        est = moo.HypervolumeEstimator(device="cpu")
        assert est._use_exact(4) and not est._use_exact(5)
        rng = np.random.RandomState(2)
        pts = rng.rand(12, 3)
        ref = np.full(3, 1.1)
        assert est.hypervolume(pts, ref) == moo.hypervolume(pts, ref)

    @pytest.mark.parametrize("kw", [{"engine": "numpy"}, CPU], ids=["numpy", "torch"])
    def test_dominated_and_outside_points_contribute_zero(self, kw):
        est = moo.HypervolumeEstimator(method="mc", n_samples=8192, **kw)
        pts = np.asarray([
            [0.2, 0.2, 0.2, 0.2, 0.2],
            [0.5, 0.5, 0.5, 0.5, 0.5],  # dominated by row 0
            [2.0, 2.0, 2.0, 2.0, 2.0],  # outside the reference box
        ])
        contrib = est.contributions(pts, np.ones(5))
        assert contrib[0] > 0.0
        assert contrib[1] == 0.0
        assert contrib[2] == 0.0

    def test_auto_engine_stays_on_numpy_below_the_threshold(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        est = moo.HypervolumeEstimator(method="mc", n_samples=kops.DOM_JIT_THRESHOLD // 2 - 1)
        pts = np.asarray([[0.2] * 5, [0.1, 0.3, 0.2, 0.2, 0.2]])
        est.hypervolume(pts, np.ones(5))  # 2 x (threshold/2 - 1): numpy, no device
        big = moo.HypervolumeEstimator(method="mc", n_samples=kops.DOM_JIT_THRESHOLD)
        with pytest.raises(RuntimeError, match="CUDA"):
            big.hypervolume(pts, np.ones(5))


class TestHSSP:
    def test_selects_all_when_k_is_n(self):
        pts = np.asarray([[0.0, 2.0], [1.0, 1.0], [2.0, 0.0]])
        sel = moo.solve_hssp(pts, 3, np.asarray([3.0, 3.0]))
        assert sorted(sel.tolist()) == [0, 1, 2]

    def test_greedy_picks_largest_contributor_first(self):
        pts = np.asarray([[0.0, 2.9], [1.0, 1.0], [2.9, 0.0]])
        sel = moo.solve_hssp(pts, 1, np.asarray([3.0, 3.0]))
        assert sel.tolist() == [1]

    def test_subset_hv_close_to_best_pair(self):
        rng = np.random.RandomState(4)
        pts = rng.uniform(size=(7, 2))
        ref = np.ones(2) * 1.1
        sel = moo.solve_hssp(pts, 2, ref)
        got = moo.hypervolume(pts[sel], ref)
        best = max(
            moo.hypervolume(pts[list(pair)], ref)
            for pair in itertools.combinations(range(7), 2)
        )
        assert got >= 0.6 * best
        assert np.array_equal(sel, ref_moo.solve_hssp(pts, 2, ref))

    def test_mc_selection_matches_reference_engines(self):
        rng = np.random.RandomState(12)
        pts = rng.uniform(size=(14, 5))
        ref = moo.default_reference_point(pts)
        sel_np = moo.solve_hssp(
            pts, 4, ref, estimator=moo.HypervolumeEstimator(engine="numpy", n_samples=2048)
        )
        assert np.array_equal(sel_np, ref_moo.solve_hssp(
            pts, 4, ref, estimator=ref_moo.HypervolumeEstimator(engine="numpy", n_samples=2048)
        ))
        sel_torch = moo.solve_hssp(
            pts, 4, ref, estimator=moo.HypervolumeEstimator(n_samples=2048, **CPU)
        )
        assert np.array_equal(sel_torch, ref_moo.solve_hssp(
            pts, 4, ref, estimator=ref_moo.HypervolumeEstimator(engine="pallas", n_samples=2048)
        ))


    def test_batched_selection_at_motpe_shape_matches_reference_and_per_call_path(self):
        """MOTPE's boundary rank as phase 7 of chip_smoke.py meets it: 60
        points of a 5-objective DTLZ2 front, 25 to pick, 8192 samples.  The
        port's batched greedy on the ``"torch"`` engine picks what the
        reference's greedy picks with its device estimator, and every batch
        of hypervolumes it evaluates equals the per-call estimator's, bit
        for bit."""
        rng = np.random.RandomState(19)
        x = rng.uniform(size=(60, 4))
        g = 1.0 + rng.uniform(0, 0.05, (60, 1))
        cos, sin = np.cos(x * np.pi / 2), np.sin(x * np.pi / 2)
        pts = g * np.stack([np.prod(cos[:, :4 - i], axis=1) * (sin[:, 4 - i] if i else 1.0)
                            for i in range(5)], axis=1)
        ref = moo.default_reference_point(pts)
        batches = []

        class Checked(moo.HypervolumeEstimator):
            def _hypervolumes(self, sets, reference):
                got = super()._hypervolumes(sets, reference)
                want = np.asarray([self.hypervolume(P, reference) for P in sets])
                assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
                batches.append(len(sets))
                return got

        sel = moo.solve_hssp(pts, 25, ref, estimator=Checked(**CPU))
        assert len(batches) == 25  # the singletons, then one batch a greedy step
        assert sum(batches) == 60 + sum(60 - t + 1 for t in range(1, 25))
        want = ref_moo.solve_hssp(pts, 25, ref,
                                  estimator=ref_moo.HypervolumeEstimator(engine="jax"))
        assert np.array_equal(sel, want)
        assert len(set(sel.tolist())) == 25


# -- study integration --------------------------------------------------------------


def _mo_study(pkg, directions, values_list, **kw):
    study = pkg.create_study(
        directions=directions, sampler=pkg.RandomSampler(seed=0), **kw
    )
    for vals in values_list:
        t = study.ask()
        t.suggest_float("x", 0, 1)
        study.tell(t, vals)
    return study


class TestBestTrialsParity:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("engine", [{"engine": "numpy"}, CPU], ids=["numpy", "torch"])
    def test_engine_bit_identical_to_pairwise_loop(self, seed, engine):
        rng = np.random.RandomState(seed)
        m = 2 + seed % 3
        dirs = ["minimize" if rng.uniform() < 0.5 else "maximize" for _ in range(m)]
        values = rng.randint(0, 4, size=(30, m)).astype(float).tolist()
        fronts = {}
        for name, pkg, pairwise, kw in (
            ("port", hpo, _pairwise_best_trials, engine),
            ("ref", ref_hpo, ref_pairwise, {"engine": "numpy"}),
        ):
            study = _mo_study(pkg, dirs, values, **kw)
            # pruned trials must not affect the front
            for _ in range(3):
                t = study.ask()
                t.suggest_float("x", 0, 1)
                study.tell(t, state=pkg.TrialState.PRUNED)
            best = study.best_trials
            completed = study.get_trials(deepcopy=False, states=(pkg.TrialState.COMPLETE,))
            pair = pairwise(completed, study.directions)
            assert [t.number for t in best] == [t.number for t in pair]
            assert [t.values for t in best] == [t.values for t in pair]
            fronts[name] = [(t.number, t.values) for t in best]
        assert fronts["port"] == fronts["ref"]

    def test_infinite_values_match_pairwise_loop(self):
        study = _mo_study(
            hpo, ["minimize", "minimize"],
            [[np.inf, 0.0], [0.0, np.inf], [1.0, 1.0], [np.inf, np.inf]], engine="numpy",
        )
        engine = [t.number for t in study.best_trials]
        completed = study.get_trials(deepcopy=False, states=(TrialState.COMPLETE,))
        assert engine == [t.number for t in _pairwise_best_trials(completed, study.directions)]

    def test_pareto_front_arrays_match_best_trials(self):
        study = _mo_study(
            hpo, ["minimize", "maximize"],
            [[1.0, 1.0], [2.0, 2.0], [0.5, 0.5], [1.0, 3.0]], **CPU,
        )
        vals, nums = study.pareto_front()
        assert nums.tolist() == [t.number for t in study.best_trials]
        assert vals.tolist() == [t.values for t in study.best_trials]

    def test_single_objective_front_is_best_trial(self):
        study = _mo_study(hpo, ["minimize"], [[3.0], [1.0], [2.0]], engine="numpy")
        assert [t.number for t in study.best_trials] == [1]
        assert study.best_trial.number == 1

    def test_study_device_engine_needs_cuda_or_an_explicit_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        study = hpo.create_study(
            directions=["minimize", "minimize"], engine="torch", device="cpu",
            sampler=hpo.RandomSampler(seed=0),
        )
        study.optimize(lambda t: (t.suggest_float("x", 0, 1), 1.0), n_trials=3)
        assert len(study.best_trials) >= 1
        study._device = None  # the same study without an explicit CPU device
        with pytest.raises(RuntimeError, match="CUDA"):
            study.pareto_front()
