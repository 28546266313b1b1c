"""The port's TPE device engine (``repro_torch/core/samplers/tpe.py``) and
engine policy (``repro_torch/kernels/ops.py``) against the reference.

* Parzen fits are bit-identical: both packages run the same float64 numpy.
* The ``"torch"`` engine on ``device="cpu"`` matches the reference's
  ``"pallas"`` engine (interpret mode) and its numpy engine within atol 2e-4
  / rtol 1e-4 — the reference's own cross-engine tolerance: the device
  engines score in float32, the numpy engine in float64.
* The score table interpolates direct scoring within atol 5e-3, as in the
  reference's ``tests/test_engine.py``.
* The joint gemm scorer matches the reference's jitted one within
  2e-4 / 1e-4 (both float32 matmuls), and its numpy path bit for bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.core as ref_hpo  # noqa: E402
from repro.core import distributions as ref_dists  # noqa: E402
from repro.core.samplers import tpe as ref_tpe  # noqa: E402
from repro_torch.core import distributions as port_dists  # noqa: E402
from repro_torch.core.samplers import tpe as port_tpe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATOL, RTOL = 2e-4, 1e-4


def _port_sampler(engine="torch"):
    return port_tpe.TPESampler(seed=0, engine=engine, device="cpu")


def _estimators(module, rng_seed, n_below, n_above, low=-3.0, high=3.0, **kw):
    rng = np.random.RandomState(rng_seed)
    out = []
    for n in (n_below, n_above):
        obs, w = rng.uniform(low, high, n), rng.uniform(0.5, 1.0, n)
        out.append(module._ParzenEstimator(obs, low, high, w, **kw))
    return out


# -- Parzen fits ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "n_obs,kw",
    [
        (0, {}), (1, {}), (7, {}), (300, {}),
        (40, {"consider_prior": False}),
        (40, {"magic_clip": False}),
        (40, {"prior_weight": 2.5}),
    ],
)
def test_parzen_estimator_bit_identical(n_obs, kw):
    rng = np.random.RandomState(n_obs)
    obs, w = rng.uniform(-2, 5, n_obs), rng.uniform(0.1, 1.0, n_obs)
    a = ref_tpe._ParzenEstimator(obs, -2.0, 5.0, w, **kw)
    b = port_tpe._ParzenEstimator(obs, -2.0, 5.0, w, **kw)
    for field in ("mus", "sigmas", "weights", "_log_norm"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    draws_a = a.sample(np.random.RandomState(3), 24)
    draws_b = b.sample(np.random.RandomState(3), 24)
    assert np.array_equal(draws_a, draws_b)


# -- univariate scoring -----------------------------------------------------------------


@pytest.mark.parametrize("n_below,n_above", [(3, 20), (25, 200), (7, 8), (25, 1500)])
def test_score_inner_torch_matches_reference_engines(n_below, n_above):
    seed = n_below * 100 + n_above
    l_ref, g_ref = _estimators(ref_tpe, seed, n_below, n_above)
    l_port, g_port = _estimators(port_tpe, seed, n_below, n_above)
    cands = np.random.RandomState(seed + 1).uniform(-3, 3, 64)
    port = _port_sampler("torch")._score_inner(l_port, g_port, cands)
    pallas = ref_tpe.TPESampler(seed=0, engine="pallas")._score_inner(l_ref, g_ref, cands)
    numpy_ref = ref_tpe.TPESampler(seed=0, engine="numpy")._score_inner(l_ref, g_ref, cands)
    assert port.shape == (64,)
    np.testing.assert_allclose(port, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port, numpy_ref, atol=ATOL, rtol=RTOL)
    # the numpy engines are the same float64 code
    numpy_port = _port_sampler("numpy")._score_inner(l_port, g_port, cands)
    assert np.array_equal(numpy_port, numpy_ref)


@pytest.mark.parametrize("n_below,n_above", [(1, 9), (25, 300), (25, 4071)])
def test_cuda_engine_passes_each_estimator_its_own_length(monkeypatch, n_below, n_above):
    """The ``"cuda"`` engine hands the scorer unpadded component triples (the
    kernel splits any length across the card); its scores equal the
    pow2-padded call's.  ``engine="cuda"`` refuses a CPU device when the
    sampler is built, so a ``device="cpu"`` sampler is switched to it after:
    its scorer then gets CPU tensors and runs the plain version here."""
    l_port, g_port = _estimators(port_tpe, n_below + n_above, n_below, n_above)
    cands = np.random.RandomState(n_above).uniform(-3, 3, 24)
    lengths = []
    score = port_tpe.parzen_score

    def recorder(c, *comps):
        lengths.append(tuple(len(t) for t in comps))
        return score(c, *comps)

    monkeypatch.setattr(port_tpe, "parzen_score", recorder)
    sampler = _port_sampler("torch")
    sampler._engine = "cuda"
    got = sampler._score_inner(l_port, g_port, cands)
    k_l, k_g = len(l_port.mus), len(g_port.mus)
    assert lengths == [(k_l, k_l, k_l, k_g, k_g, k_g)]
    assert (k_l, k_g) != (ops.pad_pow2_len(k_l), ops.pad_pow2_len(k_g))
    padded = [torch.from_numpy(np.asarray(a, np.float32))
              for a in (cands, *port_tpe._pad_est(l_port), *port_tpe._pad_est(g_port))]
    want = port_tpe.parzen_score_ref(*padded).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_auto_engine_moves_to_the_device_past_the_threshold():
    l_port, g_port = _estimators(port_tpe, 5, 25, 1000)
    s = port_tpe.TPESampler(seed=0, engine="auto", device="cpu")
    small = 24 * (len(l_port.mus) + len(g_port.mus))
    assert small > ops.TPE_JIT_THRESHOLD
    assert s._engine_for(small) == "torch"
    assert s._engine_for(ops.TPE_JIT_THRESHOLD - 1) == "numpy"
    out = s._score_inner(l_port, g_port, np.linspace(-3, 3, 24))
    assert out.dtype == np.float32  # the device path ran


def test_score_table_matches_direct_scoring():
    low, high = -3.0, 3.0
    l_est, g_est = _estimators(port_tpe, 3, 30, 400)
    s = _port_sampler("torch")
    cache = {}
    for _ in range(2):  # the table builds on the second score at one version
        s._maybe_build_table(cache, "x", l_est, g_est, low, high)
    xs, ys = cache[("x", "table")]
    assert len(xs) == ops.SCORE_TABLE_SIZE
    np.testing.assert_allclose(ys, s._score_inner(l_est, g_est, xs), atol=ATOL, rtol=RTOL)
    cands = np.random.RandomState(4).uniform(low, high, 256)
    direct = _port_sampler("numpy")._score_inner(l_est, g_est, cands)
    np.testing.assert_allclose(np.interp(cands, xs, ys), direct, atol=5e-3)


def test_numpy_engine_builds_no_table():
    l_est, g_est = _estimators(port_tpe, 3, 30, 400)
    cache = {}
    for _ in range(3):
        _port_sampler("numpy")._maybe_build_table(cache, "x", l_est, g_est, -3.0, 3.0)
    assert ("x", "table") not in cache


# -- joint (multivariate) gemm scorer -------------------------------------------------


def _group(dmod, tmod, seed, n_below, n_above):
    dists = [
        dmod.FloatDistribution(-2.0, 2.0),
        dmod.FloatDistribution(1e-4, 1e-1, log=True),
        dmod.IntDistribution(1, 9),
        dmod.CategoricalDistribution(["a", "b", "c"]),
    ]
    rng = np.random.RandomState(seed)

    def rows(n):
        return np.stack([
            rng.uniform(-2, 2, n), rng.uniform(np.log(1e-4), np.log(1e-1), n),
            rng.randint(1, 10, n).astype(float), rng.randint(0, 3, n).astype(float),
        ], axis=1)

    below, above = rows(n_below), rows(n_above)
    l_est = tmod._GroupParzen(below, dists, rng.uniform(0.5, 1, n_below))
    g_est = tmod._GroupParzen(above, dists, rng.uniform(0.5, 1, n_above))
    cands = l_est.sample(np.random.RandomState(seed + 1), 48)
    return l_est, g_est, cands


@pytest.mark.parametrize("n_below,n_above", [(5, 40), (25, 300)])
def test_joint_gemm_scorer_matches_reference(n_below, n_above):
    seed = n_below + n_above
    l_ref, g_ref, c_ref = _group(ref_dists, ref_tpe, seed, n_below, n_above)
    l_port, g_port, c_port = _group(port_dists, port_tpe, seed, n_below, n_above)
    assert np.array_equal(c_ref, c_port)
    port = _port_sampler("torch")._joint_score_inner(l_port, g_port, c_port)
    jitted = ref_tpe.TPESampler(seed=0, engine="jax")._joint_score_inner(l_ref, g_ref, c_ref)
    np.testing.assert_allclose(port, jitted, atol=ATOL, rtol=RTOL)
    numpy_port = _port_sampler("numpy")._joint_score_inner(l_port, g_port, c_port)
    numpy_ref = ref_tpe.TPESampler(seed=0, engine="numpy")._joint_score_inner(l_ref, g_ref, c_ref)
    assert np.array_equal(numpy_port, numpy_ref)
    np.testing.assert_allclose(port, numpy_ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("allow_tf32", [True, False])
def test_joint_gemm_scorer_restores_tf32_flag(allow_tf32):
    """The scorer turns TF32 off only around its own products: the
    process-global flag a user's training code set is left as it was."""
    l_est, g_est, cands = _group(port_dists, port_tpe, 3, 5, 40)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        _port_sampler("torch")._joint_score_inner(l_est, g_est, cands)
        assert torch.backends.cuda.matmul.allow_tf32 is allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_multivariate_wave_matches_reference_numpy():
    """A batched multivariate wave: one joint fit per group, bit-identical
    draws and picks on the numpy engine."""

    def run(hpo, sampler):
        study = hpo.create_study(sampler=sampler)

        def objective(t):
            x = t.suggest_float("x", -3, 3)
            c = t.suggest_categorical("c", ["u", "v"])
            return (x - 1) ** 2 + (c == "v")

        study.optimize(objective, n_trials=30, ask_batch=10)
        return np.array([t.params["x"] for t in study.trials])

    import repro_torch.core as port_hpo

    ref = run(ref_hpo, ref_hpo.TPESampler(seed=5, multivariate=True, engine="numpy"))
    port = run(port_hpo, port_hpo.TPESampler(seed=5, multivariate=True, engine="numpy"))
    assert np.array_equal(ref, port)


# -- engine policy ------------------------------------------------------------------------


def test_pad_helpers_match_reference():
    from repro.kernels import ops as ref_ops

    for n in (0, 1, 8, 9, 1000, 4097):
        assert ops.pad_pow2_len(n) == ref_ops.pad_pow2_len(n)
    v = np.arange(5, dtype=float)
    assert np.array_equal(ops.pad_pow2_vec(v, -np.inf), ref_ops.pad_pow2_vec(v, -np.inf))
    A = np.arange(6, dtype=float).reshape(3, 2)
    assert np.array_equal(ops.pad_pow2_rows(A, 0.0), ref_ops.pad_pow2_rows(A, 0.0))
    assert ops.TPE_JIT_THRESHOLD == ref_ops.TPE_JIT_THRESHOLD
    assert ops.SCORE_TABLE_SIZE == ref_ops.SCORE_TABLE_SIZE


def test_validate_and_resolve_engine():
    for eng in ("auto", "numpy", "torch", "cuda"):
        assert ops.validate_engine(eng) == eng
    for bad in ("jax", "pallas", "triton"):
        with pytest.raises(ValueError):
            ops.validate_engine(bad)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for eng in ("numpy", "torch", "cuda"):
        assert ops.resolve_engine(eng, 0, 10**9, cpu) == eng
        assert ops.resolve_engine(eng, 10**9, 1, cuda) == eng
    assert ops.resolve_engine("auto", 100, 1000, cuda) == "numpy"
    assert ops.resolve_engine("auto", 2000, 1000, cuda) == "cuda"
    assert ops.resolve_engine("auto", 2000, 1000, cpu) == "torch"
