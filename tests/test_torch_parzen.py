"""The port's fused Parzen scorer (``repro_torch.kernels.parzen``) against the
reference package's Pallas kernel (interpret mode) and its jnp oracle.

Inputs are numpy-seeded fitted mixtures, handed to both packages as float32
arrays.  Tolerance atol 2e-4 / rtol 1e-4: the reference's own engine
tolerance (``tests/test_engine.py``), since both sides sum in float32 in a
different order.  On the CPU the wrapper runs its plain PyTorch version;
``tests/test_torch_cuda.py`` holds the hand-written kernel to it on a card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.samplers.tpe import _ParzenEstimator as RefParzenEstimator  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.parzen import parzen_score as jax_parzen_score  # noqa: E402
from repro_torch.core.samplers.tpe import _pad_est  # noqa: E402
from repro_torch.kernels import parzen  # noqa: E402
from repro_torch.kernels.ref import parzen_score_ref  # noqa: E402

ATOL, RTOL = 2e-4, 1e-4


def _mixture(rng, n_obs, low=-3.0, high=3.0):
    """One fitted mixture (``n_obs`` observations + the prior component) as
    float32 ``(mus, sigmas, log_norm)``."""
    est = RefParzenEstimator(
        rng.uniform(low, high, n_obs), low, high, rng.uniform(0.5, 1.0, n_obs),
    )
    return tuple(np.asarray(a, np.float32) for a in (est.mus, est.sigmas, est._log_norm))


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrays]


def _three_ways(cands, l_side, g_side):
    """Port (CPU tensors), reference Pallas kernel (interpret) and reference
    jnp oracle on the same float32 inputs."""
    port = parzen.parzen_score(*_torch((cands, *l_side, *g_side))).numpy()
    pallas = np.asarray(jax_parzen_score(cands, *l_side, *g_side, interpret=True))
    oracle = np.asarray(jref.parzen_score_ref(cands, *l_side, *g_side))
    return port, pallas, oracle


@pytest.mark.parametrize("n_below,n_above", [(3, 20), (25, 200), (7, 8)])
def test_matches_reference_kernel_and_oracle(n_below, n_above):
    rng = np.random.RandomState(n_below * 100 + n_above)
    l_side, g_side = _mixture(rng, n_below), _mixture(rng, n_above)
    cands = rng.uniform(-3.5, 3.5, 64).astype(np.float32)
    port, pallas, oracle = _three_ways(cands, l_side, g_side)
    assert port.shape == (64,) and port.dtype == np.float32
    np.testing.assert_allclose(port, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_cands", [64, 4096])
def test_matches_reference_at_k256(n_cands):
    rng = np.random.RandomState(n_cands)
    l_side, g_side = _mixture(rng, 255), _mixture(rng, 255)
    cands = rng.uniform(-3.5, 3.5, n_cands).astype(np.float32)
    port, pallas, oracle = _three_ways(cands, l_side, g_side)
    np.testing.assert_allclose(port, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port, oracle, atol=ATOL, rtol=RTOL)


def test_neg_inf_padding_is_inert():
    """pow2 padding with ``log_norm = -inf`` (the sampler's ``_pad_est``)
    leaves every score unchanged, on one side or on both."""
    rng = np.random.RandomState(7)
    l_est = RefParzenEstimator(rng.uniform(-3, 3, 5), -3.0, 3.0, np.ones(5))
    g_est = RefParzenEstimator(rng.uniform(-3, 3, 13), -3.0, 3.0, np.ones(13))
    cands = rng.uniform(-3, 3, 32)
    raw = lambda e: (e.mus, e.sigmas, e._log_norm)  # noqa: E731
    padded_l, padded_g = _pad_est(l_est), _pad_est(g_est)
    assert len(padded_l[0]) == 8 and np.isneginf(padded_l[2][6:]).all()
    direct = parzen.parzen_score(*_torch((cands, *raw(l_est), *raw(g_est))))
    for l_side, g_side in ((padded_l, raw(g_est)), (padded_l, padded_g)):
        via_pad = parzen.parzen_score(*_torch((cands, *l_side, *g_side)))
        torch.testing.assert_close(via_pad, direct, atol=1e-6, rtol=0)
    assert torch.isfinite(direct).all()


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.RandomState(1)
    args = _torch((rng.uniform(-3, 3, 16), *_mixture(rng, 4), *_mixture(rng, 9)))
    before = parzen.launches()
    out = parzen.parzen_score(*args)
    assert parzen.launches() == before
    torch.testing.assert_close(out, parzen_score_ref(*args), atol=0, rtol=0)


@pytest.mark.parametrize(
    "mutate,exc",
    [
        (lambda a: [a[0].double()] + a[1:], TypeError),
        (lambda a: [a[0].reshape(4, 4)] + a[1:], ValueError),
        (lambda a: [torch.stack([a[0], a[0]], 1)[:, 0]] + a[1:], ValueError),
        (lambda a: a[:1] + [a[1][:2]] + a[2:], ValueError),
        (lambda a: a[:4] + [x[:0] for x in a[4:]], ValueError),
        (lambda a: [x.to("meta") for x in a], ValueError),
        (lambda a: [a[0].numpy()] + a[1:], TypeError),
    ],
    ids=["float64", "2-D", "strided", "ragged-side", "empty-side", "meta-device", "numpy"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(mutate, exc):
    rng = np.random.RandomState(2)
    args = _torch((rng.uniform(-3, 3, 16), *_mixture(rng, 3), *_mixture(rng, 5)))
    with pytest.raises(exc):
        parzen.parzen_score(*mutate(args))
