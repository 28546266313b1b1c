"""Tree-structured Parzen Estimator sampler (Bergstra et al., 2011).

The paper's default independent sampler (§3.1).  For each parameter:

1. split the observed (value, loss) history at the gamma-quantile into
   "below" (good) and "above" (bad) sets,
2. fit a Parzen estimator (truncated-Gaussian mixture + uniform prior
   component) to each set,
3. draw ``n_ei_candidates`` from the *below* estimator and keep the candidate
   maximizing ``log l(x) - log g(x)`` (the EI-equivalent ratio).

Numeric parameters with ``log=True`` are modeled in log space; ints are
modeled continuously and rounded; categoricals use smoothed weighted counts.

Hot path
--------
Observations come from the study's **columnar observation store**
(``core/records.py``): one ``(n_trials, n_params)`` model-space matrix
instead of a per-``ask`` re-walk of ``FrozenTrial`` lists.  On the first
suggest of each trial the sampler splits the loss vector once and slices
below/above observations for *all* parameters out of the matrix (the split,
weights, and gather are shared numpy ops — the old path redid them per
parameter in interpreted loops).  Candidate scoring evaluates both mixture
log-pdfs in one broadcasted matrix op; with the default ``engine="auto"``
the scorer moves onto the device (the hand-written CUDA Parzen kernel, or
its plain PyTorch version on ``device="cpu"``; see ``kernels/ops.py``) once
``n_candidates x n_components`` crosses the work threshold, and large
histories additionally amortize repeated asks through a device-built score
table (``log l - log g`` on a dense grid, ``np.interp`` per ask).  All
random draws come from the sampler's seeded ``np.random.RandomState`` on
the host — none happens on the device — so seeded ``engine="numpy"``
studies are bit-identical to the reference package's.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from ...kernels import ops as kops
from ...kernels.parzen import parzen_score
from ...kernels.ref import parzen_score_ref
from .. import telemetry
from ..distributions import BaseDistribution, CategoricalDistribution
from ..frozen import FrozenTrial, StudyDirection, TrialState
from .base import BaseSampler, sample_uniform_internal

if TYPE_CHECKING:
    from ..records import ObservationStore
    from ..search_space import ParamGroup
    from ..study import Study

__all__ = ["TPESampler", "default_gamma", "default_weights"]

EPS = 1e-12

try:  # vectorized C erf; the portable fallback loops math.erf per element
    from scipy.special import erf as _erf
except ImportError:  # pragma: no cover - scipy is an optional accelerator
    _erf = np.vectorize(math.erf)


def default_gamma(n: int) -> int:
    """Size of the 'below' (good) set (Optuna's default)."""
    return min(int(np.ceil(0.1 * n)), 25)


def default_weights(n: int) -> np.ndarray:
    """Older observations get linearly down-weighted past the 25 most recent."""
    if n == 0:
        return np.asarray([])
    if n < 25:
        return np.ones(n)
    ramp = np.linspace(1.0 / n, 1.0, n - 25)
    flat = np.ones(25)
    return np.concatenate([ramp, flat])


class _ParzenEstimator:
    """1-D truncated-Gaussian mixture over [low, high] (+ a wide prior)."""

    def __init__(
        self,
        mus: np.ndarray,
        low: float,
        high: float,
        weights: np.ndarray,
        consider_prior: bool = True,
        prior_weight: float = 1.0,
        magic_clip: bool = True,
    ):
        mus = np.asarray(mus, dtype=float)
        order = np.argsort(mus)
        mus = mus[order]
        weights = np.asarray(weights, dtype=float)[order]

        if consider_prior or len(mus) == 0:
            prior_mu = 0.5 * (low + high)
            prior_sigma = high - low if high > low else 1.0
            # place the prior into sorted position
            idx = np.searchsorted(mus, prior_mu)
            mus = np.insert(mus, idx, prior_mu)
            weights = np.insert(weights, idx, prior_weight)
            prior_pos = idx
        else:
            prior_pos = None

        n = len(mus)
        sigmas = np.empty(n)
        if n == 1:
            sigmas[0] = high - low if high > low else 1.0
        else:
            padded = np.concatenate([[low], mus, [high]])
            left = mus - padded[:-2]
            right = padded[2:] - mus
            sigmas = np.maximum(left, right)
        if prior_pos is not None:
            sigmas[prior_pos] = high - low if high > low else 1.0
        maxsigma = high - low if high > low else 1.0
        minsigma = (
            maxsigma / min(100.0, 1.0 + n) if magic_clip else EPS
        )
        self.mus = mus
        self.sigmas = np.clip(sigmas, minsigma, maxsigma)
        self.weights = weights / max(weights.sum(), EPS)
        self.low = low
        self.high = high
        # truncated-normal normalization + log component constants, computed
        # once per fit: log_pdf then reduces to one broadcasted quadratic
        z = _normal_cdf((high - self.mus) / self.sigmas) - _normal_cdf(
            (low - self.mus) / self.sigmas
        )
        self._log_norm = (
            -np.log(self.sigmas)
            - 0.5 * math.log(2 * math.pi)
            - np.log(np.maximum(z, EPS))
            + np.log(self.weights + EPS)
        )

    def sample(self, rng: np.random.RandomState, size: int) -> np.ndarray:
        comp = rng.choice(len(self.mus), size=size, p=self.weights)
        mus, sigmas = self.mus, self.sigmas
        low, high = self.low, self.high
        out = np.empty(size)
        for i, c in enumerate(comp):
            # rejection-free truncated normal via clipped resampling (bounded loops)
            v = float(rng.normal(mus[c], sigmas[c]))
            for _ in range(16):
                if low <= v <= high:
                    break
                v = float(rng.normal(mus[c], sigmas[c]))
            out[i] = min(max(v, low), high)
        return out

    def log_pdf(self, xs: np.ndarray) -> np.ndarray:
        return _mixture_log_pdf(
            np.asarray(xs, dtype=float), self.mus, self.sigmas, self._log_norm
        )


def _normal_cdf(x: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + _erf(np.asarray(x) / math.sqrt(2.0)))


def _logsumexp(a: np.ndarray, axis: int) -> np.ndarray:
    m = np.max(a, axis=axis, keepdims=True)
    return (m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True))).squeeze(axis)


def _mixture_log_pdf(
    cands: np.ndarray, mus: np.ndarray, sigmas: np.ndarray, log_norm: np.ndarray
) -> np.ndarray:
    """Mixture log-pdf over all candidates in one broadcasted matrix op.

    Works in-place on a single ``(n_cands, n_components)`` buffer.  The
    max-shifted exponent is floored at -700 before ``exp``: the shifted
    maximum is exactly 0, so the per-row sum is >= 1 and any term below
    ``exp(-700) ~ 1e-304`` is absorbed with no effect on the result — but
    flooring keeps ``exp`` out of the subnormal range, which costs ~30x on
    common hardware (far candidates in log-space domains land there
    constantly)."""
    z = cands[:, None] - mus[None, :]
    z /= sigmas[None, :]
    np.square(z, out=z)
    z *= -0.5
    z += log_norm[None, :]
    m = z.max(axis=1)
    z -= m[:, None]
    np.maximum(z, -700.0, out=z)
    np.exp(z, out=z)
    return m + np.log(z.sum(axis=1))


def _score_numpy(
    cands: np.ndarray,
    l_mus: np.ndarray, l_sigmas: np.ndarray, l_log_norm: np.ndarray,
    g_mus: np.ndarray, g_sigmas: np.ndarray, g_log_norm: np.ndarray,
) -> np.ndarray:
    """``log l(x) - log g(x)`` for all candidates, two batched mixture ops."""
    return _mixture_log_pdf(cands, l_mus, l_sigmas, l_log_norm) - _mixture_log_pdf(
        cands, g_mus, g_sigmas, g_log_norm
    )


def _triple(est: "_ParzenEstimator"):
    """One estimator's component triple, unpadded."""
    return est.mus, est.sigmas, est._log_norm


def _pad_est(est: "_ParzenEstimator"):
    """One estimator's component triple, pow2-padded for the device paths."""
    return (
        kops.pad_pow2_vec(est.mus, 0.0),
        kops.pad_pow2_vec(est.sigmas, 1.0),
        kops.pad_pow2_vec(est._log_norm, -np.inf),
    )


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array as a float32 tensor on ``device`` (the device engines
    run in float32, as the reference's device path does)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _gemm_score(
    device: torch.device,
    F: np.ndarray, l_coeffs: np.ndarray, l_const: np.ndarray,
    g_coeffs: np.ndarray, g_const: np.ndarray,
) -> np.ndarray:
    """Joint scorer over gemm features (numeric **and** categorical
    groups).  Every mixture — Gaussian quadratics expanded, categorical
    point-mass log-probs one-hot encoded (see ``_GroupParzen.gemm_coeffs``)
    — reduces to ``F @ C.T + const`` followed by a logsumexp over the
    component axis, so the whole acquisition is two matmuls.  Component
    axes arrive padded to power-of-two buckets with ``const = -inf`` and
    candidate rows to power-of-two counts."""
    Ft = _to_device(F, device)

    def side(coeffs, const):
        e = Ft @ _to_device(coeffs, device).T + _to_device(const, device)[None, :]
        return torch.logsumexp(e, dim=1)

    # full float32 products, as the reference's jnp matmul computes them:
    # TF32 is too coarse for a logsumexp argmax.
    with kops.full_float32_matmul():
        scores = side(l_coeffs, l_const) - side(g_coeffs, g_const)
    return scores.cpu().numpy()


#: joint-cache sentinel distinguishing "never fitted" from "fitted: declined"
_UNFIT = object()


class _GroupParzen:
    """d-dimensional Parzen estimator over one co-observed parameter group.

    One mixture component per observed trial **row** (plus an optional wide
    prior), each component a *product* kernel: per-dim truncated Gaussians
    for numeric parameters (Scott-rule bandwidth, magic-clipped) and
    smoothed point-mass kernels for categoricals.  Modeling whole rows is
    what makes the estimator genuinely multivariate — the good-set density
    ``l(x)`` preserves correlations between parameters (a narrow valley
    ``x ≈ y`` stays narrow), which per-parameter univariate TPE marginals
    cannot represent.
    """

    __slots__ = (
        "mus", "sigmas", "log_norm", "log_w", "weights", "lows", "highs",
        "cat_dims", "num_dims", "cat_index", "n_choices", "prior_weight",
        "_inv_var", "_lin", "_const", "_gemm",
    )

    def __init__(
        self,
        rows: np.ndarray,               # (n_obs, d) model-space observations
        dists: "list[BaseDistribution]",
        weights: np.ndarray,            # (n_obs,) recency weights
        consider_prior: bool = True,
        prior_weight: float = 1.0,
        magic_clip: bool = True,
    ):
        rows = np.asarray(rows, dtype=float)
        n_obs, d = rows.shape
        self.cat_dims = [j for j, ds in enumerate(dists) if isinstance(ds, CategoricalDistribution)]
        self.num_dims = [j for j in range(d) if j not in self.cat_dims]
        self.n_choices = {
            j: len(dists[j].choices) for j in self.cat_dims  # type: ignore[attr-defined]
        }
        self.prior_weight = float(prior_weight)

        lows = np.empty(d)
        highs = np.empty(d)
        for j, ds in enumerate(dists):
            lows[j], highs[j] = ds.internal_bounds(expand_int=True)
        self.lows, self.highs = lows, highs

        n_comp = n_obs + (1 if (consider_prior or n_obs == 0) else 0)
        mus = np.zeros((n_comp, d))
        mus[:n_obs] = rows
        w = np.empty(n_comp)
        w[:n_obs] = np.asarray(weights, dtype=float)
        # categorical index per (component, cat-dim); -1 marks the uniform
        # prior component
        cat_index = np.full((n_comp, len(self.cat_dims)), -1, dtype=np.int64)
        for c, j in enumerate(self.cat_dims):
            cat_index[:n_obs, c] = np.round(rows[:, j]).astype(np.int64)
        self.cat_index = cat_index

        ranges = np.where(highs > lows, highs - lows, 1.0)
        sigmas = np.ones((n_comp, d))
        if n_obs > 0:
            # Scott-rule bandwidth per dim, shared by all data components;
            # the prior keeps the full-range sigma
            scott = np.std(rows, axis=0) * float(n_obs) ** (-1.0 / (d + 4))
            maxsigma = ranges
            minsigma = (
                maxsigma / min(100.0, 1.0 + n_comp) if magic_clip
                else np.full(d, EPS)
            )
            sigmas[:n_obs] = np.clip(scott, minsigma, maxsigma)[None, :]
        if n_comp > n_obs:  # prior component: wide gaussian / uniform pmf
            mus[n_obs] = 0.5 * (lows + highs)
            sigmas[n_obs] = ranges
            w[n_obs] = prior_weight

        self.mus = mus
        self.sigmas = sigmas
        self.weights = w / max(w.sum(), EPS)
        self.log_w = np.log(self.weights + EPS)

        # truncated-normal normalization per (component, numeric dim)
        log_norm = np.zeros((n_comp, d))
        nd = self.num_dims
        if nd:
            z = _normal_cdf((highs[nd][None, :] - mus[:, nd]) / sigmas[:, nd]) - _normal_cdf(
                (lows[nd][None, :] - mus[:, nd]) / sigmas[:, nd]
            )
            log_norm[:, nd] = (
                -np.log(sigmas[:, nd])
                - 0.5 * math.log(2 * math.pi)
                - np.log(np.maximum(z, EPS))
            )
        self.log_norm = log_norm

        # gemm-form coefficients of the Gaussian quadratic (see log_pdf):
        # sum_j -0.5((x_j - mu_ij)/s_ij)^2 expands so candidate scoring is
        # two (n_cands, d) @ (d, n_comp) matmuls instead of a per-dim
        # broadcast loop over (n_cands, n_comp) temporaries
        inv_var = 1.0 / np.square(sigmas[:, nd]) if nd else np.zeros((n_comp, 0))
        self._inv_var = inv_var
        self._lin = mus[:, nd] * inv_var
        self._const = (
            -0.5 * (np.square(mus[:, nd]) * inv_var).sum(axis=1)
            + log_norm[:, nd].sum(axis=1)
            + self.log_w
        )
        self._gemm: "tuple[np.ndarray, np.ndarray] | None" = None

    # -- sampling ---------------------------------------------------------------

    def sample(self, rng: np.random.RandomState, size: int) -> np.ndarray:
        """Draw ``size`` model-space rows — fully vectorized (component
        choice, clipped-resample truncated normals, smoothed categorical
        kernels), unlike the univariate estimator's per-candidate loop."""
        comp = rng.choice(len(self.weights), size=size, p=self.weights)
        out = np.empty((size, self.mus.shape[1]))
        nd = self.num_dims
        if nd:
            mu = self.mus[comp][:, nd]
            sigma = self.sigmas[comp][:, nd]
            lo, hi = self.lows[nd][None, :], self.highs[nd][None, :]
            x = rng.normal(mu, sigma)
            for _ in range(16):  # bounded vectorized truncation retries
                bad = (x < lo) | (x > hi)
                if not bad.any():
                    break
                x[bad] = rng.normal(mu[bad], sigma[bad])
            out[:, nd] = np.clip(x, lo, hi)
        pw = self.prior_weight
        for c, j in enumerate(self.cat_dims):
            k = self.n_choices[j]
            m = self.cat_index[comp, c]
            # component pmf (1[c=m] + pw/k)/(1 + pw): keep the observed
            # choice w.p. 1/(1+pw), else uniform; prior component (m = -1)
            # is uniform outright
            keep = (rng.uniform(size=size) < 1.0 / (1.0 + pw)) & (m >= 0)
            out[:, j] = np.where(keep, m, rng.randint(k, size=size)).astype(float)
        return out

    # -- scoring ----------------------------------------------------------------

    def log_pdf(self, X: np.ndarray) -> np.ndarray:
        """Mixture log-density of ``(n_cands, d)`` rows: per-component
        product over dims, logsumexp over components.  The Gaussian block is
        evaluated in expanded quadratic form — two BLAS matmuls against the
        precomputed ``1/sigma^2`` coefficient matrices — so cost scales as a
        gemm instead of a python loop over dims (the expansion's cancellation
        error is ~1e-10 in log space, far below sampling noise)."""
        X = np.asarray(X, dtype=float)
        nd = self.num_dims
        if nd:
            Xn = X[:, nd]
            E = np.square(Xn) @ self._inv_var.T
            E -= 2.0 * (Xn @ self._lin.T)
            E *= -0.5
            E += self._const[None, :]
        else:
            E = np.broadcast_to(self._const[None, :], (len(X), len(self._const))).copy()
        pw = self.prior_weight
        for c, j in enumerate(self.cat_dims):
            k = self.n_choices[j]
            m = self.cat_index[None, :, c]
            hit = np.round(X[:, j, None]).astype(np.int64) == m
            p = np.where(
                m < 0, 1.0 / k,  # uniform prior component
                (hit.astype(float) + pw / k) / (1.0 + pw),
            )
            E += np.log(p + EPS)
        m_ = E.max(axis=1)
        E -= m_[:, None]
        np.maximum(E, -700.0, out=E)
        np.exp(E, out=E)
        return m_ + np.log(E.sum(axis=1))

    def gemm_coeffs(self) -> tuple[np.ndarray, np.ndarray]:
        """``(coeffs (n_comp, f), const (n_comp,))`` such that the exponent
        matrix of :meth:`log_pdf` is exactly ``gemm_features(X) @ coeffs.T +
        const`` — the device-friendly form covering **mixed** groups.

        Feature layout (matching :meth:`gemm_features`): the numeric block
        ``[x_j^2 | x_j]`` carries the expanded Gaussian quadratic, then one
        one-hot block per categorical dim whose coefficients are the
        component's point-mass log-probs ``log((1[c=m] + pw/k)/(1+pw) +
        EPS)`` (uniform ``log(1/k + EPS)`` for the prior component) — a
        one-hot feature dotted against that row *selects* the same
        ``log p`` term the numpy path adds elementwise."""
        cached = self._gemm
        if cached is not None:
            return cached
        pw = self.prior_weight
        blocks = [-0.5 * self._inv_var, self._lin]
        for c, j in enumerate(self.cat_dims):
            k = self.n_choices[j]
            m = self.cat_index[:, c][:, None]  # (n_comp, 1)
            hit = (m == np.arange(k)[None, :]).astype(float)
            p = np.where(m < 0, 1.0 / k, (hit + pw / k) / (1.0 + pw))
            blocks.append(np.log(p + EPS))
        self._gemm = cached = (np.concatenate(blocks, axis=1), self._const)
        return cached

    def gemm_features(self, X: np.ndarray) -> np.ndarray:
        """Candidate rows expanded to the :meth:`gemm_coeffs` feature layout:
        ``[X_num^2 | X_num | one-hot(cat_0) | one-hot(cat_1) | ...]``."""
        X = np.asarray(X, dtype=float)
        Xn = X[:, self.num_dims]
        blocks = [np.square(Xn), Xn]
        rows = np.arange(len(X))
        for j in self.cat_dims:
            k = self.n_choices[j]
            onehot = np.zeros((len(X), k))
            onehot[rows, np.round(X[:, j]).astype(np.int64)] = 1.0
            blocks.append(onehot)
        return np.concatenate(blocks, axis=1)


class _TrialFit:
    """Per-trial batched observation split, shared by every suggest call of
    one trial: the loss vector, its argsort, and the recency weights are
    computed once; per-parameter below/above slices are cut lazily from the
    snapshotted matrix columns.

    Built from one ``ObservationStore.snapshot()`` — never from live store
    properties — so concurrent ``tell``s from other threads (batched
    ``optimize(n_jobs=..)``) cannot grow a column under a mask captured at
    fit time."""

    __slots__ = (
        "version", "cols", "valid", "loss", "full_order", "w_by_n", "splits",
        "gamma", "weights_fn",
    )

    def __init__(self, version, cols, valid, loss, gamma, weights_fn):
        self.version = version
        self.cols: dict[str, np.ndarray] = cols
        self.valid: np.ndarray = valid
        self.loss: np.ndarray = loss
        self.full_order: np.ndarray | None = None
        self.w_by_n: dict[int, np.ndarray] = {}
        self.splits: dict[str, "tuple | None"] = {}
        self.gamma = gamma
        self.weights_fn = weights_fn

    def split(self, param_name: str) -> "tuple | None":
        """(n, below, above, w_below, w_above) in model space, or None when
        the parameter has never been observed."""
        if param_name in self.splits:
            return self.splits[param_name]
        col = self.cols.get(param_name)
        if col is None:
            self.splits[param_name] = None
            return None
        present = self.valid & ~np.isnan(col)
        idx = np.flatnonzero(present)
        n = len(idx)
        if n == 0:
            self.splits[param_name] = None
            return None
        vals = col[idx]
        losses = self.loss[idx]
        if np.array_equal(present, self.valid):
            # unconditional parameter: every such column shares one argsort
            if self.full_order is None:
                self.full_order = np.argsort(losses, kind="stable")
            order = self.full_order
        else:
            order = np.argsort(losses, kind="stable")
        n_below = self.gamma(n)
        w_all = self.w_by_n.get(n)
        if w_all is None:
            w_all = np.asarray(self.weights_fn(n), dtype=float)
            self.w_by_n[n] = w_all
        below_idx, above_idx = order[:n_below], order[n_below:]
        out = (n, vals[below_idx], vals[above_idx], w_all[below_idx], w_all[above_idx])
        self.splits[param_name] = out
        return out


def _motpe_split(
    L: np.ndarray, n_below: int, engine: str = "auto",
    device: "str | torch.device | None" = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """MOTPE below/above split of a loss matrix ``L`` (rows = observations,
    already minimize-oriented and finite): fill the below set by
    nondomination rank; break ties on the boundary rank by greedy
    hypervolume subset selection; weight the below rows by their normalized
    hypervolume contributions.  Returns ``(below_pos, above_pos, w_below)``
    with both index arrays sorted (chronological order, so the above set's
    recency weights stay meaningful).

    Hypervolume evaluations route through a ``HypervolumeEstimator``
    (exact WFG for m <= 4, seeded Monte-Carlo counting above — the exact
    recursion is exponential in m).  Its counting passes and the
    nondomination sort run on ``engine`` and ``device``."""
    from .. import moo

    n = len(L)
    n_below = int(min(max(n_below, 0), n))
    est = moo.HypervolumeEstimator(engine=engine, device=device)
    ranks = moo.nondomination_ranks(L, engine=engine, device=device)
    below = np.zeros(0, dtype=np.int64)
    for r in np.unique(ranks):
        members = np.flatnonzero(ranks == r)
        if len(below) + len(members) <= n_below:
            below = np.concatenate([below, members])
            continue
        want = n_below - len(below)
        if want > 0:
            ref = moo.default_reference_point(L[members])
            sel = moo.solve_hssp(L[members], want, ref, estimator=est)
            below = np.concatenate([below, members[sel]])
        break
    below = np.sort(below)
    above = np.setdiff1d(np.arange(n), below)
    if len(below) <= 1:
        w_below = np.ones(len(below))
    else:
        ref = moo.default_reference_point(L[below])
        contrib = moo.hypervolume_contributions(L[below], ref, estimator=est) + EPS
        w_below = np.clip(contrib / contrib.max(), 0.0, 1.0)
    return below, above, w_below


class _MOFit:
    """Multi-objective sibling of :class:`_TrialFit`: one rank+HSSP split of
    the values matrix per store version, shared by every suggest call (and
    every pending trial of a wave) on that history.  Per-parameter
    below/above slices drop NaN cells with their weights kept aligned."""

    __slots__ = ("version", "cols", "below_rows", "above_rows", "w_below", "weights_fn", "splits")

    def __init__(self, version, cols, below_rows, above_rows, w_below, weights_fn):
        self.version = version
        self.cols: dict[str, np.ndarray] = cols
        self.below_rows = below_rows      # absolute store rows, sorted
        self.above_rows = above_rows
        self.w_below = w_below            # aligned with below_rows
        self.weights_fn = weights_fn
        self.splits: dict[str, "tuple | None"] = {}

    def split(self, param_name: str) -> "tuple | None":
        """(n, below, above, w_below, w_above) in model space — the same
        tuple shape the single-objective :class:`_TrialFit` hands out, so
        the numeric/categorical samplers downstream are shared."""
        if param_name in self.splits:
            return self.splits[param_name]
        col = self.cols.get(param_name)
        if col is None:
            self.splits[param_name] = None
            return None
        b_vals = col[self.below_rows]
        b_keep = ~np.isnan(b_vals)
        a_vals = col[self.above_rows]
        a_keep = ~np.isnan(a_vals)
        n = int(b_keep.sum() + a_keep.sum())
        if n == 0:
            self.splits[param_name] = None
            return None
        out = (
            n,
            b_vals[b_keep],
            a_vals[a_keep],
            self.w_below[b_keep],
            np.asarray(self.weights_fn(int(a_keep.sum())), dtype=float),
        )
        self.splits[param_name] = out
        return out


class TPESampler(BaseSampler):
    def __init__(
        self,
        n_startup_trials: int = 10,
        n_ei_candidates: int = 24,
        gamma: Callable[[int], int] = default_gamma,
        weights: Callable[[int], np.ndarray] = default_weights,
        seed: int | None = None,
        consider_prior: bool = True,
        prior_weight: float = 1.0,
        consider_magic_clip: bool = True,
        consider_pruned_trials: bool = False,
        multivariate: bool = False,
        multi_objective: bool = False,
        engine: str = "auto",
        device: "str | torch.device | None" = None,
    ):
        """``engine`` selects the scoring backend: ``"auto"`` (default)
        dispatches candidate scoring to the device once ``n_candidates x
        n_components`` crosses the work threshold, staying on numpy below it
        (see ``kernels/ops.resolve_engine``); ``"numpy"`` pins the float64
        host path; ``"torch"`` forces the plain PyTorch scorer and
        ``"cuda"`` the hand-written CUDA kernel, regardless of size.
        ``device`` is where the device engines run: ``None`` means the card
        (``cuda``).  Every engine but ``"numpy"`` raises ``RuntimeError``
        here when no CUDA device is available, unless ``device="cpu"`` is
        passed (which ``engine="cuda"`` refuses).  A device error during
        scoring propagates; nothing falls back.

        ``multivariate=True`` switches batched ``Study.ask(n)`` waves to
        the group-decomposed **joint** TPE: one d-dimensional Parzen fit per
        co-observed parameter group (``sample_joint``), modeling parameter
        correlations the per-parameter univariate path cannot.  The default
        ``False`` keeps the univariate path.

        ``multi_objective=True`` enables the MOTPE split (Ozaki et al.,
        2020) on studies with several directions: the below/"good" set is
        chosen by nondomination rank over the observation store's values
        matrix, ties on the boundary rank broken by greedy hypervolume
        subset selection, and the below observations are weighted by their
        hypervolume contributions (``core/moo.py``; past four objectives by
        Monte-Carlo counting, on the CUDA kernel under ``engine="cuda"``).
        The split runs on the sampler's ``engine`` and ``device``.
        Everything downstream — Parzen fits, candidate scoring, the joint
        gemm path — is the existing machinery, so it composes with
        ``multivariate=True`` for block-sampled multi-objective waves.  With
        the default ``False`` a multi-objective study samples uniformly."""
        self._n_startup = n_startup_trials
        self._n_ei = n_ei_candidates
        self._gamma = gamma
        self._weights = weights
        self._rng = np.random.RandomState(seed)
        self._consider_prior = consider_prior
        self._prior_weight = prior_weight
        self._magic_clip = consider_magic_clip
        self._consider_pruned = consider_pruned_trials
        self._engine = kops.validate_engine(engine)
        self._device = kops.resolve_device(engine, device)
        self._multivariate = multivariate
        self._multi_objective = multi_objective
        self._mo_fit: tuple[Any, "_MOFit"] | None = None  # (cache key, fit)
        self._fit: tuple[Any, _TrialFit] | None = None  # (cache key, fit)
        # fitted estimators are deterministic functions of (observations,
        # bounds); memoize them per store version so back-to-back asks with
        # an unchanged history (batched ask, fixed-history scoring) skip the
        # refit entirely
        self._est_cache: tuple[Any, dict] | None = None
        self._joint_cache: tuple[Any, dict] | None = None  # per store version

    def reseed_rng(self, seed: int | None = None) -> None:
        self._rng = np.random.RandomState(seed)

    # -- engine policy -----------------------------------------------------------

    def _engine_for(self, work: int) -> str:
        """Concrete engine for one scoring call of ``work`` units
        (``n_candidates x n_components``)."""
        return kops.resolve_engine(
            self._engine, work, kops.TPE_JIT_THRESHOLD, self._device
        )

    # -- observation collection ------------------------------------------------

    def _trial_fit(self, study: "Study", trial: FrozenTrial) -> _TrialFit:
        """The batched split for this trial, built on first use and reused by
        every subsequent suggest of the same trial."""
        store = study.observations()
        version, states, values, last_iv, cols = store.snapshot()
        # keyed on the snapshot alone (not trial.number): the split is a pure
        # function of the finished history, so every pending trial asking
        # against one store version shares the fit
        key = (id(study), version)
        cached = self._fit
        if cached is not None and cached[0] == key:
            return cached[1]
        with telemetry.span("tpe.fit"):
            sign = 1.0 if study.direction == StudyDirection.MINIMIZE else -1.0
            complete = states == int(TrialState.COMPLETE)
            with np.errstate(invalid="ignore"):
                valid = complete & np.isfinite(values)
                loss = sign * values
                if self._consider_pruned:
                    pruned = (states == int(TrialState.PRUNED)) & np.isfinite(last_iv)
                    valid = valid | pruned
                    loss = np.where(complete, loss, sign * last_iv)
            fit = _TrialFit(version, cols, valid, loss, self._gamma, self._weights)
        self._fit = (key, fit)
        return fit

    # -- joint (multivariate) sampling --------------------------------------------

    def joint_enabled(self) -> bool:
        return self._multivariate

    def _group_split(self, study: "Study", names: list[str]):
        """(version, n_obs, below_rows, above_rows, w_below, w_above) over
        trials that observed *every* parameter of the group, or None below
        startup.  Reads one consistent store snapshot (concurrent tells from
        other worker threads replace, never mutate, the snapshot views)."""
        version, states, values, last_iv, cols = study.observations().snapshot()
        sign = 1.0 if study.direction == StudyDirection.MINIMIZE else -1.0
        complete = states == int(TrialState.COMPLETE)
        with np.errstate(invalid="ignore"):
            valid = complete & np.isfinite(values)
            loss = sign * values
            if self._consider_pruned:
                pruned = (states == int(TrialState.PRUNED)) & np.isfinite(last_iv)
                valid = valid | pruned
                loss = np.where(complete, loss, sign * last_iv)
        n_rows = len(states)
        M = (
            np.stack([cols.get(n, np.full(n_rows, np.nan)) for n in names], axis=1)
            if names and n_rows else np.empty((n_rows, len(names)))
        )
        rows = valid & ~np.isnan(M).any(axis=1)
        idx = np.flatnonzero(rows)
        n_obs = len(idx)
        if n_obs < self._n_startup:
            return None
        losses = loss[idx]
        order = np.argsort(losses, kind="stable")
        n_below = self._gamma(n_obs)
        w_all = np.asarray(self._weights(n_obs), dtype=float)
        Mi = M[idx]
        below_i, above_i = order[:n_below], order[n_below:]
        return version, n_obs, Mi[below_i], Mi[above_i], w_all[below_i], w_all[above_i]

    def _group_split_mo(self, study: "Study", names: list[str]):
        """Multi-objective sibling of :meth:`_group_split`: same return
        tuple, but the below set is selected by nondomination rank + greedy
        hypervolume subset selection over the values matrix and weighted by
        hypervolume contributions (MOTPE), restricted to trials that
        observed every parameter of the group."""
        from .. import moo

        store = study.observations()
        version, states, Vmat, arity, _, cols = store.snapshot_mo()
        directions = study.directions
        valid = self._mo_valid_rows(states, Vmat, arity, len(directions))
        n_rows = len(states)
        M = (
            np.stack([cols.get(n, np.full(n_rows, np.nan)) for n in names], axis=1)
            if names and n_rows else np.empty((n_rows, len(names)))
        )
        rows = valid & ~np.isnan(M).any(axis=1)
        idx = np.flatnonzero(rows)
        n_obs = len(idx)
        if n_obs < self._n_startup:
            return None
        L = moo.loss_matrix(Vmat[idx], directions)
        below_pos, above_pos, w_below = _motpe_split(
            L, self._gamma(n_obs), engine=self._engine, device=self._device
        )
        Mi = M[idx]
        w_above = np.asarray(self._weights(len(above_pos)), dtype=float)
        return version, n_obs, Mi[below_pos], Mi[above_pos], w_below, w_above

    def _joint_score(self, l_est: _GroupParzen, g_est: _GroupParzen, cands: np.ndarray) -> np.ndarray:
        with telemetry.span("tpe.score"):
            return self._joint_score_inner(l_est, g_est, cands)

    def _joint_score_inner(self, l_est: _GroupParzen, g_est: _GroupParzen, cands: np.ndarray) -> np.ndarray:
        work = len(cands) * (len(l_est.weights) + len(g_est.weights))
        if self._engine_for(work) != "numpy":
            # mixed numeric+categorical groups ride the same gemm: one-hot
            # features select the categorical point-mass log-probs (see
            # gemm_coeffs), so no group shape disables the device path.  It
            # is two plain matmuls, so "torch" and "cuda" share this scorer.
            n = len(cands)
            l_coeffs, l_const = l_est.gemm_coeffs()
            g_coeffs, g_const = g_est.gemm_coeffs()
            return _gemm_score(
                self._device,
                kops.pad_pow2_rows(l_est.gemm_features(cands), 0.0),
                kops.pad_pow2_rows(l_coeffs, 0.0),
                kops.pad_pow2_vec(l_const, -np.inf),
                kops.pad_pow2_rows(g_coeffs, 0.0),
                kops.pad_pow2_vec(g_const, -np.inf),
            )[:n]
        return l_est.log_pdf(cands) - g_est.log_pdf(cands)

    def sample_joint(
        self, study: "Study", group: "ParamGroup", n: int,
        trial_ids: "list[int] | None" = None,
        first_number: "int | None" = None,
    ) -> "np.ndarray | None":
        """Multivariate TPE block: **one** Parzen fit per group covers all
        ``n`` pending trials — ``n * n_ei_candidates`` candidate rows drawn
        from the good-set density, scored with one broadcasted
        ``log l - log g`` matrix op, argmax per pending trial.  On
        multi-objective studies (``multi_objective=True``) the below/above
        split comes from the MOTPE rank+hypervolume machinery instead of the
        gamma-quantile loss split; the fit and scoring are identical."""
        if not self._multivariate:
            return None
        if len(study.directions) > 1 and not self._multi_objective:
            return None
        with telemetry.span("tpe.sample_joint"):
            return self._sample_joint_inner(study, group, n)

    def _sample_joint_inner(
        self, study: "Study", group: "ParamGroup", n: int
    ) -> "np.ndarray | None":
        names = list(group.names)
        # cache lookup first: back-to-back waves on one store version reuse
        # the fitted estimators without re-running the split at all
        version = (id(study), study.observations().version)
        if self._joint_cache is None or self._joint_cache[0] != version:
            self._joint_cache = (version, {})
        cache = self._joint_cache[1]
        key = group.names
        ests = cache.get(key, _UNFIT)
        if ests is _UNFIT:
            if len(study.directions) > 1:
                split = self._group_split_mo(study, names)
            else:
                split = self._group_split(study, names)
            if split is None:
                cache[key] = ests = None  # sub-startup: stays cheap per wave
            else:
                _, n_obs, below, above, w_below, w_above = split
                dists = [group.dists[name] for name in names]
                l_est = _GroupParzen(
                    below, dists, w_below,
                    self._consider_prior, self._prior_weight, self._magic_clip,
                )
                g_est = _GroupParzen(
                    above, dists, w_above,
                    self._consider_prior, self._prior_weight, self._magic_clip,
                )
                cache[key] = ests = (l_est, g_est)
        if ests is None:
            return None
        l_est, g_est = ests

        cands = l_est.sample(self._rng, n * self._n_ei)
        score = self._joint_score(l_est, g_est, cands).reshape(n, self._n_ei)
        best = np.argmax(score, axis=1)
        return cands.reshape(n, self._n_ei, len(names))[np.arange(n), best]

    # -- sampling -----------------------------------------------------------------

    def _mo_valid_rows(
        self, states: np.ndarray, Vmat: np.ndarray, arity: np.ndarray, m: int
    ) -> np.ndarray:
        """Observation mask for the MOTPE split: COMPLETE trials with a
        finite full-arity objective vector.  ``consider_pruned_trials=True``
        additionally admits PRUNED trials that recorded a full vector —
        unlike the single-objective path there is no last-intermediate-value
        substitute (a scalarized report is one number, not an objective
        vector), so partially-reported pruned trials stay excluded."""
        ok = states == int(TrialState.COMPLETE)
        if self._consider_pruned:
            ok = ok | (states == int(TrialState.PRUNED))
        with np.errstate(invalid="ignore"):
            return ok & (arity == m) & np.isfinite(Vmat).all(axis=1)

    def _mo_trial_fit(self, study: "Study") -> "_MOFit | None":
        """The MOTPE split for the study's current history, memoized per
        store version (the split is a function of the values matrix alone,
        so every trial and every suggest on one history shares it)."""
        store = study.observations()
        version, states, Vmat, arity, _, cols = store.snapshot_mo()
        key = (id(study), version)
        cached = self._mo_fit
        if cached is not None and cached[0] == key:
            return cached[1]
        from .. import moo

        directions = study.directions
        valid = self._mo_valid_rows(states, Vmat, arity, len(directions))
        rows = np.flatnonzero(valid)
        if len(rows) == 0:
            return None
        L = moo.loss_matrix(Vmat[rows], directions)
        with telemetry.span("tpe.fit"):
            below_pos, above_pos, w_below = _motpe_split(
                L, self._gamma(len(rows)), engine=self._engine, device=self._device
            )
        fit = _MOFit(
            version, cols, rows[below_pos], rows[above_pos], w_below, self._weights
        )
        self._mo_fit = (key, fit)
        return fit

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        if len(study.directions) > 1:
            if not self._multi_objective:
                # multi-objective study without the MOTPE switch: uniform
                # sampling
                internal = sample_uniform_internal(self._rng, param_distribution)
                return param_distribution.to_external_repr(internal)
            fit = self._mo_trial_fit(study)
            split = fit.split(param_name) if fit is not None else None
        else:
            fit = self._trial_fit(study, trial)
            split = fit.split(param_name)
        if split is None or split[0] < self._n_startup:
            internal = sample_uniform_internal(self._rng, param_distribution)
            return param_distribution.to_external_repr(internal)
        _, below, above, w_below, w_above = split

        version = (id(study), fit.version)
        if self._est_cache is None or self._est_cache[0] != version:
            self._est_cache = (version, {})
        cache = self._est_cache[1]

        if isinstance(param_distribution, CategoricalDistribution):
            internal = self._sample_categorical(
                param_distribution, below, above, w_below, w_above, cache, param_name
            )
        else:
            internal = self._sample_numeric(
                param_distribution, below, above, w_below, w_above, cache, param_name
            )
        return param_distribution.to_external_repr(internal)

    def _score(self, l_est: _ParzenEstimator, g_est: _ParzenEstimator, cands: np.ndarray) -> np.ndarray:
        with telemetry.span("tpe.score"):
            return self._score_inner(l_est, g_est, cands)

    def _score_inner(self, l_est: _ParzenEstimator, g_est: _ParzenEstimator, cands: np.ndarray) -> np.ndarray:
        work = len(cands) * (len(l_est.mus) + len(g_est.mus))
        eng = self._engine_for(work)
        if eng == "numpy":
            return _score_numpy(
                cands,
                l_est.mus, l_est.sigmas, l_est._log_norm,
                g_est.mus, g_est.sigmas, g_est._log_norm,
            )
        # the component triples in float32 on the device: each estimator's
        # own length for the CUDA kernel, which splits any length across the
        # card; pow2-padded for the plain version, as the reference pads for
        # its Pallas kernel.  The scores come back to the host for the argmax
        if eng == "cuda":
            score, sides = parzen_score, (_triple(l_est), _triple(g_est))
        else:
            score, sides = parzen_score_ref, (_pad_est(l_est), _pad_est(g_est))
        args = [_to_device(a, self._device) for a in (cands, *sides[0], *sides[1])]
        return score(*args).cpu().numpy()

    def _sample_numeric(
        self,
        dist: BaseDistribution,
        below: np.ndarray,
        above: np.ndarray,
        w_below: np.ndarray,
        w_above: np.ndarray,
        cache: dict,
        param_name: str,
    ) -> float:
        low, high = dist.internal_bounds(expand_int=True)
        key = (param_name, low, high)
        ests = cache.get(key)
        if ests is None:
            l_est = _ParzenEstimator(
                below, low, high, w_below,
                self._consider_prior, self._prior_weight, self._magic_clip,
            )
            g_est = _ParzenEstimator(
                above, low, high, w_above,
                self._consider_prior, self._prior_weight, self._magic_clip,
            )
            cache[key] = ests = (l_est, g_est)
        l_est, g_est = ests
        cands = l_est.sample(self._rng, self._n_ei)
        table = cache.get((param_name, "table"))
        if table is not None:
            score = np.interp(cands, table[0], table[1])
        else:
            score = self._score(l_est, g_est, cands)
            self._maybe_build_table(cache, param_name, l_est, g_est, low, high)
        best = cands[int(np.argmax(score))]
        return float(dist.from_internal(np.asarray([best]))[0])

    def _maybe_build_table(
        self,
        cache: dict,
        param_name: str,
        l_est: _ParzenEstimator,
        g_est: _ParzenEstimator,
        low: float,
        high: float,
    ) -> None:
        """Amortize device scoring for repeat asks at one observation version.

        On the second score against the same ``(l_est, g_est)`` pair, the
        acquisition ``log l - log g`` is evaluated once on a dense
        ``SCORE_TABLE_SIZE``-point grid (a single large device call — the
        CUDA kernel's large shape) and later asks interpolate it on the
        host in O(n_ei).  Gated on ``magic_clip``: it guarantees every
        component has ``sigma >= (high - low) / 101``, so the acquisition is
        smooth at the grid scale and the piecewise-linear error is bounded by
        ``(101 / SCORE_TABLE_SIZE)^2 / 8 ~ 7.6e-5`` in log space — far below
        sampling noise.  Workloads that finish a trial per ask bump the
        observation version each time, never reach two hits, and keep direct
        scoring."""
        if not self._magic_clip or not np.isfinite([low, high]).all() or high <= low:
            return
        work = kops.SCORE_TABLE_SIZE * (len(l_est.mus) + len(g_est.mus))
        if self._engine_for(work) == "numpy":
            return
        hits_key = (param_name, "score_hits")
        hits = cache.get(hits_key, 0) + 1
        cache[hits_key] = hits
        if hits < 2:
            return
        xs = np.linspace(low, high, kops.SCORE_TABLE_SIZE)
        ys = np.asarray(self._score(l_est, g_est, xs))
        cache[(param_name, "table")] = (xs, ys)

    def _sample_categorical(
        self,
        dist: CategoricalDistribution,
        below: np.ndarray,
        above: np.ndarray,
        w_below: np.ndarray,
        w_above: np.ndarray,
        cache: dict,
        param_name: str,
    ) -> float:
        k = len(dist.choices)
        key = (param_name, "categorical", k)
        probs = cache.get(key)
        if probs is None:

            def weighted_probs(idxs: np.ndarray, ws: np.ndarray) -> np.ndarray:
                counts = np.full(k, self._prior_weight)
                # np.add.at accumulates in element order, matching a scalar loop
                np.add.at(counts, idxs.astype(int), ws)
                return counts / counts.sum()

            cache[key] = probs = (
                weighted_probs(below, w_below),
                weighted_probs(above, w_above),
            )
        p_l, p_g = probs
        cands = self._rng.choice(k, size=self._n_ei, p=p_l)
        score = np.log(p_l[cands] + EPS) - np.log(p_g[cands] + EPS)
        return float(cands[int(np.argmax(score))])
