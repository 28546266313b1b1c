"""The port's Monte-Carlo hypervolume counts against the reference's kernel.

On CPU tensors the port's ``mc_hv_counts`` takes its plain PyTorch version;
it must equal the reference's Pallas kernel (interpret mode) and the
reference's plain version **exactly**: the counts are integers computed from
the same float32 inputs, so there is no tolerance.  The shapes are the
reference kernel's own test shapes, plus NaN point rows, exact ties, a single
point and a hypothesis sweep.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.hypervolume import mc_hv_counts as jax_mc_hv_counts  # noqa: E402
from repro_torch.kernels import hypervolume as port_hv  # noqa: E402
from repro_torch.kernels.ref import mc_hv_counts_ref  # noqa: E402


def _both(pts: np.ndarray, smp: np.ndarray, block_s: int = 1024):
    """(port excl, port total, reference-kernel excl, reference-kernel total,
    reference-plain excl, reference-plain total) as numpy, all float32."""
    pts = np.ascontiguousarray(pts, dtype=np.float32)
    smp = np.ascontiguousarray(smp, dtype=np.float32)
    excl, tot = port_hv.mc_hv_counts(torch.from_numpy(pts), torch.from_numpy(smp))
    k_excl, k_tot = jax_mc_hv_counts(pts, smp, block_s=block_s, interpret=True)
    r_excl, r_tot = jref.mc_hv_counts_ref(pts, smp)
    assert excl.dtype == torch.float32 and tot.dtype == torch.float32
    assert tot.dim() == 0 and excl.shape == (len(pts),)
    return (excl.numpy(), float(tot), np.asarray(k_excl), float(k_tot),
            np.asarray(r_excl), float(r_tot))


def _assert_exact(pts, smp, block_s=1024):
    excl, tot, k_excl, k_tot, r_excl, r_tot = _both(pts, smp, block_s)
    np.testing.assert_array_equal(excl, k_excl)
    np.testing.assert_array_equal(excl, r_excl)
    assert tot == k_tot == r_tot
    return excl, tot


@pytest.mark.parametrize(
    "n,m,s,bs",
    [
        (8, 3, 256, 256),    # single sample block
        (20, 4, 1000, 256),  # pow2 point padding + non-multiple samples
        (64, 6, 2048, 512),  # many-objective (the estimator's regime)
        (3, 2, 100, 1024),   # block_s > s (clamp path)
    ],
)
def test_matches_reference_kernel_exactly(n, m, s, bs):
    rng = np.random.RandomState(n * m + s)
    pts = rng.uniform(0, 1, (n, m))
    smp = rng.uniform(0, 1.1, (s, m))
    _assert_exact(pts, smp, bs)


def test_nan_point_rows_dominate_nothing():
    rng = np.random.RandomState(3)
    pts = rng.uniform(0, 1, (12, 5))
    pts[2, 1] = np.nan
    pts[7] = np.nan
    smp = rng.uniform(0, 1.1, (700, 5))
    excl, _ = _assert_exact(pts, smp)
    assert excl[2] == 0.0 and excl[7] == 0.0


def test_ties_count_as_domination():
    # samples on a point's coordinates (exact float32 ties) and duplicated
    # points: a tie dominates, and a duplicate shares every sample
    rng = np.random.RandomState(4)
    pts = rng.randint(0, 4, size=(10, 3)).astype(np.float32)
    pts[5] = pts[0]
    smp = rng.randint(0, 5, size=(300, 3)).astype(np.float32)
    smp[:10] = pts
    excl, tot = _assert_exact(pts, smp)
    assert excl[0] == excl[5] == 0.0  # duplicates are never alone
    assert tot >= 10


def test_single_point():
    rng = np.random.RandomState(5)
    pts = rng.uniform(0, 1, (1, 5))
    smp = rng.uniform(0, 1.2, (999, 5))
    excl, tot = _assert_exact(pts, smp)
    assert excl[0] == tot


def test_counts_are_consistent():
    rng = np.random.RandomState(1)
    pts = rng.uniform(0.4, 0.6, (16, 5))
    smp = rng.uniform(0, 1, (512, 5))
    excl, tot = _assert_exact(pts, smp, 128)
    assert excl.sum() <= tot <= len(smp)


def test_chunked_plain_version_matches_one_chunk(monkeypatch):
    from repro_torch.kernels import ref

    rng = np.random.RandomState(6)
    pts = torch.from_numpy(rng.uniform(0, 1, (9, 4)).astype(np.float32))
    smp = torch.from_numpy(rng.uniform(0, 1.1, (500, 4)).astype(np.float32))
    whole = mc_hv_counts_ref(pts, smp)
    monkeypatch.setattr(ref, "_MC_CUBE_ELEMS", 9 * 4 * 7)  # 7 samples a chunk
    chunked = mc_hv_counts_ref(pts, smp)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


@settings(max_examples=15, deadline=None)
@given(
    n=st.integers(min_value=1, max_value=40),
    m=st.integers(min_value=1, max_value=7),
    s=st.integers(min_value=1, max_value=600),
)
def test_property_sweep(n, m, s):
    rng = np.random.RandomState(n * 1000 + m * 100 + s)
    pts = rng.uniform(0, 1, (n, m))
    smp = rng.uniform(0, 1.1, (s, m))
    _assert_exact(pts, smp, 128)


@pytest.mark.parametrize(
    "points,samples,err",
    [
        (torch.zeros(4, 3, dtype=torch.float64), torch.zeros(5, 3), TypeError),
        (torch.zeros(4, 3), torch.zeros(5, 2), ValueError),
        (torch.zeros(4), torch.zeros(5, 1), ValueError),
        (torch.zeros(3, 4).t(), torch.zeros(5, 3), ValueError),
        (torch.zeros(4, 0), torch.zeros(5, 0), ValueError),
    ],
    ids=["dtype", "objectives", "rank", "contiguity", "no-objectives"],
)
def test_wrapper_checks_inputs(points, samples, err):
    with pytest.raises(err):
        port_hv.mc_hv_counts(points, samples)


def test_cpu_tensors_never_count_a_launch():
    port_hv.reset_launches()
    port_hv.mc_hv_counts(torch.rand(3, 2), torch.rand(10, 2))
    assert port_hv.launches() == 0
