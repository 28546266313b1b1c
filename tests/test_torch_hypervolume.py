"""The port's Monte-Carlo hypervolume counts against the reference's kernel.

On CPU tensors the port's ``mc_hv_counts`` takes its plain PyTorch version;
it must equal the reference's Pallas kernel (interpret mode) and the
reference's plain version **exactly**: the counts are integers computed from
the same float32 inputs, so there is no tolerance.  The shapes are the
reference kernel's own test shapes, plus NaN point rows, exact ties, a single
point and a hypothesis sweep.

The batched counts (``mc_hv_counts_sets``) make each set's samples from one
shared float64 draw ``u``: their plain version's samples must be the bits of
numpy's ``RandomState.uniform`` rounded to float32, and its counts, set by
set, the reference kernel's on those samples.
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
from repro_torch.kernels.ref import mc_hv_counts_ref, mc_hv_samples_ref  # noqa: E402


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


# -- the batched counts: samples made from one shared draw --------------------------


def _host_samples(seed, lo, ref, s):
    """The estimator's per-call draw: numpy's uniform in [lo, ref], rounded
    once to float32."""
    return np.random.RandomState(seed).uniform(lo, ref, size=(s, len(lo))).astype(np.float32)


@pytest.mark.parametrize("m", [2, 5, 8])
def test_samples_from_the_shared_draw_equal_numpy_uniform_bits(m):
    from repro_torch.core.moo import _uniform_draw

    rng = np.random.RandomState(m)
    s = 8192
    lo = rng.uniform(-2.0, 1.0, (4, m))
    lo[1, 0] = 0.0
    ref = lo + rng.uniform(0.0, 3.0, (4, m))
    ref[2] = lo[2]  # an empty box: every sample on lo
    span = ref - lo  # numpy's own range of uniform(lo, ref)
    u = _uniform_draw(0, s, m, torch.device("cpu"))
    got = port_hv.mc_hv_samples(torch.from_numpy(lo), torch.from_numpy(span), u)
    assert got.dtype == torch.float32 and got.shape == (4, s, m)
    for g in range(4):
        want = _host_samples(0, lo[g], ref[g], s)
        assert np.array_equal(got[g].numpy().view(np.uint32), want.view(np.uint32)), g


def _ragged_sets(rng, m):
    """Five sets of 7, 0, 1, 12 and 5 rows with their boxes up to 1.1: NaN
    rows in set 0, a zero-width box side in set 3 (its samples tie the
    lowest point there), set 4's rows duplicated."""
    sets = [rng.uniform(0, 1, (n, m)) for n in (7, 0, 1, 12, 5)]
    sets[0][2, 1] = np.nan
    sets[0][5] = np.nan
    sets[3][:, 0] = 0.25
    sets[4][3] = sets[4][1]
    lo = np.stack([np.nanmin(p, axis=0) if len(p) else np.zeros(m) for p in sets])
    span = 1.1 - lo
    span[3, 0] = 0.0
    return sets, lo, span


@pytest.mark.parametrize("m", [3, 5])
def test_set_counts_equal_the_reference_kernel_set_by_set(m):
    rng = np.random.RandomState(10 + m)
    s = 2048
    sets, lo, span = _ragged_sets(rng, m)
    u = torch.from_numpy(np.random.RandomState(3).random_sample((s, m)))
    pts = np.concatenate(sets).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum([len(p) for p in sets])]).astype(np.int32)
    port_hv.reset_launches()
    excl, total = port_hv.mc_hv_counts_sets(torch.from_numpy(pts), torch.from_numpy(offsets),
                                            torch.from_numpy(lo), torch.from_numpy(span), u)
    assert port_hv.set_launches() == 0  # CPU tensors take the plain version
    assert excl.dtype == total.dtype == torch.float32
    assert excl.shape == (len(pts),) and total.shape == (len(sets),)
    smp = mc_hv_samples_ref(torch.from_numpy(lo), torch.from_numpy(span), u).numpy()
    for g, p in enumerate(sets):
        a, b = offsets[g], offsets[g + 1]
        if b == a:
            assert float(total[g]) == 0.0
            continue
        k_excl, k_tot = jax_mc_hv_counts(p.astype(np.float32), smp[g], block_s=512,
                                         interpret=True)
        np.testing.assert_array_equal(excl[a:b].numpy(), np.asarray(k_excl))
        assert float(total[g]) == float(k_tot), g
    assert float(total[3]) > 0  # ties on the empty side count


def test_set_counts_check_their_inputs():
    u = torch.rand(10, 3, dtype=torch.float64)
    lo = torch.zeros(2, 3, dtype=torch.float64)
    pts = torch.rand(4, 3)
    off = torch.tensor([0, 1, 4], dtype=torch.int32)
    with pytest.raises(TypeError):
        port_hv.mc_hv_counts_sets(pts, off, lo.float(), lo, u)
    with pytest.raises(ValueError):
        port_hv.mc_hv_counts_sets(pts, off[:2], lo, lo, u)
    with pytest.raises(ValueError):
        port_hv.mc_hv_counts_sets(pts[:, :2].contiguous(), off, lo, lo, u)
    with pytest.raises(ValueError):
        port_hv.mc_hv_counts_sets(pts, off, lo[:, :2].contiguous(), lo, u)
