"""The port's hand-written CUDA kernels on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no ``jax``, so it runs where only the port is installed.
Parzen tolerance atol 2e-4 / rtol 1e-4 against the plain PyTorch version on
the same tensors: the reference's own engine tolerance, since the kernel
sums its online logsumexp in another order than ``torch.logsumexp``.  The
Monte-Carlo hypervolume counts are integers and are held exactly.
Flash attention is held to its plain version within the reference's kernel
tolerances (``tests/test_kernels.py``): 1e-4 in float32 and 2e-2 in
bfloat16, where the kernel's float32 sums run in another order, the
bfloat16 kernel carries the probabilities as two bfloat16 terms into ``P V``
and the output is rounded once to bfloat16.  The fused cross-entropy is held
to its plain version within atol 1e-4 / rtol 1e-5 (float32 sums and an
online logsumexp in another order, on NLLs of order 10); the bfloat16
tensor-core kernel also to the plain version run in float64 on the same
bf16-rounded operands, at the same tolerance.  Both bfloat16 kernels give
bit-identical outputs on repeated launches.  Both written-out backwards are
held to autograd through the plain versions.  The SSD scan is held to
its plain version within the reference's kernel tolerance, atol 2e-3
(float32 sums in another order and another chunk length: the kernel cuts
``min(chunk, S)``-step chunks with a ragged last one, the plain version
halves the chunk until it divides S), the bfloat16 tensor-core kernel also
to the plain version run in float64 at the same tolerance, and its
written-out backward to autograd through the plain version.  The Parzen
kernel splits the components across blocks and merges in a fixed order, so
two calls give equal bits.  The batched hypervolume counts make each set's
samples on the card: the samples equal the host's float32 draw bit for bit
and the counts the plain version's exactly.  The sLSTM recurrence is held to its
plain version run in float64 within the reference's kernel tolerance, atol
1e-4, with rtol 1e-4 for the state's n and m, which grow with the steps
(float32 sums in another order over at most 40 steps), and its
written-out backward to autograd through the float32 plain version; the
scan and the decode kernel sum in one fixed order, so two calls give equal
bits, and the decode kernel equals the scan's first step.  A seeded
``engine="cuda"`` TPE study over a served sqlite file (wire protocol 2, the
cache) makes the same trials as in memory, and two spawned workers on the
card each launch the Parzen kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as hpo
from repro_torch.core.samplers.tpe import _ParzenEstimator, _pad_est
from repro_torch.core import moo
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hypervolume, parzen
from repro_torch.kernels.ref import flash_attention_ref, mc_hv_counts_ref, parzen_score_ref
from repro_torch.models import init_model_params
from repro_torch.serve import Engine

ATOL, RTOL = 2e-4, 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _args(device, cands, l_side, g_side):
    return [
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        for a in (cands, *l_side, *g_side)
    ]


@pytest.mark.parametrize(
    "n_cands,n_below,n_above",
    [(24, 31, 4095), (4096, 25, 2022), (1000, 7, 7), (1, 0, 0), (129, 2, 1500)],
)
def test_kernel_matches_plain_version(cuda_device, n_cands, n_below, n_above):
    rng = np.random.RandomState(n_cands + n_above)
    l_est = _ParzenEstimator(rng.uniform(-3, 3, n_below), -3.0, 3.0, np.ones(n_below))
    g_est = _ParzenEstimator(rng.uniform(-3, 3, n_above), -3.0, 3.0, np.ones(n_above))
    cands = rng.uniform(-3.5, 3.5, n_cands)
    raw = lambda e: (e.mus, e.sigmas, e._log_norm)  # noqa: E731
    for l_side, g_side in ((raw(l_est), raw(g_est)), (_pad_est(l_est), _pad_est(g_est))):
        args = _args(cuda_device, cands, l_side, g_side)
        before = parzen.launches()
        out = parzen.parzen_score(*args)
        torch.cuda.synchronize()
        assert parzen.launches() == before + 1
        assert out.device.type == "cuda" and out.shape == (n_cands,)
        torch.testing.assert_close(out, parzen_score_ref(*args), atol=ATOL, rtol=RTOL)


def test_padding_alone_on_one_side_is_inert(cuda_device):
    """A side made of one real component and many ``-inf`` pads scores as
    that component alone."""
    rng = np.random.RandomState(3)
    cands = rng.uniform(-3, 3, 300)
    one = (np.array([0.5]), np.array([0.7]), np.array([-1.2]))
    padded = tuple(np.concatenate([a, np.full(2047, f)]) for a, f in zip(one, (0.0, 1.0, -np.inf)))
    g_side = (rng.uniform(-3, 3, 64), rng.uniform(0.2, 1, 64), np.full(64, -4.0))
    direct = parzen.parzen_score(*_args(cuda_device, cands, one, g_side))
    via_pad = parzen.parzen_score(*_args(cuda_device, cands, padded, g_side))
    torch.testing.assert_close(via_pad, direct, atol=1e-5, rtol=0)


def test_cuda_tensor_of_the_wrong_type_raises(cuda_device):
    rng = np.random.RandomState(4)
    args = _args(cuda_device, rng.uniform(-3, 3, 8), *[(np.zeros(3), np.ones(3), np.zeros(3))] * 2)
    with pytest.raises(TypeError):
        parzen.parzen_score(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        parzen.parzen_score(args[0].cpu(), *args[1:])


def _mixture(rng, n):
    """``n`` components, a quarter of them ``-inf`` padding once there are 8."""
    mus, sigmas, ln = rng.uniform(-3, 3, n), rng.uniform(0.2, 1.5, n), rng.uniform(-6, -1, n)
    if n >= 8:
        ln[rng.choice(n, n // 4, replace=False)] = -np.inf
    return mus, sigmas, ln


@pytest.mark.parametrize("k", [1, 8, 2023, 4096, 65536])
@pytest.mark.parametrize("n_cands", [1, 24, 1000, 4096])
def test_split_kernel_at_every_shape_is_repeatable(cuda_device, n_cands, k):
    """The component axis split across blocks: one candidate to a table,
    one component to 65536, sides of unequal length (k and k // 3 + 5) with
    ``-inf`` padding; one launch counted a call, and two calls give equal
    bits (the partials merge in a fixed order)."""
    rng = np.random.RandomState(7 * n_cands + k)
    args = _args(cuda_device, rng.uniform(-3.5, 3.5, n_cands), _mixture(rng, k),
                 _mixture(rng, k // 3 + 5))
    before = parzen.launches()
    out = parzen.parzen_score(*args)
    again = parzen.parzen_score(*args)
    torch.cuda.synchronize()
    assert parzen.launches() == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, parzen_score_ref(*args), atol=ATOL, rtol=RTOL)


def test_nan_propagates_as_in_the_plain_version(cuda_device):
    """A NaN candidate scores NaN and leaves the others as they were; a NaN
    component makes every score NaN, as ``torch.logsumexp`` does."""
    rng = np.random.RandomState(9)
    args = _args(cuda_device, rng.uniform(-3, 3, 1000), _mixture(rng, 2023), _mixture(rng, 4096))
    clean = parzen.parzen_score(*args)
    args[0][5] = float("nan")
    out = parzen.parzen_score(*args)
    assert torch.isnan(out[5]) and int(torch.isnan(out).sum()) == 1
    assert torch.equal(out[:5], clean[:5]) and torch.equal(out[6:], clean[6:])
    args[0][5] = 0.5
    args[4][100] = float("nan")
    out = parzen.parzen_score(*args)
    assert bool(torch.isnan(out).all())
    torch.testing.assert_close(out, parzen_score_ref(*args), atol=ATOL, rtol=RTOL, equal_nan=True)


def test_graph_capture_keeps_eager_calls_on_its_stream_right(cuda_device):
    """A call captured in a CUDA graph takes a zeroed workspace of its own
    from the graph's pool (zeroed only when the graph replays): an eager
    call on the capture's stream before any replay still scores right, and
    the replay gives the same bits."""
    rng = np.random.RandomState(11)
    args = _args(cuda_device, rng.uniform(-3.5, 3.5, 24), _mixture(rng, 2023),
                 _mixture(rng, 4096))
    want = parzen_score_ref(*args)
    stream = torch.cuda.Stream(cuda_device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = parzen.parzen_score(*args)
    with torch.cuda.stream(stream):
        eager = parzen.parzen_score(*args)
    stream.synchronize()
    torch.testing.assert_close(eager, want, atol=ATOL, rtol=RTOL)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_cuda_engine_agrees_with_numpy(cuda_device):
    """The reference's 14-trial engine-agreement study, on the card."""
    objective = lambda t: t.suggest_float("x", -4, 4) ** 2  # noqa: E731
    params = {}
    for engine in ("numpy", "cuda"):
        study = hpo.create_study(sampler=hpo.TPESampler(seed=11, engine=engine))
        before = parzen.launches()
        study.optimize(objective, n_trials=14)
        params[engine] = [t.params["x"] for t in study.trials]
        if engine == "cuda":
            assert parzen.launches() == before + 4  # one per trial after 10 startup trials
    np.testing.assert_allclose(params["cuda"], params["numpy"], rtol=1e-5)


def test_default_study_runs_on_the_card(cuda_device):
    """``create_study()`` needs no device argument on a machine with a card;
    a wave of asks against one history builds the score table."""
    study = hpo.create_study(sampler=hpo.TPESampler(seed=0, engine="cuda"))
    study.optimize(lambda t: (t.suggest_float("x", -3, 3) - 1) ** 2, n_trials=20)
    before = parzen.launches()
    for trial in study.ask(8):
        trial.suggest_float("x", -3, 3)
    assert parzen.launches() == before + 3  # two direct scores, then the table build
    assert hpo.create_study().sampler._device.type == "cuda"


def test_joint_scorer_on_the_card_agrees_with_numpy_and_keeps_tf32(cuda_device):
    """The multivariate gemm scorer runs full float32 products on the card
    and leaves the caller's TF32 setting as it found it."""
    from repro_torch.core import distributions as dists
    from repro_torch.core.samplers.tpe import _GroupParzen

    group = [
        dists.FloatDistribution(-2.0, 2.0),
        dists.FloatDistribution(1e-4, 1e-1, log=True),
        dists.IntDistribution(1, 9),
        dists.CategoricalDistribution(["a", "b", "c"]),
    ]
    rng = np.random.RandomState(7)

    def rows(n):
        return np.stack([
            rng.uniform(-2, 2, n), rng.uniform(np.log(1e-4), np.log(1e-1), n),
            rng.randint(1, 10, n).astype(float), rng.randint(0, 3, n).astype(float),
        ], axis=1)

    l_est = _GroupParzen(rows(25), group, rng.uniform(0.5, 1, 25))
    g_est = _GroupParzen(rows(600), group, rng.uniform(0.5, 1, 600))
    cands = l_est.sample(np.random.RandomState(8), 96)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on_card = hpo.TPESampler(seed=0, engine="cuda")._joint_score_inner(l_est, g_est, cands)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    on_host = hpo.TPESampler(seed=0, engine="numpy")._joint_score_inner(l_est, g_est, cands)
    np.testing.assert_allclose(on_card, on_host, atol=ATOL, rtol=RTOL)


# -- Monte-Carlo hypervolume counts -------------------------------------------------


def _mc_inputs(device, n, s, m, seed, nan_rows=False, ties=False):
    rng = np.random.RandomState(seed)
    if ties:
        pts = rng.randint(0, 4, size=(n, m)).astype(np.float32)
        smp = rng.randint(0, 5, size=(s, m)).astype(np.float32)
        smp[: min(n, s)] = pts[: min(n, s)]
    else:
        pts = rng.uniform(0, 1, (n, m)).astype(np.float32)
        smp = rng.uniform(0, 1.1, (s, m)).astype(np.float32)
    if nan_rows:
        pts[::7, 1] = np.nan
    return (torch.from_numpy(pts).to(device), torch.from_numpy(smp).to(device))


@pytest.mark.parametrize(
    "n,s,m,kw",
    [
        (8, 256, 3, {}), (20, 1000, 4, {}), (64, 2048, 6, {}), (3, 100, 2, {}),
        (30, 3000, 5, {"nan_rows": True}), (40, 2000, 3, {"ties": True}),
        (1, 8192, 5, {}), (25, 8192, 5, {}), (4096, 65536, 8, {}),
        (5000, 3000, 5, {}),  # past the per-block exclusive counters
        (10, 500, 20, {}),  # past the register-held sample coordinates
    ],
)
def test_mc_hv_kernel_equals_plain_version(cuda_device, n, s, m, kw):
    pts, smp = _mc_inputs(cuda_device, n, s, m, seed=n + s + m, **kw)
    before = hypervolume.launches()
    excl, total = hypervolume.mc_hv_counts(pts, smp)
    torch.cuda.synchronize()
    assert hypervolume.launches() == before + 1
    excl_r, total_r = mc_hv_counts_ref(pts, smp)
    assert excl.device.type == "cuda" and excl.dtype == torch.float32 and excl.shape == (n,)
    assert torch.equal(excl, excl_r) and torch.equal(total, total_r)


def test_mc_hv_cuda_tensor_of_the_wrong_type_or_shape_raises(cuda_device):
    pts, smp = _mc_inputs(cuda_device, 5, 50, 3, seed=0)
    with pytest.raises(TypeError):
        hypervolume.mc_hv_counts(pts.double(), smp)
    with pytest.raises(ValueError):
        hypervolume.mc_hv_counts(pts, smp[:, :2].contiguous())
    with pytest.raises(ValueError):
        hypervolume.mc_hv_counts(pts[0], smp)
    with pytest.raises(ValueError):
        hypervolume.mc_hv_counts(pts.cpu(), smp)


def _set_inputs(device, m, s, seed):
    """Ragged point sets (7, 0, 1, 12 and 5 rows; NaN rows, a zero-width box
    side whose samples tie the lowest point, duplicated rows) with their
    boxes up to 1.1 and a shared draw, as ``mc_hv_counts_sets`` takes them."""
    rng = np.random.RandomState(seed)
    sets = [rng.uniform(0, 1, (n, m)) for n in (7, 0, 1, 12, 5)]
    sets[0][2, 1] = np.nan
    sets[0][5] = np.nan
    sets[3][:, 0] = 0.25
    sets[4][3] = sets[4][1]
    lo = np.stack([np.nanmin(p, axis=0) if len(p) else np.zeros(m) for p in sets])
    span = 1.1 - lo
    span[3, 0] = 0.0
    off = np.concatenate([[0], np.cumsum([len(p) for p in sets])]).astype(np.int32)
    u = np.random.RandomState(seed + 1).random_sample((s, m))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (np.concatenate(sets).astype(np.float32), off, lo, span, u)]


@pytest.mark.parametrize("m,s", [(3, 2048), (5, 8192), (8, 1000), (20, 700)])
def test_mc_hv_sets_kernel_equals_plain_version(cuda_device, m, s):
    from repro_torch.kernels.ref import mc_hv_counts_sets_ref

    args = _set_inputs(cuda_device, m, s, seed=m + s)
    before = hypervolume.set_launches()
    excl, total = hypervolume.mc_hv_counts_sets(*args)
    torch.cuda.synchronize()
    assert hypervolume.set_launches() == before + 1
    excl_r, total_r = mc_hv_counts_sets_ref(*args)
    assert excl.dtype == total.dtype == torch.float32 and total.shape == (5,)
    assert torch.equal(excl, excl_r) and torch.equal(total, total_r)
    assert float(total[1]) == 0.0  # the set of no points
    if m <= 5:  # the zero-width side's ties dominate (in 20 dims 12 points rarely do)
        assert float(total[3]) > 0.0


@pytest.mark.parametrize("m", [2, 5, 8])
def test_mc_hv_samples_on_the_card_equal_the_host_draw_bits(cuda_device, m):
    rng = np.random.RandomState(m)
    lo = rng.uniform(-2.0, 1.0, (3, m))
    ref = lo + rng.uniform(0.0, 3.0, (3, m))
    u = torch.from_numpy(np.random.RandomState(0).random_sample((8192, m))).to(cuda_device)
    got = hypervolume.mc_hv_samples(torch.from_numpy(lo).to(cuda_device),
                                    torch.from_numpy(ref - lo).to(cuda_device), u).cpu().numpy()
    for g in range(3):
        host = np.random.RandomState(0).uniform(lo[g], ref[g], (8192, m)).astype(np.float32)
        assert np.array_equal(got[g].view(np.uint32), host.view(np.uint32)), g


def test_hssp_on_the_card_batches_each_greedy_step(cuda_device):
    """60 points, 25 picks: one batched launch for the singletons and one a
    greedy step; the picks equal the plain version's on the card, and every
    batch's hypervolumes the per-call estimator's, bit for bit."""
    rng = np.random.RandomState(7)
    pts = rng.uniform(0.1, 1.0, (60, 5))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)  # a front: none dominates another
    ref = moo.default_reference_point(pts)

    class Checked(moo.HypervolumeEstimator):
        def _hypervolumes(self, sets, reference):
            got = super()._hypervolumes(sets, reference)
            want = np.asarray([self.hypervolume(P, reference) for P in sets])
            assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
            return got

    hypervolume.reset_launches()
    sel = moo.solve_hssp(pts, 25, ref, estimator=moo.HypervolumeEstimator(engine="cuda"))
    assert hypervolume.set_launches() == 25
    assert np.array_equal(sel, moo.solve_hssp(pts, 25, ref,
                                              estimator=Checked(engine="cuda")))
    assert np.array_equal(sel, moo.solve_hssp(pts, 25, ref,
                                              estimator=moo.HypervolumeEstimator(engine="torch")))


def _dtlz2_wave_study(engine, n_trials=48, wave=16):
    study = hpo.create_study(
        directions=["minimize"] * 5,
        sampler=hpo.TPESampler(seed=0, multi_objective=True, engine=engine),
    )
    for _ in range(n_trials // wave):
        results = []
        for trial in study.ask(wave):
            x = np.array([trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(6)])
            g = float(np.sum((x[4:] - 0.5) ** 2))
            f = []
            for i in range(5):
                v = 1.0 + g
                for j in range(4 - i):
                    v *= np.cos(x[j] * np.pi / 2)
                if i > 0:
                    v *= np.sin(x[4 - i] * np.pi / 2)
                f.append(float(v))
            results.append((trial, f))
        study.tell_batch(results)
    return study


def test_motpe_cuda_and_torch_engines_pick_identical_parameters(cuda_device):
    """A seeded 5-objective MOTPE study: the kernel's counts equal the plain
    version's, so the two card engines split, fit and sample alike."""
    params = {}
    for engine in ("torch", "cuda"):
        hypervolume.reset_launches()
        study = _dtlz2_wave_study(engine)
        params[engine] = [sorted(t.params.items()) for t in study.trials]
        if engine == "cuda":
            assert hypervolume.launches() > 0
    assert params["cuda"] == params["torch"]


def test_pareto_front_on_the_card_equals_numpy(cuda_device):
    rng = np.random.RandomState(9)
    V = rng.uniform(size=(3000, 5))
    V[:10] = V[10:20]  # duplicated rows
    V[20:30] = V[30:40] * (1.0 + 1e-12)  # apart in float64, tied in float32
    assert np.array_equal(
        moo.pareto_front_mask(V, engine="cuda"), moo.pareto_front_mask(V, engine="numpy")
    )
    assert np.array_equal(
        moo.nondomination_ranks(V[:600], engine="cuda"), moo.nondomination_ranks(V[:600])
    )
    study = _dtlz2_wave_study("numpy", n_trials=32)
    on_card = hpo.Study(study.study_name, study._storage, engine="cuda")
    assert [t.number for t in on_card.best_trials] == [t.number for t in study.best_trials]
    assert on_card.pareto_front()[1].tolist() == study.pareto_front()[1].tolist()


# -- flash attention ---------------------------------------------------------------


FA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _qkv(device, dtype, B, Hq, Hkv, Sq, Skv, D, seed, scale=1.0):
    rng = np.random.RandomState(seed)

    def make(H, S):
        return torch.from_numpy((rng.randn(B, H, S, D) * scale).astype(np.float32)).to(device, dtype)

    return make(Hq, Sq), make(Hkv, Skv), make(Hkv, Skv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Skv,D,kw",
    [
        (1, 2, 2, 64, 64, 32, {}),                                      # MHA
        (2, 4, 2, 128, 128, 32, {}),                                    # GQA 2x
        (1, 8, 1, 96, 96, 16, {}),                                      # MQA, ragged tiles
        (1, 2, 2, 128, 128, 128, {}),
        (2, 4, 2, 200, 200, 64, {"window": 32}),
        (1, 4, 2, 100, 100, 16, {"softcap": 10.0}),
        (1, 2, 2, 48, 48, 16, {"causal": False}),
        (2, 4, 2, 40, 100, 64, {"q_offset": 30, "kv_len": 70}),         # prefill on a cache
        (1, 16, 8, 300, 300, 256, {"window": 64, "softcap": 50.0}),     # gemma2 widths
        (2, 4, 2, 33, 90, 256, {"q_offset": 50, "kv_len": 83, "window": 40, "softcap": 50.0}),
    ],
)
def test_flash_attention_kernel_matches_plain_version(cuda_device, dtype, B, Hq, Hkv, Sq, Skv, D, kw):
    q, k, v = _qkv(cuda_device, dtype, B, Hq, Hkv, Sq, Skv, D, Sq + D, scale=2.0)
    before = fa.launches()
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches() == before + 1
    assert out.dtype == dtype and out.shape == q.shape and out.device.type == "cuda"
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, **kw).float(),
                               atol=FA_TOL[dtype], rtol=FA_TOL[dtype])
    # the model's [B, S, H, D] tensors as strided views, no copy; the output
    # keeps their strides
    bshd = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    out_view = fa.flash_attention(*(t.transpose(1, 2) for t in bshd), **kw)
    assert out_view.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out_view, out, atol=0, rtol=0)


def test_flash_attention_cuda_tensor_of_the_wrong_kind_raises(cuda_device):
    q, k, v = _qkv(cuda_device, torch.float32, 1, 2, 2, 16, 16, 16, 0)
    before = fa.launches()
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :12], k[..., :12], v[..., :12])  # head dim 12
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    assert fa.launches() == before


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize(
    "Sq,Skv,kw",
    [
        (200, 200, {}),                                       # causal, ragged tiles
        (200, 200, {"window": 48}),
        (200, 200, {"softcap": 10.0}),
        (200, 200, {"softcap": 50.0, "window": 100}),
        (130, 130, {"causal": False}),
        (40, 100, {"q_offset": 30, "kv_len": 70}),           # kv_len ends mid-tile
        (33, 90, {"q_offset": 50, "kv_len": 83, "window": 40, "softcap": 50.0}),
    ],
)
def test_flash_attention_bf16_tensor_core_kernel_at_every_head_width(cuda_device, D, Sq, Skv, kw):
    """The bfloat16 (tensor-core) kernel at every head width it is built for,
    read through the model's [B, S, H, D] strides, against its plain version."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 4, 2, Sq, Skv, D, Sq + D, scale=2.0)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    before = fa.launches()
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches() == before + 1
    assert out.stride() == q.stride()
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, **kw).float(),
                               atol=FA_TOL[torch.bfloat16], rtol=FA_TOL[torch.bfloat16])


@pytest.mark.parametrize("D", [64, 256])
def test_flash_attention_bf16_gqa8_odd_length_is_deterministic(cuda_device, D):
    """A served group's odd length (1895) with eight query heads a kv head,
    in the model's layout: the plain version's result, and the same bits on
    a second launch."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 8, 1, 1895, 1895, D, D, scale=2.0)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    kw = {"window": 1024, "softcap": 50.0} if D == 256 else {}
    out = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, **kw).float(),
                               atol=FA_TOL[torch.bfloat16], rtol=FA_TOL[torch.bfloat16])


def test_flash_attention_bf16_misaligned_strides_raise(cuda_device):
    """The tensor-core kernel's 16-byte copies need rows a multiple of 8
    elements apart: a slice of width 8 out of 28-wide rows does not give
    them, and the call raises without launching."""
    base = torch.zeros(1, 16, 2, 8 * 3 + 4, device=cuda_device, dtype=torch.bfloat16)
    q = base[..., 4:12].transpose(1, 2)  # head stride 28, an 8-byte aligned start
    before = fa.launches()
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    assert fa.launches() == before


def _smoke_engine(arch, engine, device):
    # float32 compute: the two engines then differ by float32 rounding alone,
    # far below any gap between the top two logits (chip_smoke.py holds the
    # bfloat16 main path to a gap rule instead)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="float32")
    model = init_model_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    return cfg, Engine(cfg, model, capacity=64, slots=4, device=device, engine=engine)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-9b"])
def test_engine_cuda_and_torch_give_the_same_greedy_tokens(cuda_device, arch):
    """The prefill's attention on the kernel and on the plain version, from
    the same weights: the same greedy tokens; the kernel launches once per
    layer and prefill."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 256, size=n) for n in (5, 23, 17, 9, 30)]  # two groups
    outs = {}
    for engine in ("torch", "cuda"):
        cfg, eng = _smoke_engine(arch, engine, cuda_device)
        fa.reset_launches()
        outs[engine] = eng.generate(prompts, max_new=12)
        torch.cuda.synchronize()
        n_layers = len(cfg.superblock) * cfg.n_superblocks
        assert fa.launches() == (n_layers * 2 if engine == "cuda" else 0)
    assert outs["cuda"] == outs["torch"]


# -- the training slice: fused cross-entropy and both gradients -----------------------

#: the kernel against its plain version: the same float32 products summed in
#: another order, and an online logsumexp against torch.logsumexp; the NLL
#: rows are of order 5-15 (logits of standard deviation near 3)
CE_ATOL, CE_RTOL = 1e-4, 1e-5


def _ce_inputs(device, T, D, V, x_dtype, w_dtype, tied, seed, label_dtype=torch.int32):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(T, D).astype(np.float32)).to(device, x_dtype)
    scale = 3.0 / np.sqrt(D)
    if tied:  # the tied head: a transposed view of a [V, D] embedding
        w = torch.from_numpy((rng.randn(V, D) * scale).astype(np.float32)).to(device, w_dtype).T
    else:
        w = torch.from_numpy((rng.randn(D, V) * scale).astype(np.float32)).to(device, w_dtype)
    labels = torch.from_numpy(rng.randint(0, V, T)).to(device, label_dtype)
    labels[0] = -1  # no label logit
    return x, w, labels


@pytest.mark.parametrize(
    "T,D,V,x_dtype,w_dtype,tied,softcap",
    [(1000, 48, 1000, torch.float32, torch.float32, False, 0.0),
     (1000, 48, 1000, torch.bfloat16, torch.float32, False, 30.0),
     (100, 48, 1000, torch.float32, torch.float32, True, 0.0),
     (512, 64, 256, torch.bfloat16, torch.float32, False, 0.0),
     (300, 96, 5000, torch.bfloat16, torch.bfloat16, True, 30.0),
     (7, 16, 50, torch.float32, torch.bfloat16, False, 0.0),
     (1000, 48, 1000, torch.bfloat16, torch.float32, True, 30.0),   # tied: a transposed view
     (130, 136, 300, torch.bfloat16, torch.bfloat16, False, 0.0),   # untied bf16 W
     (257, 2048, 4099, torch.bfloat16, torch.float32, False, 0.0),  # tinyllama's depth
     (1, 64, 50, torch.bfloat16, torch.float32, True, 30.0)],
)
def test_crossentropy_kernel_matches_plain_version(cuda_device, T, D, V, x_dtype, w_dtype, tied,
                                                   softcap):
    """Labels outside [0, V) pick no logit.  A bfloat16 x takes the
    tensor-core kernel, which is also held to the plain version run in
    float64 on the same bf16-rounded operands at the same tolerance (its
    K-loop sums exact bf16 products in float32 in another order, and float64
    is the truth both are measured against); a second launch gives the same
    bits."""
    from repro_torch.kernels import crossentropy as ce
    from repro_torch.kernels.ref import crossentropy_lse_ref

    x, w, labels = _ce_inputs(cuda_device, T, D, V, x_dtype, w_dtype, tied, T + V)
    if T > 1:
        labels[1] = V
    before = ce.launches()
    nll, lse = ce.crossentropy_forward(x, w, labels, softcap)
    torch.cuda.synchronize()
    assert ce.launches() == before + 1
    want_nll, want_lse = crossentropy_lse_ref(x, w, labels, softcap)
    torch.testing.assert_close(nll, want_nll, atol=CE_ATOL, rtol=CE_RTOL)
    torch.testing.assert_close(lse, want_lse, atol=CE_ATOL, rtol=CE_RTOL)
    got64 = ce.crossentropy_forward(x, w, labels.long(), softcap)
    torch.testing.assert_close(got64[0], nll, atol=0, rtol=0)
    if T > 1:
        assert nll[0] == lse[0] and nll[1] == lse[1]
    if x_dtype == torch.bfloat16:
        assert torch.equal(lse, got64[1])
        want_nll, want_lse = crossentropy_lse_ref(x, w, labels, softcap,
                                                  compute_dtype=torch.float64)
        torch.testing.assert_close(nll.double(), want_nll, atol=CE_ATOL, rtol=CE_RTOL)
        torch.testing.assert_close(lse.double(), want_lse, atol=CE_ATOL, rtol=CE_RTOL)


def test_crossentropy_bf16_misaligned_x_raises(cuda_device):
    """A bfloat16 x whose rows are not a multiple of 8 elements apart cannot
    feed the tensor-core kernel's 16-byte copies: the call raises."""
    from repro_torch.kernels import crossentropy as ce

    x, w, labels = _ce_inputs(cuda_device, 16, 20, 50, torch.bfloat16, torch.float32, False, 0)
    before = ce.launches()
    with pytest.raises(ValueError):
        ce.crossentropy_forward(x, w, labels)
    assert ce.launches() == before


@pytest.mark.parametrize("x_dtype,softcap", [(torch.float32, 0.0), (torch.float32, 30.0),
                                             (torch.bfloat16, 30.0)])
def test_crossentropy_gradient_matches_autograd_of_plain_version(cuda_device, x_dtype, softcap):
    """dx / dW of the Function against autograd through the plain version on
    the card (TF32 off: float32 products in full precision).  float32 within
    1e-5; bfloat16 x within one bfloat16 step of the largest |dx| (the two
    round dx to bfloat16 from float32 sums taken in another order)."""
    from repro_torch.kernels.crossentropy import fused_crossentropy
    from repro_torch.kernels.ref import crossentropy_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, labels = _ce_inputs(cuda_device, 1000, 48, 1000, x_dtype, torch.float32, True, 4,
                              torch.int64)
    g = torch.from_numpy(np.random.RandomState(1).randn(1000).astype(np.float32)).to(cuda_device)
    grads = []
    for fn in (lambda a, b: fused_crossentropy(a, b, labels, softcap=softcap),
               lambda a, b: crossentropy_ref(a, b, labels, softcap)):
        xr = x.detach().requires_grad_()
        emb = w.T.detach().requires_grad_()
        grads.append(torch.autograd.grad((fn(xr, emb.T) * g).sum(), (xr, emb)))
    tol = 1e-5 if x_dtype == torch.float32 else 3.2e-2
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=1e-4)


def test_crossentropy_cuda_tensor_of_the_wrong_kind_raises(cuda_device):
    from repro_torch.kernels import crossentropy as ce

    x, w, labels = _ce_inputs(cuda_device, 16, 16, 50, torch.float32, torch.float32, False, 0)
    before = ce.launches()
    with pytest.raises(TypeError):
        ce.fused_crossentropy(x.half(), w, labels)
    with pytest.raises(TypeError):
        ce.fused_crossentropy(x, w, labels.float())
    with pytest.raises(ValueError):
        ce.fused_crossentropy(x, w.cpu(), labels)
    assert ce.launches() == before


@pytest.mark.parametrize(
    "dtype,B,Hq,Hkv,S,D,kw,tol",
    [(torch.float32, 2, 4, 2, 200, 64, {}, 1e-4),
     (torch.float32, 1, 4, 2, 130, 32, {"window": 48, "softcap": 20.0}, 1e-4),
     (torch.bfloat16, 2, 8, 2, 256, 128, {}, 6.25e-2),
     (torch.float32, 1, 2, 2, 64, 8, {}, 1e-4)],
)
def test_flash_attention_gradient_matches_autograd_of_plain_version(cuda_device, dtype, B, Hq, Hkv,
                                                                    S, D, kw, tol):
    """dq / dk / dv of ``FlashAttentionFunction`` against autograd through
    the plain version: float32 sums in another order; in bfloat16 both round
    their gradients to bfloat16 (one step at the largest |grad|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(cuda_device, dtype, B, Hq, Hkv, S, S, D, S + D, scale=2.0)
    g = _qkv(cuda_device, dtype, B, Hq, Hq, S, S, D, 7)[0]
    grads = []
    for fn in (lambda a, b, c: fa.FlashAttentionFunction.apply(
                   a, b, c, True, kw.get("window", -1), kw.get("softcap", 0.0), 0, None, 64),
               lambda a, b, c: flash_attention_ref(a, b, c, **kw)):
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad((fn(*ins).float() * g.float()).sum(), ins))
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=1e-3)


def test_train_step_on_the_card_goes_through_both_kernels(cuda_device):
    """tinyllama-smoke in float32 compute on the card: the loss and every
    parameter's gradient on the ``cuda`` engine (both kernels and their
    written-out backwards) against the ``torch`` engine (autograd through
    both plain versions) from the same weights and batch, within 1e-5 /
    rtol 1e-4 (float32 sums in another order); then one train step on the
    ``cuda`` engine launches the cross-entropy kernel once and flash
    attention twice a layer (the remat recomputes each superblock in the
    backward pass) and reports the same loss."""
    from repro_torch.kernels import crossentropy as ce
    from repro_torch.models import loss_fn
    from repro_torch.train import SyntheticLM, TrainConfig, make_train_step
    from repro_torch.train.train_loop import make_optimizer_for

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke_config("tinyllama-1.1b"), compute_dtype="float32")
    batch = SyntheticLM(cfg, batch=4, seq=64, device="cuda").batch_at(0)
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    named = dict(model.named_parameters())
    model.requires_grad_(True)
    out = {}
    for engine in ("cuda", "torch"):
        loss, _ = loss_fn(model, batch, engine=engine)
        out[engine] = (float(loss.detach()), torch.autograd.grad(loss, list(named.values())))
    assert abs(out["cuda"][0] - out["torch"][0]) <= 1e-5
    for name, a, b in zip(named, out["cuda"][1], out["torch"][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)

    opt = make_optimizer_for(cfg, TrainConfig(lr=1e-2, warmup_steps=1))
    state = opt.init(named)
    ce.reset_launches()
    fa.reset_launches()
    _, _, metrics = make_train_step(cfg, opt)(model, state, 0, batch)
    torch.cuda.synchronize()
    assert (ce.launches(), fa.launches()) == (1, 2 * cfg.n_layers)
    assert float(metrics["loss"]) == out["cuda"][0]


# -- the mamba2 slice: the SSD scan ----------------------------------------------------

SSD_TOL = 2e-3


def _ssd_inputs(device, B, S, H, P, G, N, dtype, init, seed, model_layout=False):
    """numpy-seeded inputs on the card; with ``model_layout`` x, B and C are
    slices of one [B, S, H P + 2 G N] tensor, as the model's conv output."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    dt = t(np.abs(rng.randn(B, S, H)) * 0.5)
    A = t(-np.abs(rng.randn(H)))
    if model_layout:
        conv = t(rng.randn(B, S, H * P + 2 * G * N)).to(dtype)
        x = conv[..., :H * P].reshape(B, S, H, P)
        Bm = conv[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = conv[..., H * P + G * N:].reshape(B, S, G, N)
    else:
        x = t(rng.randn(B, S, H, P)).to(dtype)
        Bm, Cm = (t(rng.randn(B, S, G, N)).to(dtype) for _ in range(2))
    h0 = t(rng.randn(B, H, P, N)) if init else None
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize(
    "B,S,H,P,G,N,chunk,dtype,init,model_layout",
    [(3, 64, 1, 16, 1, 8, 16, torch.float32, False, False),  # the reference's sweep
     (3, 128, 1, 32, 1, 16, 32, torch.float32, False, False),
     (3, 32, 1, 8, 1, 8, 32, torch.float32, False, False),
     (2, 96, 6, 16, 3, 16, 32, torch.float32, True, False),  # groups, an initial state
     (2, 37, 4, 16, 1, 16, 16, torch.float32, True, False),  # odd S
     (1, 131, 8, 16, 1, 8, 16, torch.float32, False, True),  # prime S
     (4, 200, 8, 16, 1, 16, 16, torch.bfloat16, True, True),  # the smoke / tune widths
     (2, 300, 16, 64, 1, 64, 128, torch.bfloat16, True, True)],  # zamba2's widths
)
def test_ssd_kernel_matches_plain_version(cuda_device, B, S, H, P, G, N, chunk, dtype, init,
                                          model_layout):
    from repro_torch.kernels import ssd
    from repro_torch.kernels.ref import ssd_chunked_ref

    args = _ssd_inputs(cuda_device, B, S, H, P, G, N, dtype, init, S + P, model_layout)
    ssd.reset_launches()
    y, f = ssd.ssd_forward(*args[:5], chunk, args[5])
    torch.cuda.synchronize()
    assert ssd.launches() == 1
    ry, rf = ssd_chunked_ref(*args[:5], chunk, args[5])
    for got, want in ((y, ry), (f, rf)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = float((got - want).abs().max())
        assert err <= SSD_TOL and err <= 0.1 * float(want.pow(2).mean().sqrt()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_gradient_matches_autograd_of_plain_version(cuda_device, dtype):
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.kernels.ssd import SSDFunction

    torch.backends.cuda.matmul.allow_tf32 = False
    args = _ssd_inputs(cuda_device, 2, 100, 8, 16, 2, 16, dtype, True, 7)
    rng = np.random.RandomState(8)
    gy = torch.from_numpy(rng.randn(2, 100, 8, 16).astype(np.float32)).to(cuda_device)
    gf = torch.from_numpy(rng.randn(2, 8, 16, 16).astype(np.float32)).to(cuda_device)
    grads = []
    for fn in (SSDFunction.apply, ssd_chunked_ref):
        ins = [a.detach().clone().requires_grad_() for a in args]
        y, f = fn(*ins[:5], 32, ins[5])
        grads.append(torch.autograd.grad((y * gy).sum() + (f * gf).sum(), ins))
    for got, want in zip(*grads):
        scale = float(want.float().abs().max())
        tol = 1e-5 if dtype == torch.float32 else 2.0**-7  # one bf16 rounding of dx, dB, dC
        assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize(
    "B,S,H,P,G,N,chunk,init,model_layout",
    [(8, 64, 16, 16, 1, 8, 16, False, True),  # the tune study's N = 8 and 16, P = 16
     (8, 64, 16, 16, 1, 16, 16, False, True),
     (2, 37, 4, 16, 1, 16, 16, True, True),  # odd S: a ragged last chunk
     (1, 131, 8, 16, 1, 8, 32, False, True),  # prime S
     (2, 1001, 8, 16, 1, 16, 128, True, True),  # phase 17's odd S
     (2, 300, 6, 32, 3, 16, 64, True, False),  # groups, contiguous layouts
     (2, 300, 16, 64, 1, 64, 128, True, True),  # zamba2's widths, ragged
     (1, 2048, 4, 64, 1, 64, 128, True, True)],  # zamba2's widths at full length
)
def test_ssd_bf16_tensor_core_kernel_matches_float64(cuda_device, B, S, H, P, G, N, chunk, init,
                                                     model_layout):
    """bf16 x, B, C run the tensor-core kernel: y and the final state within
    SSD_TOL (and a tenth of the rms) of the plain version run in float64 on
    the same bf16 inputs; one launch a call; two calls give equal bits."""
    from repro_torch.kernels import ssd
    from repro_torch.kernels.ref import ssd_chunked_ref

    args = _ssd_inputs(cuda_device, B, S, H, P, G, N, torch.bfloat16, init, S + N, model_layout)
    ssd.reset_launches()
    y, f = ssd.ssd_forward(*args[:5], chunk, args[5])
    y2, f2 = ssd.ssd_forward(*args[:5], chunk, args[5])
    torch.cuda.synchronize()
    assert ssd.launches() == 2
    assert torch.equal(y, y2) and torch.equal(f, f2)
    want = ssd_chunked_ref(*args[:5], chunk, args[5], compute_dtype=torch.float64)
    for got, ref in zip((y, f), want):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        err = float((got.double() - ref).abs().max())
        assert err <= SSD_TOL and err <= 0.1 * float(ref.pow(2).mean().sqrt()), err


def test_ssd_bf16_layouts_the_kernel_does_not_take_raise(cuda_device):
    """The tensor-core kernel copies 16-byte rows: a row stride that is not a
    multiple of 8 elements, storage that is not 16-byte aligned and P wider
    than 64 raise, and nothing is launched."""
    from repro_torch.kernels import ssd
    from repro_torch.kernels.ssd import ssd_forward

    x, dt, A, Bm, Cm, _ = _ssd_inputs(cuda_device, 2, 64, 4, 16, 1, 16, torch.bfloat16, False, 3,
                                      True)
    ssd.reset_launches()
    conv = torch.randn(2, 64, 4 * 16 + 2 * 16 + 4, device=cuda_device).bfloat16()
    odd = (conv[..., :64].reshape(2, 64, 4, 16), conv[..., 64:80].reshape(2, 64, 1, 16),
           conv[..., 80:96].reshape(2, 64, 1, 16))
    with pytest.raises(ValueError, match="16-byte"):
        ssd_forward(odd[0], dt, A, odd[1], odd[2], 16)
    shifted = torch.randn(2 * 64 * 4 * 16 + 4, device=cuda_device).bfloat16()[4:]
    with pytest.raises(ValueError, match="16-byte"):
        ssd_forward(shifted.view(2, 64, 4, 16), dt, A, Bm, Cm, 16)
    wide = torch.randn(2, 64, 4, 80, device=cuda_device).bfloat16()
    with pytest.raises(ValueError, match="at most 64"):
        ssd_forward(wide, dt, A, Bm, Cm, 16)
    assert ssd.launches() == 0


def test_ssd_cuda_tensors_of_the_wrong_kind_raise(cuda_device):
    from repro_torch.kernels.ssd import ssd_forward

    x, dt, A, Bm, Cm, _ = _ssd_inputs(cuda_device, 1, 300, 4, 16, 1, 16, torch.float32, False, 1)
    with pytest.raises(TypeError):  # x and B / C of two dtypes
        ssd_forward(x.bfloat16(), dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError):  # the last dimension strided
        ssd_forward(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError):  # a chunk past the kernel's largest
        ssd_forward(x, dt, A, Bm, Cm, 256)
    with pytest.raises(ValueError):  # two devices
        ssd_forward(x, dt.cpu(), A, Bm, Cm, 16)


def test_zamba2_engine_cuda_and_torch_give_the_same_greedy_tokens(cuda_device):
    """zamba2-smoke in float32 on the card: the same greedy tokens on both
    engines; the SSD kernel launches once per mamba2 block and prefill, the
    flash kernel once per shared-block repeat and prefill."""
    from repro_torch.kernels import ssd

    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 256, size=n) for n in (5, 23, 17, 9, 31)]  # two groups
    outs = {}
    for engine in ("torch", "cuda"):
        cfg, eng = _smoke_engine("zamba2-1.2b", engine, cuda_device)
        fa.reset_launches()
        ssd.reset_launches()
        outs[engine] = eng.generate(prompts, max_new=12)
        torch.cuda.synchronize()
        n_mamba = sum(b.kind == "mamba2" for b in cfg.superblock) * cfg.n_superblocks + len(
            cfg.tail_blocks)
        want = (n_mamba * 2, cfg.n_superblocks * 2) if engine == "cuda" else (0, 0)
        assert (ssd.launches(), fa.launches()) == want
    assert outs["cuda"] == outs["torch"]


def test_zamba2_train_step_on_the_card_goes_through_the_ssd_kernel(cuda_device):
    """zamba2-smoke in float32 compute: the loss and every gradient on the
    ``cuda`` engine against the ``torch`` engine within 1e-5 / rtol 1e-4;
    one train step launches the SSD kernel twice for each stacked mamba2
    block (the remat recomputes each superblock) and once for each tail
    block."""
    from repro_torch.kernels import ssd
    from repro_torch.models import loss_fn
    from repro_torch.train import SyntheticLM, TrainConfig, make_train_step
    from repro_torch.train.train_loop import make_optimizer_for

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke_config("zamba2-1.2b"), compute_dtype="float32")
    batch = SyntheticLM(cfg, batch=4, seq=64, device="cuda").batch_at(0)
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    named = dict(model.named_parameters())
    model.requires_grad_(True)
    out = {}
    for engine in ("cuda", "torch"):
        loss, _ = loss_fn(model, batch, engine=engine)
        out[engine] = (float(loss.detach()), torch.autograd.grad(loss, list(named.values())))
    assert abs(out["cuda"][0] - out["torch"][0]) <= 1e-5
    for name, a, b in zip(named, out["cuda"][1], out["torch"][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)
    opt = make_optimizer_for(cfg, TrainConfig(lr=1e-2, warmup_steps=1))
    state = opt.init(named)
    ssd.reset_launches()
    _, _, metrics = make_train_step(cfg, opt)(model, state, 0, batch)
    torch.cuda.synchronize()
    stacked = sum(b.kind == "mamba2" for b in cfg.superblock) * cfg.n_superblocks
    assert ssd.launches() == 2 * stacked + len(cfg.tail_blocks)
    assert float(metrics["loss"]) == out["cuda"][0]


# -- the xlstm slice: the sLSTM recurrence ------------------------------------------------

SLSTM_TOL = 1e-4


def _slstm_inputs(device, B, S, H, D, dtype, init, seed, model_layout=False):
    """numpy-seeded inputs on the card: u * 0.5 and R * 0.2 (the reference's
    test distributions) at its test widths, D <= 16; wider heads take R at
    the model's init std, 1 / sqrt(D) (R * 0.2 at D = 512 is a sum of 512
    terms that drives the recurrence far from any state the model reaches).
    With ``model_layout`` u is a slice of a wider [B, S, 4 d + 32] tensor;
    with ``init`` a non-empty float32 state."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)  # noqa: E731
    d4 = 4 * H * D
    if model_layout:
        u = t(rng.randn(B, S, d4 + 32) * 0.5).to(dtype)[..., 16:16 + d4]
    else:
        u = t(rng.randn(B, S, d4) * 0.5).to(dtype)
    R = t(rng.randn(4, H, D, D) * (0.2 if D <= 16 else 1.0 / np.sqrt(D)))
    if init:
        state = (t(rng.randn(B, H, D)), t(1.0 + np.abs(rng.randn(B, H, D))),
                 t(rng.randn(B, H, D) * 0.5), t(rng.randn(B, H, D)))
    else:
        z = np.zeros((B, H, D))
        state = (t(z), t(z), t(z), t(z - 1e30))
    return u, R, state


@pytest.mark.parametrize(
    "B,S,H,D,dtype,init,model_layout",
    [(4, 24, 2, 8, torch.float32, False, False),  # the reference's sweep
     (2, 16, 4, 16, torch.float32, False, False),
     (8, 8, 2, 8, torch.float32, False, False),
     (3, 20, 2, 16, torch.float32, True, False),  # an initial state
     (5, 1, 2, 32, torch.bfloat16, True, True),  # decode: S = 1
     (2, 37, 2, 32, torch.bfloat16, True, True),  # odd S, the smoke widths
     (11, 9, 2, 32, torch.float32, False, True),  # two batch tiles, one ragged
     (2, 40, 4, 512, torch.bfloat16, True, True)],  # xlstm-1.3b's widths
)
def test_slstm_kernel_matches_plain_version(cuda_device, B, S, H, D, dtype, init, model_layout):
    from repro_torch.kernels import slstm
    from repro_torch.kernels.ref import slstm_scan_ref

    u, R, state = _slstm_inputs(cuda_device, B, S, H, D, dtype, init, B * 31 + S, model_layout)
    slstm.reset_launches()
    hs, fin = slstm.slstm_forward(u, R, *state)
    torch.cuda.synchronize()
    assert slstm.launches() == 1
    want_hs, want_fin = slstm_scan_ref(u, R, *state, compute_dtype=torch.float64)
    for got, want in ((hs, want_hs), *zip(fin, want_fin)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got.double(), want, atol=SLSTM_TOL, rtol=SLSTM_TOL)


def test_slstm_plans_of_two_batch_sizes_take_turns(cuda_device):
    """A plan for a small batch (less shared memory) must not cap a larger
    batch's launch that follows it, in either kernel."""
    from repro_torch.kernels import slstm
    from repro_torch.kernels.ref import slstm_scan_ref

    for B, S in ((8, 3), (2, 3), (8, 3), (8, 1), (2, 1), (8, 1)):
        u, R, state = _slstm_inputs(cuda_device, B, S, 4, 512, torch.bfloat16, True, B + S, True)
        hs, _ = slstm.slstm_forward(u, R, *state)
        want, _ = slstm_scan_ref(u, R, *state, compute_dtype=torch.float64)
        torch.testing.assert_close(hs.double(), want, atol=SLSTM_TOL, rtol=SLSTM_TOL)


def test_slstm_two_calls_give_equal_bits_and_decode_equals_the_first_step(cuda_device):
    from repro_torch.kernels import slstm

    u, R, state = _slstm_inputs(cuda_device, 8, 64, 4, 512, torch.bfloat16, True, 3, True)
    runs = [slstm.slstm_forward(u, R, *state, save_states=True) for _ in range(2)]
    flat = [(hs, *fin, *seqs) for hs, fin, seqs in runs]
    assert all(torch.equal(a, b) for a, b in zip(*flat))
    slstm.reset_launches()
    hs1, fin1 = slstm.slstm_forward(u[:, :1], R, *state)  # S = 1: the decode kernel
    assert slstm.launches() == 1
    hs, _, (c_seq, n_seq, m_seq) = runs[0]
    assert torch.equal(hs1, hs[:, :1])
    d = (8, 4, 512)
    for got, want in zip(fin1, (c_seq[:, 0], n_seq[:, 0], hs[:, 0], m_seq[:, 0])):
        assert torch.equal(got, want.reshape(d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_gradient_matches_autograd_of_plain_version(cuda_device, dtype):
    from repro_torch.kernels.ref import slstm_scan_ref
    from repro_torch.kernels.slstm import SLSTMFunction

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, D = 3, 30, 2, 64
    u, R, state = _slstm_inputs(cuda_device, B, S, H, D, dtype, True, 5)
    rng = np.random.RandomState(6)
    gh = torch.from_numpy(rng.randn(B, S, H * D).astype(np.float32)).to(cuda_device)
    gf = [torch.from_numpy(rng.randn(B, H, D).astype(np.float32)).to(cuda_device)
          for _ in range(4)]
    grads = []
    for fn in (SLSTMFunction.apply, lambda *a: (lambda h, f: (h, *f))(*slstm_scan_ref(*a))):
        ins = [a.detach().clone().requires_grad_() for a in (u, R, *state)]
        hs, *fin = fn(*ins)
        loss = (hs * gh).sum() + sum((f * g).sum() for f, g in zip(fin, gf))
        grads.append(torch.autograd.grad(loss, ins))
    for got, want in zip(*grads):
        scale = float(want.float().abs().max())
        tol = 1e-4 if dtype == torch.float32 else 2.0**-7  # one bf16 rounding of du
        assert float((got.float() - want.float()).abs().max()) <= tol * scale


def test_slstm_cuda_tensors_of_the_wrong_kind_raise(cuda_device):
    from repro_torch.kernels import slstm

    u, R, state = _slstm_inputs(cuda_device, 2, 4, 2, 16, torch.float32, False, 1)
    slstm.reset_launches()
    with pytest.raises(TypeError):  # float16 pre-activations
        slstm.slstm_forward(u.half(), R, *state)
    with pytest.raises(TypeError):  # R not float32
        slstm.slstm_forward(u, R.bfloat16(), *state)
    with pytest.raises(ValueError):  # the last dimension strided
        slstm.slstm_forward(u.transpose(1, 2).contiguous().transpose(1, 2), R, *state)
    with pytest.raises(ValueError):  # two devices
        slstm.slstm_forward(u, R.cpu(), *state)
    with pytest.raises(ValueError):  # a state of the wrong shape
        slstm.slstm_forward(u, R, state[0][:1], *state[1:])
    big, R_big, st_big = _slstm_inputs(cuda_device, 1, 2, 1, 4096, torch.float32, False, 2)
    with pytest.raises(ValueError, match="resident"):  # R's slices fit no plan
        slstm.slstm_forward(big, R_big, *st_big)
    assert slstm.launches() == 0


def test_slstm_kernel_on_a_shard_of_the_heads(cuda_device):
    """The sharded sLSTM block's call where the heads divide the model axis:
    2 of xlstm-1.3b's 4 heads of 512 (each gate's columns of those heads),
    ``r_zifo[:, 2:4]`` and the state a strided slice of ``[B, 4, 512]``
    leaves; held to the plain version in float64 at the kernel's tolerance."""
    from repro_torch.kernels import slstm
    from repro_torch.kernels.ref import slstm_scan_ref

    B, S, H, D = 2, 40, 4, 512
    u, R, state = _slstm_inputs(cuda_device, B, S, H, D, torch.float32, True, 12)
    u_l = u.reshape(B, S, 4, H, D)[:, :, :, 2:4].reshape(B, S, 4 * 2 * D)
    R_l = R[:, 2:4]
    st_l = tuple(t[:, 2:4] for t in state)
    assert not st_l[0].is_contiguous()
    slstm.reset_launches()
    hs, fin = slstm.slstm_forward(u_l, R_l, *st_l)
    torch.cuda.synchronize()
    assert slstm.launches() == 1
    want_hs, want_fin = slstm_scan_ref(u_l, R_l, *st_l, compute_dtype=torch.float64)
    for got, want in ((hs, want_hs), *zip(fin, want_fin)):
        torch.testing.assert_close(got.double(), want, atol=SLSTM_TOL, rtol=SLSTM_TOL)


def test_sharded_xlstm_in_a_world_of_one_goes_through_the_slstm_kernel(cuda_device, tmp_path):
    """xlstm-smoke in float32 through ``build_step``'s serving cells on a (1,
    1) mesh over one NCCL rank: a prefill and 2 decode steps, every logit
    within 1e-5 of the unsharded ``Engine`` on the kernels, one sLSTM launch
    a block and step."""
    import copy

    import torch.distributed as dist

    from repro_torch.kernels import slstm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke_config("xlstm-1.3b"), compute_dtype="float32",
                              serve_param_dtype="float32")
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    rng = np.random.RandomState(5)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 14))).cuda()
    fed = [torch.from_numpy(rng.randint(0, cfg.vocab, (2, 1))).cuda() for _ in range(2)]
    cache = lambda: init_cache(cfg, 2, 32, torch.float32, device="cuda")  # noqa: E731
    engine = Engine(cfg, copy.deepcopy(model), capacity=32, slots=2, engine="cuda")
    logits, c = engine._prefill(engine.model, {"tokens": prompt}, cache())
    want = [logits]
    for i, tok in enumerate(fed):
        logits, c = engine._decode(engine.model, tok, c, 14 + i)
        want.append(logits)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type="cuda")
        prefill, decode = build_step(cfg, "prefill_32k", mesh), build_step(cfg, "decode_32k", mesh)
        smodel, sbatch, scache = prefill.shard(model, {"tokens": prompt}, cache())
        launches, got = [], []
        for i in range(3):
            slstm.reset_launches()
            if i == 0:
                logits, scache = prefill.step(smodel, sbatch, scache)
            else:
                logits, scache = decode.step(smodel, decode.shard(None, fed[i - 1])[1], scache,
                                             13 + i)
            torch.cuda.synchronize()
            launches.append(slstm.launches())
            got.append(logits.full_tensor())
    finally:
        dist.destroy_process_group()
    assert launches == [_n_slstm(cfg)] * 3
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5


def _n_slstm(cfg):
    return sum(b.kind == "slstm" for b in cfg.superblock) * cfg.n_superblocks


def test_xlstm_engine_cuda_and_torch_give_the_same_greedy_tokens(cuda_device):
    """xlstm-smoke in float32 on the card: the same greedy tokens on both
    engines; the sLSTM kernel launches once per sLSTM block and prefill on
    the ``cuda`` engine, and once per sLSTM block and decode step on both
    (a decode step runs the block's full form on one token)."""
    from repro_torch.kernels import slstm

    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 256, size=n) for n in (5, 23, 17, 9, 31)]  # two groups
    outs = {}
    for engine in ("torch", "cuda"):
        cfg, eng = _smoke_engine("xlstm-1.3b", engine, cuda_device)
        slstm.reset_launches()
        outs[engine] = eng.generate(prompts, max_new=12)
        torch.cuda.synchronize()
        per_call = _n_slstm(cfg)
        want = per_call * (2 * 11 + (2 if engine == "cuda" else 0))
        assert slstm.launches() == want
    assert outs["cuda"] == outs["torch"]


def test_xlstm_train_step_on_the_card_goes_through_the_slstm_kernel(cuda_device):
    """xlstm-smoke in float32 compute: the loss and every gradient on the
    ``cuda`` engine against the ``torch`` engine within 1e-5 / rtol 1e-4;
    one train step launches the sLSTM kernel twice for each stacked sLSTM
    block (the remat recomputes each superblock)."""
    from repro_torch.kernels import slstm
    from repro_torch.models import loss_fn
    from repro_torch.train import SyntheticLM, TrainConfig, make_train_step
    from repro_torch.train.train_loop import make_optimizer_for

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke_config("xlstm-1.3b"), compute_dtype="float32")
    batch = SyntheticLM(cfg, batch=4, seq=64, device="cuda").batch_at(0)
    model = init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    named = dict(model.named_parameters())
    model.requires_grad_(True)
    out = {}
    for engine in ("cuda", "torch"):
        loss, _ = loss_fn(model, batch, engine=engine)
        out[engine] = (float(loss.detach()), torch.autograd.grad(loss, list(named.values())))
    assert abs(out["cuda"][0] - out["torch"][0]) <= 1e-5
    for name, a, b in zip(named, out["cuda"][1], out["torch"][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)
    opt = make_optimizer_for(cfg, TrainConfig(lr=1e-2, warmup_steps=1))
    state = opt.init(named)
    slstm.reset_launches()
    _, _, metrics = make_train_step(cfg, opt)(model, state, 0, batch)
    torch.cuda.synchronize()
    assert slstm.launches() == 2 * _n_slstm(cfg)
    assert float(metrics["loss"]) == out["cuda"][0]


# -- the storage stack and distributed workers ---------------------------------------


def _card_objective(trial):
    xs = [trial.suggest_float(f"x{i}", -5.0, 5.0) for i in range(3)]
    k = trial.suggest_int("k", 1, 8)
    act = trial.suggest_categorical("act", ["relu", "tanh"])
    loss = sum((x - 1.0) ** 2 for x in xs) + 0.1 * k + 0.3 * (act != "relu")
    for step in range(3):
        trial.report(loss * (1.0 + 1.0 / (step + 1)), step)
        if trial.should_prune():
            raise hpo.TrialPruned()
    return loss


def _worker_objective(trial):
    """``_card_objective`` in a spawned worker, recording its pid and its
    cumulative Parzen launches."""
    import os

    try:
        return _card_objective(trial)
    finally:
        trial.set_user_attr("pid", os.getpid())
        trial.set_user_attr("parzen_launches", parzen.launches())


def _cuda_tpe():
    return hpo.TPESampler(engine="cuda", n_startup_trials=5)


def _pruner():
    return hpo.MedianPruner(n_startup_trials=5)


def test_cuda_study_over_a_served_sqlite_file_equals_in_memory(cuda_device, tmp_path):
    from repro_torch.core.storage import CachedStorage, RemoteStorage, StorageServer

    def run(storage):
        study = hpo.create_study(study_name="served", storage=storage,
                                 sampler=hpo.TPESampler(seed=0, engine="cuda", n_startup_trials=5),
                                 pruner=_pruner())
        parzen.reset_launches()
        study.optimize(_card_objective, n_trials=64)
        trials = [(t.number, t.state, sorted(t.params.items()), t.values,
                   sorted(t.intermediate_values.items())) for t in study.get_trials()]
        return trials, parzen.launches()

    memory, memory_launches = run(None)
    with StorageServer(hpo.get_storage(f"sqlite:///{tmp_path}/served.db")) as srv:
        remote = RemoteStorage(srv.url)
        assert remote.protocol == 2
        served, served_launches = run(CachedStorage(remote))
        remote.close()
    assert served == memory
    assert served_launches == memory_launches > 0
    assert {t[1] for t in memory} <= {hpo.TrialState.COMPLETE, hpo.TrialState.PRUNED}


def test_spawned_workers_launch_the_parzen_kernel_on_the_card(cuda_device, tmp_path):
    import os

    url = f"sqlite:///{tmp_path}/workers.db"
    hpo.create_study(study_name="workers", storage=url, engine="numpy")
    hpo.run_workers(2, url, "workers", _worker_objective, 32, sampler_factory=_cuda_tpe,
                    pruner_factory=_pruner, serve_storage=True, start_method="spawn")
    trials = hpo.load_study("workers", url, engine="numpy").trials
    assert sorted(t.number for t in trials) == list(range(64))
    assert {t.state for t in trials} <= {hpo.TrialState.COMPLETE, hpo.TrialState.PRUNED}
    launches = {}
    for t in trials:
        pid = t.user_attrs["pid"]
        launches[pid] = max(launches.get(pid, 0), t.user_attrs["parzen_launches"])
    assert len(launches) == 2 and os.getpid() not in launches
    assert all(n > 0 for n in launches.values()), launches


def test_two_scheduler_slices_on_the_card_launch_the_kernels(cuda_device):
    """Two ``TrialSliceScheduler`` slices that name the one card run 4 tiny
    tune trials at once: none fails, the TPE scores on the card (Parzen
    launched) and each train step launches the cross-entropy kernel once."""
    from repro_torch.kernels import crossentropy as ce
    from repro_torch.tune import LMTuneSpec, TrialSliceScheduler, make_lm_objective

    spec = LMTuneSpec(vocab=64, seq=32, batch=4, total_steps=6, eval_every=2, max_layers=1,
                      max_width=64, families=("dense",))
    study = hpo.create_study(
        sampler=hpo.TPESampler(seed=0, engine="cuda", n_startup_trials=2,
                               consider_pruned_trials=True),
        pruner=hpo.SuccessiveHalvingPruner(min_resource=2, reduction_factor=2),
    )

    def run_trial(trial, devices):
        return make_lm_objective(spec, device=devices[0])(trial)

    parzen.reset_launches()
    ce.reset_launches()
    fa.reset_launches()
    sched = TrialSliceScheduler(study, [[cuda_device]] * 2, run_trial)
    sched.run(n_trials=4)
    torch.cuda.synchronize()
    trials = study.trials
    assert len(trials) == 4
    assert {t.state for t in trials} <= {hpo.TrialState.COMPLETE, hpo.TrialState.PRUNED}
    assert {e[1] for e in sched.events} == {0, 1}
    steps = sum(len(t.intermediate_values) * spec.eval_every for t in trials)
    assert parzen.launches() > 0 and fa.launches() > 0
    assert ce.launches() == steps
