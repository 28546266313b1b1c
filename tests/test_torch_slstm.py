"""The port's xLSTM pieces (``kernels/slstm.py``, ``kernels/ref.py``,
``models/ssm_xlstm.py``) against the reference on the CPU.

The same numpy-seeded inputs go through both packages:

* ``slstm_scan_ref`` (and ``slstm_forward``, which takes it for CPU
  tensors) against the reference's ``models.ssm_xlstm._slstm_scan`` and its
  Pallas ``slstm_scan`` in interpret mode, at the reference's kernel sweep
  (``tests/test_kernels.py``) and its tolerance, atol 1e-4; then with an
  initial state, at S = 1 and on a strided ``[B, S, 4 d]`` input (a slice
  of a wider tensor), against ``_slstm_scan``; in float64 against float32;
* ``SLSTMFunction``'s written-out backward (``slstm_backward``) against
  ``jax.grad`` of ``_slstm_scan``: float32, atol 1e-5 / rtol 1e-4 (the same
  sums in another order), with an initial state, gradients on the final
  state, and a constructed tie ``n' = max(1, exp(0))`` at step 0, where
  ``jnp.maximum`` splits the gradient evenly;
* ``mlstm_parallel`` (chunks of ``min(q_chunk, S)`` queries, the last one
  ragged) against the reference's ``mlstm_parallel``, whose chunk halves to
  1 at an odd S, and its recurrent ``mlstm_ref``: atol 1e-5 / rtol 1e-4;
* ``mlstm_fold`` (the prompt folded into the state in closed form) against
  the reference's step-by-step replay, from an empty and from a non-empty
  state: atol 1e-5 / rtol 1e-4 in float32 (the same sums in another order).

* the CUDA kernel's summation order, emulated in float32 at xlstm-1.3b's
  head width (D = 512): each column's k sum in Q = 8 parts of 64
  consecutive k, each a chain of FMAs from zero, the parts added in order;
  every step within 1e-5 + 1e-5 |x| of one float64 step from the same
  entering state (what phase 21 of ``chip_smoke.py`` holds the kernel to).

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.slstm import slstm_scan
from repro.models import ssm_xlstm as jxl
from repro_torch.kernels.ref import slstm_scan_ref
from repro_torch.kernels.slstm import SLSTMFunction, slstm_backward, slstm_forward
from repro_torch.models import ssm_xlstm as xl

SWEEP = [(4, 24, 2, 8), (2, 16, 4, 16), (8, 8, 2, 8)]  # (B, S, H, D)
STATE_KEYS = ("c", "n", "h", "m")


class _Cfg:
    def __init__(self, H, D):
        self.n_heads = H
        self.d_model = H * D
        self.norm_eps = 1e-6


def _inputs(B, S, H, D, seed, init=False):
    """The reference's test distributions (u * 0.5, R * 0.2); with ``init``
    a non-empty state (m of order 1, n > 0)."""
    rng = np.random.RandomState(seed)
    u = (rng.randn(B, S, 4 * H * D) * 0.5).astype(np.float32)
    R = (rng.randn(4, H, D, D) * 0.2).astype(np.float32)
    if init:
        state = {"c": rng.randn(B, H, D), "n": 1.0 + np.abs(rng.randn(B, H, D)),
                 "h": rng.randn(B, H, D) * 0.5, "m": rng.randn(B, H, D)}
        state = {k: v.astype(np.float32) for k, v in state.items()}
    else:
        state = {k: np.array(v) for k, v in jxl.empty_slstm_state(_Cfg(H, D), B).items()}
    return u, R, state


def _reference(u, R, state):
    H, D = R.shape[1], R.shape[2]
    hs, fin = jxl._slstm_scan({"r_zifo": jnp.asarray(R)}, jnp.asarray(u), _Cfg(H, D),
                              {k: jnp.asarray(v) for k, v in state.items()})
    return np.asarray(hs), {k: np.asarray(v) for k, v in fin.items()}


def _port(u, R, state, **kw):
    t = torch.from_numpy
    return slstm_scan_ref(t(u), t(R), *(t(state[k]) for k in STATE_KEYS), **kw)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, **tol)


@pytest.mark.parametrize("B,S,H,D", SWEEP)
def test_plain_version_matches_the_reference_scan_and_its_pallas_kernel(B, S, H, D):
    u, R, state = _inputs(B, S, H, D, seed=B * 31 + S)
    hs_ref, fin_ref = _reference(u, R, state)
    uk = jnp.asarray(u).reshape(B, S, 4, H, D).transpose(1, 0, 2, 3, 4)
    h_k, fin_k = slstm_scan(uk, jnp.asarray(R), batch_tile=2, interpret=True)
    hs_k = np.asarray(h_k).transpose(1, 0, 2, 3).reshape(B, S, H * D)
    hs, fin = _port(u, R, state)
    assert hs.dtype == torch.float32 and hs.shape == (B, S, H * D)
    for want in (hs_ref, hs_k):
        _close(hs.numpy(), want, atol=1e-4)
    for key, got, kernel in zip(STATE_KEYS, fin, fin_k):
        _close(got.numpy(), fin_ref[key], atol=1e-4)
        _close(got.numpy(), np.asarray(kernel), atol=1e-4)
    # the wrapper's CPU path is the plain version
    t = torch.from_numpy
    got = slstm_forward(t(u), t(R), *(t(state[k]) for k in STATE_KEYS))
    assert torch.equal(got[0], hs) and all(torch.equal(a, b) for a, b in zip(got[1], fin))


@pytest.mark.parametrize("case", ["initial state", "S = 1", "strided input", "float64"])
def test_plain_version_takes_what_the_model_hands_it(case):
    B, S, H, D = (3, 1, 2, 16) if case == "S = 1" else (3, 20, 2, 16)
    u, R, state = _inputs(B, S, H, D, seed=7, init=case != "float64")
    hs_ref, fin_ref = _reference(u, R, state)
    if case == "strided input":
        wide = np.random.RandomState(8).randn(B, S, 4 * H * D + 24).astype(np.float32)
        wide[..., 5:5 + 4 * H * D] = u
        ut = torch.from_numpy(wide)[..., 5:5 + 4 * H * D]
        assert not ut.is_contiguous()
        t = torch.from_numpy
        hs, fin = slstm_forward(ut, t(R), *(t(state[k]) for k in STATE_KEYS))
    else:
        dtype = torch.float64 if case == "float64" else torch.float32
        hs, fin = _port(u, R, state, compute_dtype=dtype)
        assert hs.dtype == dtype
    _close(hs.numpy(), hs_ref, atol=1e-4)
    for key, got in zip(STATE_KEYS, fin):
        _close(got.numpy(), fin_ref[key], atol=1e-4)


@pytest.mark.parametrize("case, error, match", [
    ("float16 u", TypeError, "u must be float32 or bfloat16"),
    ("bfloat16 R", TypeError, "R must be float32"),
    ("float64 state", TypeError, "c0 must be float32"),
    ("state of the wrong shape", ValueError, r"h0 must be \(3, 2, 16\)"),
    ("u of the wrong width", ValueError, "is not 4 x 2 heads x 16 dims"),
    ("empty sequence", ValueError, "empty input"),
    ("R not square", ValueError, r"R \[4, H, D, D\]"),
    ("not a tensor", TypeError, "n0 must be a torch.Tensor"),
])
def test_wrapper_names_what_it_does_not_take(case, error, match):
    """The wrapper's one list of checks, on CPU tensors (the card's run the
    same list), raises on the first that fails and names it, also after a
    call of the same shapes passed."""
    u, R, state = _inputs(3, 4, 2, 16, seed=9, init=True)
    t = torch.from_numpy
    u, R, st = t(u), t(R), [t(state[k]) for k in STATE_KEYS]
    slstm_forward(u, R, *st)  # passes, and is kept
    if case == "float16 u":
        u = u.half()
    elif case == "bfloat16 R":
        R = R.bfloat16()
    elif case == "float64 state":
        st[0] = st[0].double()
    elif case == "state of the wrong shape":
        st[2] = st[2][:, :1]
    elif case == "u of the wrong width":
        u = u[..., :-4]
    elif case == "empty sequence":
        u = u[:, :0]
    elif case == "R not square":
        R = R[..., :8]
    elif case == "not a tensor":
        st[1] = st[1].numpy()
    with pytest.raises(error, match=match):
        slstm_forward(u, R, *st)


def _grad_inputs(B, S, H, D, seed, tie):
    u, R, state = _inputs(B, S, H, D, seed, init=not tie)
    if tie:  # step 0 from the empty state: i = 0 gives n' = max(0 + exp(0), exp(-0))
        u[:, 0, H * D:2 * H * D] = 0.0
    rng = np.random.RandomState(seed + 1)
    gh = rng.randn(B, S, H * D).astype(np.float32)
    gfin = {k: rng.randn(B, H, D).astype(np.float32) for k in STATE_KEYS}
    return u, R, state, gh, gfin


def _jax_grads(u, R, state, gh, gfin):
    H, D = R.shape[1], R.shape[2]

    def loss(u, R, state):
        hs, fin = jxl._slstm_scan({"r_zifo": R}, u, _Cfg(H, D), state)
        return jnp.sum(hs * gh) + sum(jnp.sum(fin[k] * gfin[k]) for k in STATE_KEYS)

    du, dR, dstate = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(R), {k: jnp.asarray(v) for k, v in state.items()})
    return [np.asarray(du), np.asarray(dR)] + [np.asarray(dstate[k]) for k in STATE_KEYS]


@pytest.mark.parametrize("B,S,H,D,tie", [(4, 24, 2, 8, False), (2, 16, 4, 16, False),
                                         (3, 12, 2, 8, True)],
                         ids=["sweep-init", "sweep-4-heads", "tie"])
def test_written_out_backward_matches_jax_grad(B, S, H, D, tie):
    u, R, state, gh, gfin = _grad_inputs(B, S, H, D, seed=S + D, tie=tie)
    want = _jax_grads(u, R, state, gh, gfin)
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (u, R, *(state[k] for k in STATE_KEYS))]
    hs, *fin = SLSTMFunction.apply(*leaves)
    loss = (hs * torch.from_numpy(gh)).sum() + sum(
        (f * torch.from_numpy(gfin[k])).sum() for f, k in zip(fin, STATE_KEYS))
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(["du", "dR", "dc0", "dn0", "dh0", "dm0"], got, want):
        _close(g.numpy(), w, atol=1e-5, rtol=1e-4, err_msg=name)
    if tie:  # the tie is exact: n' = 1 = exp(-0) at step 0 for every (b, h, e)
        t = torch.from_numpy
        _, _, seqs = slstm_scan_ref(t(u), t(R), *(t(state[k]) for k in STATE_KEYS), states=True)
        assert (seqs[1][:, 0] == 1.0).all()


def test_backward_without_final_state_gradients():
    """The model's training path: no gradient reaches the final state."""
    u, R, state, gh, _ = _grad_inputs(2, 10, 2, 8, seed=3, tie=False)
    zero = {k: np.zeros_like(v) for k, v in state.items()}
    want = _jax_grads(u, R, state, gh, zero)
    t = torch.from_numpy
    init = [t(state[k]) for k in STATE_KEYS]
    hs, fin, seqs = slstm_scan_ref(t(u), t(R), *init, states=True)
    got = slstm_backward(t(u), t(R), *init, hs, *seqs, t(gh), None)
    for g, w in zip(got, want):
        _close(g.numpy(), w, atol=1e-5, rtol=1e-4)


# -- mLSTM -------------------------------------------------------------------------------


def _mlstm_inputs(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    k /= np.sqrt(D)
    logi = rng.randn(B, S, H).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(rng.randn(B, S, H) + 1.0))).astype(np.float32)
    return q, k, v, logi, logf


@pytest.mark.parametrize("S,q_chunk", [(37, 16), (31, 8), (24, 16), (16, 16)])
def test_mlstm_parallel_ragged_chunks_match_the_reference(S, q_chunk):
    args = _mlstm_inputs(2, S, 2, 16, seed=S)
    want = np.asarray(jxl.mlstm_parallel(*map(jnp.asarray, args), q_chunk=q_chunk))
    recurrent = np.asarray(jref.mlstm_ref(*map(jnp.asarray, args)))
    got = xl.mlstm_parallel(*map(torch.from_numpy, args), q_chunk=q_chunk)
    assert got.shape == (2, S, 2, 16)
    _close(got.numpy(), want, atol=1e-5, rtol=1e-4)
    _close(got.numpy(), recurrent, atol=1e-4, rtol=1e-4)


def _replay(state, q, k, v, logi, logf):
    """The reference's prefill fold: S recurrent steps (``ssm_xlstm.py:178-189``)."""
    def step(st, a):
        st, _ = jxl.mlstm_recurrent_step(st, *[x[:, None] for x in a])
        return st, None

    final, _ = jax.lax.scan(step, {k_: jnp.asarray(v_) for k_, v_ in state.items()},
                            tuple(jnp.asarray(a).swapaxes(0, 1) for a in (q, k, v, logi, logf)))
    return {k_: np.asarray(v_) for k_, v_ in final.items()}


@pytest.mark.parametrize("init", [False, True], ids=["empty", "non-empty"])
def test_mlstm_fold_matches_the_reference_replay(init):
    B, S, H, D = 2, 37, 2, 16
    q, k, v, logi, logf = _mlstm_inputs(B, S, H, D, seed=11)
    cfg = _Cfg(H, D)
    cfg.ssm_proj_factor = 1
    state = {key: np.array(t) for key, t in jxl.empty_mlstm_state(cfg, B).items()}
    if init:
        rng = np.random.RandomState(12)
        state = {"C": rng.randn(B, H, D, D).astype(np.float32),
                 "n": rng.randn(B, H, D).astype(np.float32),
                 "m": rng.randn(B, H).astype(np.float32)}
    want = _replay(state, q, k, v, logi, logf)
    t = torch.from_numpy
    got = xl.mlstm_fold({key: t(a) for key, a in state.items()}, t(k), t(v), t(logi), t(logf))
    for key in ("C", "n", "m"):
        assert got[key].dtype == torch.float32
        _close(got[key].numpy(), want[key], atol=1e-5, rtol=1e-4, err_msg=key)


def _kernel_order_step(u_t, R, c, n, h, m, parts):
    """One step of the recurrence with ``h @ R`` summed as the CUDA kernel
    sums it: per column, ``parts`` ranges of consecutive k, each a chain of
    FMAs from zero (a float64 product, exact for float32 operands, plus the
    running sum, rounded to float32), then the parts added in order from
    zero; the gates in float32 ops."""
    B, H, D = h.shape
    kp = D // parts
    hq = h.reshape(B, H, parts, kp).double()
    Rq = R.reshape(4, H, parts, kp, D).double()
    acc = torch.zeros((4, B, H, parts, D), dtype=torch.float32)
    for i in range(kp):
        prod = hq[None, :, :, :, i, None] * Rq[:, None, :, :, i, :]
        acc = (prod + acc.double()).float()
    rec = torch.zeros((4, B, H, D), dtype=torch.float32)
    for q in range(parts):
        rec = rec + acc[:, :, :, q]
    a = u_t.reshape(B, 4, H, D).transpose(0, 1) + rec
    z, i_, f, o = torch.tanh(a[0]), a[1], a[2], torch.sigmoid(a[3])
    m_new = torch.maximum(f + m, i_)
    ig, fg = torch.exp(i_ - m_new), torch.exp(f + m - m_new)
    c_new = fg * c + ig * z
    n_new = torch.maximum(fg * n + ig, torch.exp(-m_new))
    return c_new, n_new, o * c_new / n_new, m_new


def test_kernel_summation_order_stays_within_float32_of_each_float64_step():
    B, S, H, D, parts, tol = 2, 6, 2, 512, 8, 1e-5
    rng = np.random.RandomState(21)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    u = t(rng.randn(B, S, 4 * H * D))
    R = t(rng.randn(4, H, D, D) / np.sqrt(D))  # the model's init scale
    state = (t(rng.randn(B, H, D)), t(1.0 + np.abs(rng.randn(B, H, D))),
             t(rng.randn(B, H, D) * 0.1), t(rng.randn(B, H, D)))
    worst = 0.0
    for step in range(S):
        got = _kernel_order_step(u[:, step], R, *state, parts)
        _, (c, n, h, m) = slstm_scan_ref(u[:, step:step + 1], R, *state,
                                         compute_dtype=torch.float64)
        for g, w in zip(got, (c, n, h, m)):
            err = (g.double() - w).abs()
            assert float((err - tol * w.abs()).max()) <= tol, step
            worst = max(worst, float(err.max()))
        state = got
    assert worst > 0.0  # float32 rounding shows: the emulation is not float64
