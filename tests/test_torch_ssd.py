"""The port's SSD scan (``kernels/ssd.py``, ``kernels/ref.py``) against the
reference on the CPU.

The same numpy-seeded inputs go through both packages:

* ``ssd_chunked_ref`` against the reference's ``models.mamba2.ssd_chunked``
  (the halving chunk rule, groups, an initial state, odd and prime lengths):
  float32, atol 1e-5 / rtol 1e-4 (the same sums in another order; outputs
  up to about 30);
* the same in float64 (``compute_dtype``), at the same bounds;
* ``ssd_chunked_ref`` and the port's ``ssd_ref`` against the reference's
  Pallas kernel in interpret mode and its sequential ``ssd_ref``, at the
  reference's own kernel sweep (``tests/test_kernels.py``) and its
  tolerance, 2e-3;
* ``SSDFunction``'s written-out backward against ``jax.grad`` of the
  reference's ``ssd_chunked``: float32, atol 1e-5 / rtol 1e-4.  The backward
  cuts the steps into chunks of ``min(chunk, S)`` with a ragged last chunk
  (the kernel's rule), the reference halves the chunk until it divides S: the
  same function, summed in another order.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import ssd_op
from repro.models.mamba2 import ssd_chunked as ref_ssd_chunked
from repro_torch.kernels.ref import ssd_chunk_len, ssd_chunked_ref, ssd_ref
from repro_torch.kernels.ssd import SSDFunction, kernel_chunk_len, ssd_backward, ssd_forward
from repro_torch.models.mamba2 import ssd_chunked

# (B, S, H, P, G, N, chunk, initial state)
SHAPES = [
    (2, 64, 4, 16, 1, 8, 16, False),  # the reference's ssd_chunked test
    (2, 37, 4, 8, 2, 8, 16, True),  # odd S: the reference's chunk halves to 1
    (1, 48, 6, 16, 3, 16, 32, True),  # G = 3 groups of 2 heads
    (2, 31, 4, 16, 1, 16, 16, False),  # prime S
    (1, 40, 8, 16, 1, 16, 16, True),  # the tune study's widths, S = 2.5 chunks
]
IDS = [f"B{b}-S{s}-H{h}-P{p}-G{g}-N{n}-L{c}{'-init' if i else ''}"
       for b, s, h, p, g, n, c, i in SHAPES]


def make_inputs(B, S, H, P, G, N, init, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = (np.abs(rng.randn(B, S, H)) * 0.5).astype(np.float32)
    A = -np.abs(rng.randn(H)).astype(np.float32)
    Bm = rng.randn(B, S, G, N).astype(np.float32)
    Cm = rng.randn(B, S, G, N).astype(np.float32)
    h0 = rng.randn(B, H, P, N).astype(np.float32) if init else None
    return x, dt, A, Bm, Cm, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_chunked_ref_matches_the_reference_ssd_chunked(shape):
    B, S, H, P, G, N, chunk, init = shape
    x, dt, A, Bm, Cm, h0 = make_inputs(B, S, H, P, G, N, init, seed=S)
    want_y, want_f = ref_ssd_chunked(*map(_j, (x, dt, A, Bm, Cm)), chunk=chunk,
                                     initial_state=_j(h0))
    y, f = ssd_chunked_ref(*map(_t, (x, dt, A, Bm, Cm)), chunk, _t(h0))
    assert y.dtype == f.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(want_f), atol=1e-5, rtol=1e-4)
    # the launcher's CPU path is the plain version, and so is the model's
    got = ssd_forward(*map(_t, (x, dt, A, Bm, Cm)), chunk, _t(h0))
    assert torch.equal(got[0], y) and torch.equal(got[1], f)
    for engine in ("auto", "torch"):
        got = ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk, _t(h0), engine=engine)
        assert torch.equal(got[0], y) and torch.equal(got[1], f)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_chunked_ref_in_float64_matches_the_reference_ssd_chunked(shape):
    """``compute_dtype=torch.float64`` (the yardstick of float32 rounding
    that ``chip_smoke.py`` holds the kernel to) computes the same function
    and returns float64."""
    B, S, H, P, G, N, chunk, init = shape
    x, dt, A, Bm, Cm, h0 = make_inputs(B, S, H, P, G, N, init, seed=S)
    want_y, want_f = ref_ssd_chunked(*map(_j, (x, dt, A, Bm, Cm)), chunk=chunk,
                                     initial_state=_j(h0))
    y, f = ssd_chunked_ref(*map(_t, (x, dt, A, Bm, Cm)), chunk, _t(h0),
                           compute_dtype=torch.float64)
    assert y.dtype == f.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(want_f), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("S,P,N,chunk", [(64, 16, 8, 16), (128, 32, 16, 32), (32, 8, 8, 32)])
def test_matches_the_pallas_kernel_and_the_sequential_ref(S, P, N, chunk):
    """``tests/test_kernels.py::TestSSD``'s sweep: three folded (batch x head)
    rows, each with its own B / C, are three heads of three groups here."""
    BH = 3
    x, dt, A, Bm, Cm, _ = make_inputs(1, S, BH, P, BH, N, False, seed=S + P)
    xk = x[0].transpose(1, 0, 2)  # [BH, S, P]
    y_k, fin_k = ssd_op(jnp.asarray(xk), jnp.asarray(dt[0].T), jnp.asarray(A),
                        jnp.asarray(Bm[0].transpose(1, 0, 2)), jnp.asarray(Cm[0].transpose(1, 0, 2)),
                        chunk=chunk)
    y, f = ssd_chunked_ref(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    np.testing.assert_allclose(y[0].numpy().transpose(1, 0, 2), np.asarray(y_k), atol=2e-3)
    np.testing.assert_allclose(f[0].numpy(), np.asarray(fin_k), atol=2e-3)
    ys, fs = ssd_ref(*map(_t, (x, dt, A, Bm, Cm)))
    yr, fr = jref.ssd_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(ys.numpy(), np.asarray(yr), atol=2e-3)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fr), atol=2e-3)
    np.testing.assert_allclose(ys.numpy(), y.numpy(), atol=2e-3)


@pytest.mark.parametrize("shape", SHAPES[1:3], ids=IDS[1:3])
def test_sequential_ref_with_groups_and_an_initial_state(shape):
    B, S, H, P, G, N, chunk, init = shape
    x, dt, A, Bm, Cm, h0 = make_inputs(B, S, H, P, G, N, init, seed=2 * S)
    ys, fs = ssd_ref(*map(_t, (x, dt, A, Bm, Cm)), _t(h0))
    yr, fr = jref.ssd_ref(*map(_j, (x, dt, A, Bm, Cm)), _j(h0))
    np.testing.assert_allclose(ys.numpy(), np.asarray(yr), atol=2e-3)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fr), atol=2e-3)
    y, f = ssd_chunked_ref(*map(_t, (x, dt, A, Bm, Cm)), chunk, _t(h0))
    np.testing.assert_allclose(y.numpy(), ys.numpy(), atol=2e-3)
    np.testing.assert_allclose(f.numpy(), fs.numpy(), atol=2e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_written_out_gradient_matches_jax_grad(shape):
    B, S, H, P, G, N, chunk, init = shape
    x, dt, A, Bm, Cm, h0 = make_inputs(B, S, H, P, G, N, init, seed=S + 100)
    rng = np.random.RandomState(S + 200)
    gy = rng.randn(B, S, H, P).astype(np.float32)
    gf = rng.randn(B, H, P, N).astype(np.float32)
    argnums = (0, 1, 2, 3, 4, 5) if init else (0, 1, 2, 3, 4)

    def ref_loss(*args):
        h = args[5] if init else None
        y, f = ref_ssd_chunked(*args[:5], chunk=chunk, initial_state=h)
        return jnp.sum(y * gy) + jnp.sum(f * gf)

    ins = [x, dt, A, Bm, Cm] + ([h0] if init else [])
    want = jax.grad(ref_loss, argnums=argnums)(*map(jnp.asarray, ins))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, f = SSDFunction.apply(*ts[:5], chunk, ts[5] if init else None)
    got = torch.autograd.grad((y * _t(gy)).sum() + (f * _t(gf)).sum(), ts)
    names = ["dx", "ddt", "dA", "dB", "dC", "d initial_state"]
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4, err_msg=name)


def test_backward_of_y_alone_and_of_the_final_state_alone():
    """The Function's backward with only one output in the loss: the other
    output's gradient arrives as zeros (or None) and adds nothing."""
    x, dt, A, Bm, Cm, h0 = make_inputs(1, 24, 4, 8, 2, 8, True, seed=5)
    for which in (0, 1):
        ts = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm, h0)]
        out = SSDFunction.apply(*ts[:5], 16, ts[5])[which]
        got = torch.autograd.grad(out.square().sum(), ts)
        ts2 = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm, h0)]
        want = torch.autograd.grad(ssd_chunked_ref(*ts2[:5], 16, ts2[5])[which].square().sum(),
                                   ts2, allow_unused=True)  # the final state reads no C
        for a, b, t in zip(got, want, ts2):
            torch.testing.assert_close(a, torch.zeros_like(t) if b is None else b, atol=1e-4,
                                       rtol=1e-4)


def test_backward_pads_a_ragged_last_chunk():
    """S = 29 with chunk 8: the backward's chunks are 8, 8, 8 and 5 steps
    (padded with dt = 0), the plain forward's are 29 of one step."""
    assert ssd_chunk_len(29, 8) == 1 and kernel_chunk_len(29, 8) == 8
    x, dt, A, Bm, Cm, h0 = make_inputs(2, 29, 4, 8, 1, 8, True, seed=29)
    ts = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)]
    dy = torch.from_numpy(np.random.RandomState(1).randn(2, 29, 4, 8).astype(np.float32))
    grads = ssd_backward(*ts[:5], dy, None, 8, ts[5])
    leaves = [t.clone().requires_grad_() for t in ts]
    y, _ = ssd_chunked_ref(*leaves[:5], 8, leaves[5])
    want = torch.autograd.grad((y * dy).sum(), leaves)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_bfloat16_inputs_keep_their_dtype_in_the_gradient():
    x, dt, A, Bm, Cm, _ = make_inputs(1, 16, 4, 8, 1, 8, False, seed=3)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    Bb = torch.from_numpy(Bm).bfloat16().requires_grad_()
    Cb = torch.from_numpy(Cm).bfloat16().requires_grad_()
    dtt, At = torch.from_numpy(dt).requires_grad_(), torch.from_numpy(A).requires_grad_()
    y, f = SSDFunction.apply(xb, dtt, At, Bb, Cb, 8, None)
    assert y.dtype == f.dtype == torch.float32
    gx, gdt, gA, gB, gC = torch.autograd.grad(y.sum() + f.sum(), (xb, dtt, At, Bb, Cb))
    assert (gx.dtype, gB.dtype, gC.dtype) == (torch.bfloat16,) * 3
    assert (gdt.dtype, gA.dtype) == (torch.float32,) * 2


@pytest.mark.parametrize("bad", ["groups", "dt_dtype", "init_shape", "init_dtype", "A_shape",
                                 "chunk"])
def test_launcher_rejects_what_the_kernel_does_not_take(bad):
    x, dt, A, Bm, Cm, h0 = (_t(a) for a in make_inputs(1, 16, 4, 8, 1, 8, True, seed=1))
    chunk = 8
    if bad == "groups":
        Bm = Cm = torch.zeros(1, 16, 3, 8)
    elif bad == "dt_dtype":
        dt = dt.double()
    elif bad == "init_shape":
        h0 = h0[:, :2]
    elif bad == "init_dtype":
        h0 = h0.bfloat16()
    elif bad == "A_shape":
        A = A[:2]
    else:
        chunk = 0
    with pytest.raises((ValueError, TypeError)):
        ssd_forward(x, dt, A, Bm, Cm, chunk, h0)


def test_cuda_engine_refuses_cpu_tensors():
    x, dt, A, Bm, Cm, _ = (_t(a) if a is not None else None
                           for a in make_inputs(1, 8, 2, 8, 1, 8, False, seed=2))
    with pytest.raises(RuntimeError, match="cannot run"):
        ssd_chunked(x, dt, A, Bm, Cm, 8, engine="cuda")
