"""The port's fused cross-entropy against the reference on the CPU.

On CPU tensors ``repro_torch.kernels.crossentropy.fused_crossentropy`` runs
the kernel's plain PyTorch version (``kernels/ref.py``).  The same
numpy-seeded inputs go through it and through the reference:

* the reference's Pallas kernel (``crossentropy_op``, interpret mode off the
  TPU, as ``tests/test_kernels.py`` runs it) and its ``crossentropy_ref``,
  at ``tests/test_kernels.py``'s three shapes: atol / rtol 1e-4 in float32
  (float32 sums in another order); softcap 30 with bfloat16 inputs within
  5e-2, the reference's own bound for that case;
* ``models.layers.cross_entropy_chunked`` against the reference's, with and
  without a mask: 1e-5 (a float32 mean of per-token losses near 5);
* the gradients ``dx`` / ``dW`` of the Function (its written-out backward)
  against ``jax.grad`` of the reference's ``cross_entropy_chunked`` in
  float32, softcap included, through a tied (transposed) head: atol 1e-6,
  rtol 1e-4 (each entry is a float32 sum over at most 64 rows or columns of
  terms below 1, summed in another order);
* the wrapper refuses what the kernel does not take;
* the bfloat16 W operand the tensor-core kernel reads
  (``tensor_core_weight``, plain torch, so it runs here): K-major, the cast
  keeping the tied head's transposed strides and transposing an untied
  head, rows that are not 16 bytes apart padded, the values those of
  ``w.to(torch.bfloat16)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kernels
from repro.kernels.ops import crossentropy_op
from repro.models import layers as ref_layers
from repro_torch.kernels import crossentropy as ce
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import crossentropy_ref
from repro_torch.models.layers import cross_entropy_chunked

SHAPES = [(64, 32, 500, 32, 128), (100, 48, 1000, 32, 256), (16, 16, 50, 16, 64)]


def _inputs(seed, T, D, V, w_scale):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, D).astype(np.float32)
    w = (rng.randn(D, V) * w_scale).astype(np.float32)
    labels = rng.randint(0, V, (T,)).astype(np.int32)
    return x, w, labels


@pytest.mark.parametrize("T,D,V,bt,bv", SHAPES)
def test_matches_the_reference_kernel_and_ref(T, D, V, bt, bv):
    x, w, labels = _inputs(T + V, T, D, V, 0.05)
    want_kernel = np.asarray(crossentropy_op(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                             block_t=bt, block_v=bv))
    want_ref = np.asarray(ref_kernels.crossentropy_ref(jnp.asarray(x), jnp.asarray(w),
                                                       jnp.asarray(labels)))
    got = ce.fused_crossentropy(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-4, rtol=1e-4)
    # int64 labels give the same numbers
    got64 = ce.fused_crossentropy(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(labels).long())
    assert torch.equal(got64, got)


def test_softcap_and_bf16():
    x, w, labels = _inputs(7, 32, 16, 100, 0.2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(crossentropy_op(xb, wb, jnp.asarray(labels), softcap=30.0,
                                      block_t=16, block_v=64))
    want_ref = np.asarray(ref_kernels.crossentropy_ref(xb, wb, jnp.asarray(labels), softcap=30.0))
    to_bf16 = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()  # noqa: E731
    got = ce.fused_crossentropy(to_bf16(xb), to_bf16(wb), torch.from_numpy(labels), softcap=30.0)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=5e-2, rtol=5e-2)


def test_labels_outside_the_vocabulary_pick_no_logit():
    """As in the TPU kernel: the label logit of an out-of-range label is 0,
    so the NLL is the row's logsumexp."""
    x, w, labels = _inputs(3, 8, 16, 40, 0.3)
    labels[2], labels[5] = -1, 40
    nll, lse = ce.crossentropy_forward(torch.from_numpy(x), torch.from_numpy(w),
                                       torch.from_numpy(labels))
    assert nll[2] == lse[2] and nll[5] == lse[5]
    z = torch.from_numpy(x) @ torch.from_numpy(w)
    torch.testing.assert_close(lse, torch.logsumexp(z, dim=1), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_cross_entropy_chunked_matches_the_reference(masked, softcap):
    rng = np.random.RandomState(11)
    B, S, D, V = 2, 32, 16, 128
    x = rng.randn(B, S, D).astype(np.float32)
    w = (rng.randn(D, V) * 0.5).astype(np.float32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    mask = (rng.rand(B, S) > 0.3).astype(np.float32) if masked else None
    want = float(ref_layers.cross_entropy_chunked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), chunk=8, final_softcap=softcap,
        mask=None if mask is None else jnp.asarray(mask)))
    got = cross_entropy_chunked(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels), chunk=8,
        final_softcap=softcap, mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, atol=1e-5, rtol=1e-5)
    with pytest.raises(AssertionError):
        cross_entropy_chunked(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(labels), chunk=12)


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_gradients_match_jax_grad_of_the_reference(softcap):
    """dx and dW through a tied head (``W = emb.T``, a transposed view), with
    a mask, against ``jax.grad`` of the reference's chunked loss."""
    rng = np.random.RandomState(5)
    B, S, D, V = 2, 24, 16, 64
    x = rng.randn(B, S, D).astype(np.float32)
    emb = (rng.randn(V, D) * 0.7).astype(np.float32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    mask = (rng.rand(B, S) > 0.25).astype(np.float32)

    def ref_loss(x_, emb_):
        return ref_layers.cross_entropy_chunked(x_, emb_.T, jnp.asarray(labels), chunk=8,
                                                final_softcap=softcap, mask=jnp.asarray(mask))

    want_dx, want_demb = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(emb).requires_grad_()
    loss = cross_entropy_chunked(xt, et.T, torch.from_numpy(labels), chunk=8,
                                 final_softcap=softcap, mask=torch.from_numpy(mask))
    dx, demb = torch.autograd.grad(loss, (xt, et))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(demb.numpy(), np.asarray(want_demb), atol=1e-6, rtol=1e-4)


def test_function_backward_matches_autograd_of_the_plain_version():
    """The written-out backward equals autograd through the plain version,
    per-token weights, an out-of-range label and a softcap included."""
    x, w, labels = _inputs(9, 40, 24, 300, 0.5)
    labels[7] = 300
    g = torch.from_numpy(np.random.RandomState(2).randn(40).astype(np.float32))
    grads = []
    for fn in (lambda a, b, y: ce.fused_crossentropy(a, b, y, softcap=20.0),
               lambda a, b, y: crossentropy_ref(a, b, y, 20.0)):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        grads.append(torch.autograd.grad((fn(xt, wt, torch.from_numpy(labels)) * g).sum(),
                                         (xt, wt)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize(
    "make,exc",
    [
        (lambda: (torch.zeros(4, 8, dtype=torch.float16), torch.zeros(8, 5), torch.zeros(4, dtype=torch.int32)), TypeError),
        (lambda: (torch.zeros(4, 8), torch.zeros(8, 5), torch.zeros(4)), TypeError),        # float labels
        (lambda: (torch.zeros(4, 8), torch.zeros(7, 5), torch.zeros(4, dtype=torch.int32)), ValueError),  # D
        (lambda: (torch.zeros(4, 8), torch.zeros(8, 5), torch.zeros(3, dtype=torch.int32)), ValueError),  # T
        (lambda: (torch.zeros(2, 4, 8), torch.zeros(8, 5), torch.zeros(4, dtype=torch.int32)), ValueError),
        (lambda: (torch.zeros(0, 8), torch.zeros(8, 5), torch.zeros(0, dtype=torch.int32)), ValueError),
        (lambda: (torch.zeros(4, 8), torch.zeros(8, 5, device="meta"), torch.zeros(4, dtype=torch.int32)), ValueError),
        (lambda: (np.zeros((4, 8)), torch.zeros(8, 5), torch.zeros(4, dtype=torch.int32)), TypeError),
    ],
)
def test_bad_inputs_raise(make, exc):
    before = ce.launches()
    with pytest.raises(exc):
        ce.fused_crossentropy(*make())
    assert ce.launches() == before


def test_cpu_tensors_never_count_a_launch():
    x, w, labels = _inputs(1, 8, 16, 40, 0.3)
    ce.reset_launches()
    ce.fused_crossentropy(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels))
    assert ce.launches() == 0


class _SeenTF32(torch.overrides.TorchFunctionMode):
    """Records the TF32 flag at every torch call made inside the mode."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.seen.add(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


def _ce_backward():
    x, w, labels = (torch.from_numpy(a) for a in _inputs(0, 40, 16, 50, 0.05))
    lse, g = torch.logsumexp(x @ w, dim=1), torch.ones(40)
    return lambda: ce.crossentropy_backward(x, w, labels, lse, g)


def _flash_backward():
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, h, 24, 8)).astype(np.float32))
                   for h in (4, 2, 2, 4))
    return lambda: fa.flash_attention_backward(q, k, v, do, chunk=8)


@pytest.mark.parametrize("backward", [_ce_backward, _flash_backward])
@pytest.mark.parametrize("allow_tf32", [True, False])
def test_written_out_backwards_run_float32_products_without_tf32(backward, allow_tf32):
    """The backwards recompute float32 products that must match the kernels'
    float32 state, so TF32 is off inside them whatever the caller set, and
    the caller's setting is back after."""
    run = backward()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        with _SeenTF32() as mode:
            run()
        assert mode.seen == {False}
        assert torch.backends.cuda.matmul.allow_tf32 is allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_weight_keeps_the_tied_heads_transposed_strides(w_dtype):
    """The tied head, a transposed view of a [V, D] embedding, stays a
    K-major view after the cast: strides (1, D), no transposed copy."""
    emb = torch.from_numpy(np.random.RandomState(0).randn(40, 24).astype(np.float32)).to(w_dtype)
    wb, ld = ce.tensor_core_weight(emb.T)
    assert wb.dtype == torch.bfloat16 and wb.shape == (24, 40)
    assert ld == 24 and wb.stride() == (1, 24)
    assert torch.equal(wb, emb.T.to(torch.bfloat16))
    if w_dtype == torch.bfloat16:
        assert wb.data_ptr() == emb.data_ptr()  # read in place


def test_tensor_core_weight_transposes_an_untied_head():
    """An untied [D, V] head is cast into K-major [V, D] rows."""
    w = torch.from_numpy(np.random.RandomState(1).randn(24, 64).astype(np.float32))
    wb, ld = ce.tensor_core_weight(w)
    assert ld == 24 and wb.stride() == (1, 24)
    assert torch.equal(wb, w.to(torch.bfloat16))


@pytest.mark.parametrize("tied", [False, True])
def test_tensor_core_weight_pads_rows_that_are_not_16_bytes_apart(tied):
    """D = 20 bf16 elements a row are not a multiple of 16 bytes: the values
    are copied once into K-major rows padded to 24 elements."""
    rng = np.random.RandomState(2)
    w = (torch.from_numpy(rng.randn(50, 20).astype(np.float32)).T if tied
         else torch.from_numpy(rng.randn(20, 50).astype(np.float32)))
    wb, ld = ce.tensor_core_weight(w)
    assert ld == 24 and wb.stride() == (1, 24)
    assert torch.equal(wb, w.to(torch.bfloat16))
