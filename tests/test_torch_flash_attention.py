"""The port's flash-attention wrapper against the reference on the CPU.

On CPU tensors the wrapper runs its plain PyTorch version
(``repro_torch.kernels.ref.flash_attention_ref``).  The same numpy-seeded
inputs go through the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.flash_attention_op``) and its oracle
(``repro.kernels.ref.attention_ref``) over the reference's own sweep
(``tests/test_kernels.py``), with its tolerances: 1e-4 in float32 and 2e-2
in bfloat16 (the Pallas kernel and the plain version accumulate in float32
in different orders, and bfloat16 rounds the output).  The port's
``q_offset`` / ``kv_len`` arguments are held against ``attention_ref`` on
the full-length problem, sliced.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ops import flash_attention_op
from repro_torch.kernels import flash_attention as fa

DTYPES = {"float32": (np.float32, torch.float32, 1e-4), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _pair(arrays, dtype):
    """The arrays as jax arrays and torch tensors of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32),
                      np.float32)


def _check(out, expect, tol):
    np.testing.assert_allclose(_np(out), _np(expect), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "B,Hq,Hkv,S,D,bq,bk",
    [
        (1, 2, 2, 64, 32, 16, 16),    # MHA
        (2, 4, 2, 128, 32, 32, 32),   # GQA 2x
        (1, 8, 1, 96, 16, 32, 32),    # MQA, non-multiple seq (pad path)
        (1, 2, 2, 128, 128, 128, 64), # wide head_dim
    ],
)
def test_matches_pallas_kernel_and_oracle(dtype, B, Hq, Hkv, S, D, bq, bk):
    arrays = _inputs(S + D, [(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)])
    (qj, kj, vj), (qt, kt, vt) = _pair(arrays, dtype)
    tol = DTYPES[dtype][2]
    out = fa.flash_attention(qt, kt, vt, causal=True)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _check(out, flash_attention_op(qj, kj, vj, causal=True, block_q=bq, block_k=bk), tol)
    _check(out, ref.attention_ref(qj, kj, vj, causal=True), tol)


def _in_each_dtype(name, values):
    """``parametrize`` over ``values`` in float32 and bfloat16; the float32
    cases keep the ids they had before bfloat16 joined them."""
    cases = [(x, d) for d in DTYPES for x in values]
    ids = [str(x) if d == "float32" else f"{x}-{d}" for x, d in cases]
    return pytest.mark.parametrize(f"{name},dtype", cases, ids=ids)


@_in_each_dtype("window", [8, 32, 100])
def test_sliding_window(window, dtype):
    arrays = _inputs(window, [(1, 2, 64, 16)] * 3)
    (qj, kj, vj), (qt, kt, vt) = _pair(arrays, dtype)
    tol = DTYPES[dtype][2]
    out = fa.flash_attention(qt, kt, vt, causal=True, window=window)
    _check(out, flash_attention_op(qj, kj, vj, causal=True, window=window, block_q=16, block_k=16), tol)
    _check(out, ref.attention_ref(qj, kj, vj, causal=True, window=window), tol)


@_in_each_dtype("softcap", [10.0, 50.0])
def test_softcap(softcap, dtype):
    arrays = _inputs(int(softcap), [(1, 2, 64, 16)] * 3, scale=3.0)
    (qj, kj, vj), (qt, kt, vt) = _pair(arrays, dtype)
    tol = DTYPES[dtype][2]
    out = fa.flash_attention(qt, kt, vt, causal=True, softcap=softcap)
    _check(out, flash_attention_op(qj, kj, vj, causal=True, softcap=softcap, block_q=32, block_k=32), tol)
    _check(out, ref.attention_ref(qj, kj, vj, causal=True, softcap=softcap), tol)


def _non_causal(dtype):
    arrays = _inputs(48, [(1, 2, 48, 16)] * 3)
    (qj, kj, vj), (qt, kt, vt) = _pair(arrays, dtype)
    tol = DTYPES[dtype][2]
    out = fa.flash_attention(qt, kt, vt, causal=False)
    _check(out, flash_attention_op(qj, kj, vj, causal=False, block_q=16, block_k=16), tol)
    _check(out, ref.attention_ref(qj, kj, vj, causal=False), tol)


def test_non_causal():
    _non_causal("float32")


def test_non_causal_bfloat16():
    _non_causal("bfloat16")


@pytest.mark.parametrize("D", [8, 256])
@pytest.mark.parametrize("kw", [{}, {"causal": False}, {"window": 24, "softcap": 30.0}],
                         ids=["causal", "non-causal", "window-softcap"])
def test_bfloat16_at_the_narrowest_and_widest_heads(D, kw):
    """bfloat16 at head widths 8 (below the tensor-core kernel's MMA depth of
    16, which it zero-pads) and 256 (gemma2's), GQA 2x and a ragged length,
    against the Pallas kernel in interpret mode and its oracle."""
    arrays = _inputs(D, [(1, 4, 72, D), (1, 2, 72, D), (1, 2, 72, D)], scale=2.0)
    (qj, kj, vj), (qt, kt, vt) = _pair(arrays, "bfloat16")
    causal = kw.get("causal", True)
    opts = dict(causal=causal, window=kw.get("window", -1), softcap=kw.get("softcap", 0.0))
    out = fa.flash_attention(qt, kt, vt, **opts)
    _check(out, flash_attention_op(qj, kj, vj, block_q=16, block_k=16, **opts), 2e-2)
    _check(out, ref.attention_ref(qj, kj, vj, **opts), 2e-2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "Sq,q_offset,T,kv_len,window,softcap",
    [
        (16, 24, 64, 40, -1, 0.0),   # prefill of 16 tokens after a 24-token cache
        (1, 39, 64, 40, -1, 0.0),    # one query at the end of the filled cache
        (32, 0, 48, 32, -1, 0.0),    # the cache's empty slots beyond kv_len are masked
        (20, 12, 40, 32, 8, 50.0),   # window and softcap with an offset
    ],
)
def test_q_offset_and_kv_len_match_the_sliced_oracle(dtype, Sq, q_offset, T, kv_len, window, softcap):
    """Queries at positions q_offset.. against the first kv_len of T keys are
    rows q_offset.. of the full causal problem over kv_len keys."""
    B, Hq, Hkv, D = 2, 4, 2, 16
    q_full, k, v = _inputs(Sq + T, [(B, Hq, kv_len, D), (B, Hkv, T, D), (B, Hkv, T, D)], scale=2.0)
    q = np.ascontiguousarray(q_full[:, :, q_offset:q_offset + Sq])
    (qj, kj, vj), (qt, kt, vt) = _pair([q_full, k[:, :, :kv_len], v[:, :, :kv_len]], dtype)
    _, (qt, kt, vt) = _pair([q, k, v], dtype)
    tol = DTYPES[dtype][2]
    out = fa.flash_attention(qt, kt, vt, causal=True, window=window, softcap=softcap,
                             q_offset=q_offset, kv_len=kv_len)
    expect = ref.attention_ref(qj, kj, vj, causal=True, window=window, softcap=softcap)
    _check(out, expect[:, :, q_offset:q_offset + Sq], tol)


def test_model_layout_reads_the_same_problem():
    """Transposed views of the model's [B, S, H, D] tensors give the result
    of contiguous [B, H, S, D] inputs, in the views' strides."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, [(2, 4, 40, 32), (2, 2, 40, 32), (2, 2, 40, 32)]))
    want = fa.flash_attention(q, k, v, window=16, softcap=30.0)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # [B, S, H, D]
    got = fa.flash_attention(qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
                             window=16, softcap=30.0)
    assert got.shape == (2, 4, 40, 32)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cpu_tensors_never_count_a_launch():
    fa.reset_launches()
    q = torch.randn(1, 2, 16, 16)
    fa.flash_attention(q, q, q)
    assert fa.launches() == 0


@pytest.mark.parametrize(
    "kwargs,make,exc",
    [
        ({}, lambda: [torch.randn(1, 2, 8, 24)] * 3, ValueError),                       # head dim 24
        ({}, lambda: [torch.randn(1, 2, 8, 16, dtype=torch.float16)] * 3, TypeError),    # fp16
        ({}, lambda: [torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16).bfloat16(),
                      torch.randn(1, 2, 8, 16)], TypeError),                            # mixed dtypes
        ({}, lambda: [torch.randn(1, 2, 16, 8).transpose(2, 3)] * 3, ValueError),        # D not contiguous
        ({}, lambda: [torch.randn(1, 3, 8, 16), torch.randn(1, 2, 8, 16),
                      torch.randn(1, 2, 8, 16)], ValueError),                           # 3 heads over 2
        ({}, lambda: [torch.randn(2, 8, 16)] * 3, ValueError),                          # not 4-D
        ({"kv_len": 0}, lambda: [torch.randn(1, 2, 8, 16)] * 3, ValueError),
        ({"q_offset": 4}, lambda: [torch.randn(1, 2, 8, 16)] * 3, ValueError),           # rows past kv_len
        ({"causal": False, "window": 2, "kv_len": 2},
         lambda: [torch.randn(1, 2, 8, 16)] * 3, ValueError),                           # window sees no key
    ],
)
def test_bad_inputs_raise(kwargs, make, exc):
    with pytest.raises(exc):
        fa.flash_attention(*make(), **kwargs)
