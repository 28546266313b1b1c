"""The port's multi-head latent attention (MLA, ``repro_torch.models.
attention``) against the reference's on the CPU.

Weights and activations are drawn with numpy from a seed and handed to both
packages.  ``mla_block_full`` runs at odd lengths with a query chunk that
does not divide them: the reference halves its chunk until it divides S (to
one row at an odd S), the port takes ``min(q_chunk, S)``-row chunks and a
ragged last one; each row has its own softmax, so the two compute the same
function.  A prompt is prefilled into the cache in two pieces, then decode
steps follow, each read against the reference's output and cache.
Tolerances: float32 with a float32 cache within atol / rtol 1e-4 (the
reference's bound), bfloat16 within 8e-2.  Gradients of a random
projection of the output against ``jax.grad``, float32, atol 1e-5 / rtol
1e-4.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.models import attention as attn
from repro_torch.models.config import BlockDef, ModelConfig

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=8e-2, rtol=0)}
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
BDEF = BlockDef(kind="mla")


def make_cfg(**over) -> ModelConfig:
    base = dict(name="mla-test", n_layers=1, d_model=48, n_heads=4, n_kv_heads=4, d_ff=64,
                vocab=64, kv_lora_rank=24, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=12,
                q_chunk=4, prefill_q_chunk=8)
    base.update(over)
    return ModelConfig(**base)


def make_weights(cfg, seed=0) -> dict:
    rng = np.random.RandomState(seed)
    out = {}
    for name, spec in attn.mla_specs(cfg).items():
        if spec.init == "zeros":  # the norm's gain (1 + scale): a random scale tests it
            out[name] = (0.3 * rng.randn(*spec.shape)).astype(np.float32)
        else:
            out[name] = (spec.std * rng.randn(*spec.shape)).astype(np.float32)
    return out


def port_params(weights, requires_grad=False):
    return types.SimpleNamespace(**{
        k: torch.from_numpy(v.copy()).requires_grad_(requires_grad) for k, v in weights.items()})


def ref_params(weights):
    return {k: jnp.asarray(v) for k, v in weights.items()}


def positions(B, S, offset=0):
    return np.broadcast_to(np.arange(offset, offset + S)[None], (B, S)).astype(np.int32)


def as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("S,q_chunk", [(13, 4), (16, 4), (7, 16), (21, 8)])
def test_full_block_matches_at_odd_lengths(dtype, S, q_chunk):
    cfg = make_cfg(q_chunk=q_chunk, compute_dtype=dtype)
    weights = make_weights(cfg, seed=S)
    B = 2
    x = np.random.RandomState(S + 1).randn(B, S, cfg.d_model).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, _ = ref_attn.mla_block_full(ref_params(weights), jnp.asarray(x).astype(jdt), cfg, BDEF,
                                      jnp.asarray(positions(B, S)))
    got, cache = attn.mla_block_full(port_params(weights), torch.from_numpy(x).to(tdt), cfg, BDEF,
                                     torch.from_numpy(positions(B, S)))
    assert cache is None and got.dtype == tdt and got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
def test_prefill_then_decode_matches_with_the_cache(dtype):
    """13 prompt tokens prefilled as 9 + 4 (the second piece at
    ``cache_index`` 9), then 4 decode steps, into a cache of 24 rows in the
    compute dtype; every output and the whole cache after every call."""
    cfg = make_cfg(compute_dtype=dtype)
    weights = make_weights(cfg, seed=3)
    B, T, pieces, steps = 2, 24, (9, 4), 4
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x = np.random.RandomState(4).randn(B, sum(pieces) + steps, cfg.d_model).astype(np.float32)
    ref_cache = ref_attn.empty_mla_cache(cfg, B, T, jdt)
    cache = attn.empty_mla_cache(cfg, B, T, tdt, device="cpu")
    assert set(cache) == {"c_kv", "k_rope"}
    assert cache["c_kv"].shape == (B, T, cfg.kv_lora_rank) and cache["c_kv"].dtype == tdt
    rp, pp = ref_params(weights), port_params(weights)
    start = 0
    for n in pieces:
        xs = x[:, start:start + n]
        want, ref_cache = ref_attn.mla_block_full(
            rp, jnp.asarray(xs).astype(jdt), cfg, BDEF, jnp.asarray(positions(B, n, start)),
            cache=ref_cache, cache_index=start)
        got, cache = attn.mla_block_full(
            pp, torch.from_numpy(xs).to(tdt), cfg, BDEF, torch.from_numpy(positions(B, n, start)),
            cache=cache, cache_index=start)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype], err_msg=f"piece {n}")
        for key in cache:
            np.testing.assert_allclose(as_np(cache[key]), as_np(ref_cache[key]), **TOL[dtype],
                                       err_msg=key)
        start += n
    for step in range(steps):
        xs = x[:, start:start + 1]
        want, ref_cache = ref_attn.mla_block_decode(rp, jnp.asarray(xs).astype(jdt), cfg, BDEF,
                                                    ref_cache, start)
        got, cache = attn.mla_block_decode(pp, torch.from_numpy(xs).to(tdt), cfg, BDEF, cache,
                                           start)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype], err_msg=f"step {step}")
        for key in cache:
            np.testing.assert_allclose(as_np(cache[key]), as_np(ref_cache[key]), **TOL[dtype],
                                       err_msg=key)
        start += 1
    assert not cache["c_kv"][:, start:].any()  # rows past the last token stay empty


def test_bfloat16_cache_under_float32_compute():
    """The cache rounds ``c_kv`` / ``k_rope`` to bfloat16; float32 compute
    reads them back exactly, as the reference's products promote them."""
    cfg = make_cfg(compute_dtype="float32")
    weights = make_weights(cfg, seed=5)
    B, S, T = 2, 11, 16
    x = np.random.RandomState(6).randn(B, S + 1, cfg.d_model).astype(np.float32)
    ref_cache = ref_attn.empty_mla_cache(cfg, B, T, jnp.bfloat16)
    cache = attn.empty_mla_cache(cfg, B, T, torch.bfloat16)
    want, ref_cache = ref_attn.mla_block_full(ref_params(weights), jnp.asarray(x[:, :S]), cfg,
                                              BDEF, jnp.asarray(positions(B, S)),
                                              cache=ref_cache, cache_index=0)
    got, cache = attn.mla_block_full(port_params(weights), torch.from_numpy(x[:, :S]), cfg, BDEF,
                                     torch.from_numpy(positions(B, S)), cache=cache,
                                     cache_index=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    want, ref_cache = ref_attn.mla_block_decode(ref_params(weights), jnp.asarray(x[:, S:]), cfg,
                                                BDEF, ref_cache, S)
    got, cache = attn.mla_block_decode(port_params(weights), torch.from_numpy(x[:, S:]), cfg,
                                       BDEF, cache, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    for key in cache:
        assert cache[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(as_np(cache[key]), as_np(ref_cache[key]))


def test_float32_cache_under_bfloat16_compute_is_refused():
    """The reference would promote the scores and ``P c_kv`` to float32
    there; the port does not follow that pairing and says so."""
    cfg = make_cfg(compute_dtype="bfloat16")
    weights = make_weights(cfg, seed=5)
    B, S, T = 2, 5, 8
    x = torch.from_numpy(np.random.RandomState(6).randn(B, S, cfg.d_model).astype(np.float32))
    cache = attn.empty_mla_cache(cfg, B, T, torch.float32)
    with pytest.raises(ValueError, match="MLA cache in torch.float32 under torch.bfloat16"):
        attn.mla_block_full(port_params(weights), x.to(torch.bfloat16), cfg, BDEF,
                            torch.from_numpy(positions(B, S)), cache=cache, cache_index=0)


@pytest.mark.parametrize("S,q_chunk", [(13, 4), (16, 16)])
def test_gradients_match_jax_grad(S, q_chunk):
    """Through the ragged chunks, each recomputed in backward."""
    cfg = make_cfg(q_chunk=q_chunk, compute_dtype="float32")
    weights = make_weights(cfg, seed=7)
    B = 2
    rng = np.random.RandomState(8)
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    g = rng.randn(B, S, cfg.d_model).astype(np.float32)
    pos = positions(B, S)

    def ref_loss(w, x_):
        out, _ = ref_attn.mla_block_full(w, x_, cfg, BDEF, jnp.asarray(pos))
        return jnp.sum(out * jnp.asarray(g))

    want_w, want_x = jax.grad(ref_loss, argnums=(0, 1))(ref_params(weights), jnp.asarray(x))
    p = port_params(weights, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = attn.mla_block_full(p, xt, cfg, BDEF, torch.from_numpy(pos))
    names = sorted(weights)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                              [xt] + [getattr(p, n) for n in names])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_x), **GRAD_TOL, err_msg="x")
    for name, grad in zip(names, got[1:]):
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_w[name]), **GRAD_TOL,
                                   err_msg=name)


def test_chunks_are_recomputed_in_backward():
    """Under grad each query chunk runs inside ``torch.utils.checkpoint``:
    the backward pass runs its forward again (3 chunks: 3 more calls)."""
    cfg = make_cfg(q_chunk=4, compute_dtype="float32")
    weights = make_weights(cfg, seed=9)
    x = torch.from_numpy(np.random.RandomState(10).randn(1, 10, cfg.d_model).astype(np.float32))
    calls = []
    real = attn._mla_chunk

    def counting(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    attn._mla_chunk = counting
    try:
        p = port_params(weights, requires_grad=True)
        out, _ = attn.mla_block_full(p, x, cfg, BDEF, torch.arange(10)[None])
        assert calls == [4, 4, 2]
        out.sum().backward()
        assert sorted(calls[3:]) == [2, 4, 4]
        with torch.no_grad():
            attn.mla_block_full(p, x, cfg, BDEF, torch.arange(10)[None])
        assert calls[6:] == [4, 4, 2]
    finally:
        attn._mla_chunk = real


def test_specs_match_the_reference():
    cfg = make_cfg()
    want = ref_attn.mla_specs(cfg)
    got = attn.mla_specs(cfg)
    assert sorted(got) == sorted(want)
    for key, spec in got.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(want[key]), key
