"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU.

Weights and activations are drawn with numpy from a seed and handed to both
packages.  Both dispatch modes are held to their own twin, never to each
other, while capacity drops are active (``moe_capacity=0.5``): ``einsum``
fills each group's expert buffers choice-major, ``sort`` token-major with
one capacity over all tokens, so the two drop different tokens.  Only at
``moe_capacity=8.0``, where nothing drops, are the two modes held to each
other (as ``tests/test_models_smoke.py`` does).  Tolerances: float32 within
atol / rtol 1e-4 (the reference's bound; the largest difference seen was
below 1e-6), bfloat16 within 8e-2 (the reference's bfloat16 bound; both
packages route the same bfloat16 input here, so no expert choice flips).
Gradients of a random projection of the output plus the aux loss against
``jax.grad``, float32, atol 1e-5 / rtol 1e-4.
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.models import count_active_params, count_params
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=8e-2, rtol=0)}
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def make_cfg(**over) -> ModelConfig:
    base = dict(name="moe-test", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4, d_ff=48,
                vocab=64, moe_experts=8, moe_top_k=2, moe_d_ff=48, moe_group=16,
                moe_capacity=0.5)
    base.update(over)
    return ModelConfig(**base)


def make_weights(cfg, seed=0) -> dict:
    rng = np.random.RandomState(seed)
    d, E, F = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    w = {"router": rng.randn(d, E) / math.sqrt(d),
         "w1": rng.randn(E, d, F) / math.sqrt(d), "w3": rng.randn(E, d, F) / math.sqrt(d),
         "w2": rng.randn(E, F, d) / math.sqrt(F)}
    if cfg.moe_shared_d_ff:
        Fs = cfg.moe_shared_d_ff
        w.update(sw1=rng.randn(d, Fs) / math.sqrt(d), sw3=rng.randn(d, Fs) / math.sqrt(d),
                 sw2=rng.randn(Fs, d) / math.sqrt(Fs))
    return {k: v.astype(np.float32) for k, v in w.items()}


def make_x(B, S, d, seed=1) -> np.ndarray:
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


def port_params(weights, requires_grad=False):
    return types.SimpleNamespace(**{
        k: torch.from_numpy(v.copy()).requires_grad_(requires_grad) for k, v in weights.items()})


def ref_ffn(cfg, weights, x, dtype):
    y, aux = ref_moe.moe_ffn({k: jnp.asarray(v) for k, v in weights.items()},
                             jnp.asarray(x).astype(dtype), cfg)
    return np.asarray(y.astype(jnp.float32)), float(aux)


def port_ffn(cfg, weights, x, dtype):
    y, aux = moe.moe_ffn(port_params(weights), torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    return y.float().numpy(), float(aux)


@pytest.mark.parametrize("shape", [(5, 8), (64, 8), (7, 128)])
def test_top_k_takes_the_lower_index_first_on_ties(shape):
    """Values rounded to a few levels: most rows hold ties across the cut."""
    rng = np.random.RandomState(shape[0])
    probs = np.round(rng.rand(*shape) * 4) / 4
    probs = probs.astype(np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("E,k", [(8, 2), (64, 6), (128, 8)])
def test_router_and_aux_loss_match_the_reference(norm_topk, E, k):
    cfg = make_cfg(d_model=64, moe_experts=E, moe_top_k=k, moe_norm_topk=norm_topk)
    weights = make_weights(cfg, seed=E)
    x = make_x(1, 96, 64, seed=k)[0]
    w_ref, idx_ref, aux_ref = ref_moe._router({"router": jnp.asarray(weights["router"])},
                                              jnp.asarray(x), cfg)
    w, idx, aux = moe._router(port_params(weights), torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)
    assert w.dtype == torch.float32


@pytest.mark.parametrize("tokens,E,k,capacity", [(8, 64, 6, 1.25), (4096, 64, 6, 1.25),
                                                 (2048, 128, 8, 1.25), (30, 8, 2, 0.5),
                                                 (1, 8, 2, 8.0), (16384, 64, 6, 1.25)])
def test_capacity_matches_the_reference(tokens, E, k, capacity):
    cfg = make_cfg(moe_experts=E, moe_top_k=k, moe_capacity=capacity)
    assert moe._capacity(tokens, cfg) == ref_moe._capacity(tokens, cfg)


def test_group_size_halves_until_it_divides():
    """The capacity is per group, so the group size is part of the function:
    a served group of 8 x 1895 tokens at deepseek-v2-lite's settings takes
    groups of 8 tokens with C = max(ceil(8 * 6 / 64 * 1.25), 6) = 6."""
    cfg = configs.get_config("deepseek-v2-lite-16b")
    assert moe.group_size(8 * 1895, cfg) == 8
    assert moe._capacity(8, cfg) == 6
    assert moe.group_size(8 * 2048, cfg) == 4096
    assert moe.group_size(8 * 2047, cfg) == 8
    assert moe.group_size(40, make_cfg(moe_group=16)) == 8
    assert moe.group_size(45, make_cfg(moe_group=16)) == 1
    assert moe.group_size(12, make_cfg(moe_group=64)) == 12


CASES = [(mode, dtype) for mode in ("einsum", "sort") for dtype in TOL]


@pytest.mark.parametrize("mode,dtype", CASES)
@pytest.mark.parametrize("B,S", [(2, 16), (2, 20), (3, 15)])
def test_dispatch_matches_its_twin_with_drops(mode, dtype, B, S):
    """Capacity 0.5 drops about half of the assignments; 2 x 20 tokens halve
    the group of 16 to 8, 3 x 15 to 1 (a group per token: there the einsum
    mode's C = k and nothing drops, the sort mode's one capacity drops)."""
    cfg = make_cfg(moe_dispatch=mode)
    weights = make_weights(cfg)
    x = make_x(B, S, cfg.d_model, seed=B * S)
    want, want_aux = ref_ffn(cfg, weights, x, dtype)
    got, aux = port_ffn(cfg, weights, x, dtype)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    # the drops are active: without them the output is another one
    undropped, _ = port_ffn(dataclasses.replace(cfg, moe_capacity=8.0), weights, x, dtype)
    drops = mode == "sort" or moe.group_size(B * S, cfg) > 1
    assert (np.abs(undropped - got).max() > 0.1) == drops


@pytest.mark.parametrize("dtype", list(TOL))
def test_einsum_group_blocks_change_nothing(monkeypatch, dtype):
    """The einsum dispatch runs its groups in blocks of ``EXPERT_ROWS``
    buffer rows: one group a block (and a ragged last block) gives the
    reference's output as the single block does."""
    cfg = make_cfg(moe_group=8, moe_capacity=1.0)
    weights = make_weights(cfg, seed=14)
    x = make_x(2, 20, cfg.d_model, seed=15)  # 5 groups of 8, C = 2
    want, _ = ref_ffn(cfg, weights, x, dtype)
    whole, _ = port_ffn(cfg, weights, x, dtype)
    for rows in (8 * 2, 8 * 2 * 2):  # 1 and 2 groups a block
        monkeypatch.setattr(moe, "EXPERT_ROWS", rows)
        blocked, _ = port_ffn(cfg, weights, x, dtype)
        np.testing.assert_allclose(blocked, want, **TOL[dtype])
        np.testing.assert_allclose(blocked, whole, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mode", ["einsum", "sort"])
@pytest.mark.parametrize("dtype", list(TOL))
def test_shared_experts_match_the_reference(mode, dtype):
    cfg = make_cfg(moe_dispatch=mode, moe_shared_d_ff=64, moe_capacity=1.25, moe_top_k=3)
    weights = make_weights(cfg, seed=5)
    x = make_x(2, 24, cfg.d_model, seed=6)
    want, want_aux = ref_ffn(cfg, weights, x, dtype)
    got, aux = port_ffn(cfg, weights, x, dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)


@pytest.mark.parametrize("shared", [0, 48])
def test_einsum_and_sort_agree_without_drops(shared):
    """At capacity 8 no assignment drops and the two modes compute the same
    function (``tests/test_models_smoke.py``'s comparison)."""
    cfg = make_cfg(moe_capacity=8.0, moe_shared_d_ff=shared)
    weights = make_weights(cfg, seed=7)
    x = make_x(2, 20, cfg.d_model, seed=8)
    a, aux_a = port_ffn(cfg, weights, x, "float32")
    b, aux_b = port_ffn(dataclasses.replace(cfg, moe_dispatch="sort"), weights, x, "float32")
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    assert aux_a == aux_b


def test_sort_combine_is_repeatable():
    cfg = make_cfg(moe_dispatch="sort", moe_top_k=4, moe_capacity=1.0)
    weights = make_weights(cfg, seed=9)
    x = torch.from_numpy(make_x(4, 32, cfg.d_model, seed=10)).bfloat16()
    a = moe.moe_ffn(port_params(weights), x, cfg)[0]
    b = moe.moe_ffn(port_params(weights), x, cfg)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["einsum", "sort"])
@pytest.mark.parametrize("capacity", [0.5, 8.0])
def test_gradients_match_jax_grad(mode, capacity):
    cfg = make_cfg(moe_dispatch=mode, moe_capacity=capacity, moe_shared_d_ff=40)
    weights = make_weights(cfg, seed=11)
    x = make_x(2, 20, cfg.d_model, seed=12)
    g = np.random.RandomState(13).randn(*x.shape).astype(np.float32)

    def ref_loss(w, x_):
        y, aux = ref_moe.moe_ffn(w, x_, cfg)
        return jnp.sum(y * jnp.asarray(g)) + 3.0 * aux

    want_w, want_x = jax.grad(ref_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in weights.items()}, jnp.asarray(x))
    p = port_params(weights, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(p, xt, cfg)
    names = sorted(weights)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum() + 3.0 * aux,
                              [xt] + [getattr(p, n) for n in names])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_x), **GRAD_TOL, err_msg="x")
    for name, grad in zip(names, got[1:]):
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_w[name]), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_count_active_params_equals_the_reference(arch, get):
    cfg = getattr(configs, get)(arch)
    ref_cfg = getattr(ref_configs, get)(arch)
    n = count_active_params(cfg)
    assert n == ref_models.count_active_params(ref_cfg)
    assert n < count_params(cfg)
