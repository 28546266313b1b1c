"""The port's training path against the reference on the CPU: gradients.

The reference initializes each smoke config's weights; ``params_from_jax``
carries them into the port.  The same batches (the reference's
``SyntheticLM``, which the port's reproduces bit for bit) then go through
both packages' ``loss_fn`` in float32 compute:

* ``attention_full``'s gradients (the port's ``FlashAttentionFunction``
  backward) against ``jax.grad`` of the reference's ``attention_full``, GQA
  with a window and a softcap: atol 1e-5, rtol 1e-4 (float32 sums over at
  most 40 keys and 2 query heads, in another order);
* the loss within 1e-5 and the gradient of every parameter within atol
  1e-5 / rtol 1e-4 on the six dense smoke configs (text, the VLM image mask,
  audio codebooks), zamba2's (mamba2 blocks through ``SSDFunction``'s
  written-out backward, the shared attention block's parameters summed over
  its two repeats) and xlstm's (mLSTM blocks in torch ops, the sLSTM blocks
  through ``SLSTMFunction``'s written-out backward through time): float32
  sums in another order through two to five
  layers, the loss's mean over 64 tokens and the gradients' sums over them
  (the largest difference seen was 2.1e-6, on gradients up to 1.9; on
  zamba2 at most 5% of the bound).  xlstm's gradients are held within atol
  1e-5 x max(1, the leaf's largest |gradient|) / rtol 1e-4: its embedding
  gradient reaches 3.9 (the mLSTM's exponential gates amplify float32
  rounding), and there the two packages lie 2.4e-5 apart, the reference's
  own float32 gradient 1.4e-5 from its float64 one, and both of the
  port's engines (the sLSTM kernel's written-out backward and autograd
  through the plain version) alike; every other xlstm leaf agrees within
  1.6e-6;
  deepseek-v2-lite's and qwen3-moe's (MLA blocks and their query chunks,
  each recomputed in backward; GQA; MoE FFNs with the einsum dispatch, the
  aux loss weighted by ``moe_aux_coef`` in the loss) under the same bound;
* ``warmup_cosine`` equal to the reference's within 1e-7 (the reference
  computes in float32, the port in float64);
* remat on and off give the same gradients (the recomputation repeats the
  forward's operations), on gemma2, zamba2, xlstm and deepseek-v2-lite (its
  MLA query chunks recomputed inside the recomputed superblock);
* the ``torch`` engine (autograd through the plain versions) against the
  kernels' Functions, on gemma2, zamba2, xlstm and qwen3-moe.

The train steps (optimizers, microbatches) are in ``test_torch_train_step.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro import train as ref_train
from repro.models import attention as ref_attn
from repro_torch import configs
from repro_torch.models import Transformer, loss_fn, params_from_jax
from repro_torch.models.attention import attention_full
from repro_torch.models.transformer import state_items
from repro_torch.train import MemmapTokens, SyntheticLM, warmup_cosine

DENSE = ["tinyllama-1.1b", "smollm-135m", "internlm2-1.8b", "gemma2-9b", "llava-next-34b",
         "musicgen-medium"]
ARCHS = DENSE + ["zamba2-1.2b", "xlstm-1.3b", "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
B, S = 2, 32


def _configs(arch, **over):
    over = {"compute_dtype": "float32", **over}
    return (dataclasses.replace(ref_configs.get_smoke_config(arch), **over),
            dataclasses.replace(configs.get_smoke_config(arch), **over))


def _model(cfg, params):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, params)))
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_grads(model, batch, engine="auto"):
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, metrics = loss_fn(model, batch, engine=engine)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), metrics, dict(zip(named, grads))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], (*path, key))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("window,softcap", [(-1, None), (8, None), (-1, 5.0), (12, 20.0)])
def test_attention_full_gradients_match_jax_grad(window, softcap):
    rng = np.random.RandomState(window + 50)
    Bq, Sq, H, KV, D = 2, 40, 4, 2, 16
    q = (rng.randn(Bq, Sq, H, D) * 1.5).astype(np.float32)
    k = (rng.randn(Bq, Sq, KV, D) * 1.5).astype(np.float32)
    v = rng.randn(Bq, Sq, KV, D).astype(np.float32)
    g = rng.randn(Bq, Sq, H, D).astype(np.float32)

    def ref_out(q_, k_, v_):
        o = ref_attn.attention_full(q_, k_, v_, window=window, attn_softcap=softcap, q_chunk=8)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(ref_out, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention_full(*ts, window=window, attn_softcap=softcap, q_chunk=8)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    ref_cfg, cfg = _configs(arch)
    params = ref_models.init_model_params(ref_cfg, jax.random.PRNGKey(1))
    batch = ref_train.SyntheticLM(ref_cfg, batch=B, seq=S, seed=4).batch_at(0)

    (want_loss, want_metrics), want_grads = jax.value_and_grad(
        lambda p: ref_models.loss_fn(p, ref_cfg, batch), has_aux=True)(params)
    loss, metrics, grads = _port_grads(_model(cfg, params), _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(want_metrics["ce"]), atol=1e-5,
                               rtol=1e-5)
    seen = set()
    for path, leaf in _flat(want_grads):
        for name, part in state_items(path, leaf):
            atol = 1e-5 * max(1.0, float(np.abs(part).max())) if arch == "xlstm-1.3b" else 1e-5
            np.testing.assert_allclose(grads[name].numpy(), part, atol=atol, rtol=1e-4,
                                       err_msg=name)
            seen.add(name)
    assert seen == set(grads)


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-1.2b", "xlstm-1.3b", "deepseek-v2-lite-16b"])
def test_remat_on_and_off_give_the_same_gradients(arch):
    _, cfg = _configs(arch)
    params = ref_models.init_model_params(dataclasses.replace(
        ref_configs.get_smoke_config(arch), compute_dtype="float32"), jax.random.PRNGKey(3))
    batch = SyntheticLM(cfg, batch=B, seq=S, seed=2).batch_at(1)
    runs = {}
    for remat in ("nothing_saveable", "dots_saveable", "none"):
        model = _model(dataclasses.replace(cfg, remat=remat), params)
        runs[remat] = _port_grads(model, batch)
    for remat in ("dots_saveable", "none"):
        assert torch.equal(runs[remat][0], runs["nothing_saveable"][0])
        for name, g in runs["nothing_saveable"][2].items():
            assert torch.equal(runs[remat][2][name], g), (remat, name)


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-1.2b", "xlstm-1.3b", "qwen3-moe-235b-a22b"])
def test_torch_engine_matches_the_kernel_path(arch):
    """``engine="torch"`` (autograd through the plain versions) against the
    default path (the kernels' Functions, plain forward on the CPU)."""
    _, cfg = _configs(arch)
    params = ref_models.init_model_params(dataclasses.replace(
        ref_configs.get_smoke_config(arch), compute_dtype="float32"), jax.random.PRNGKey(4))
    batch = SyntheticLM(cfg, batch=B, seq=S, seed=5).batch_at(0)
    auto = _port_grads(_model(cfg, params), batch)
    plain = _port_grads(_model(cfg, params), batch, engine="torch")
    torch.testing.assert_close(auto[0], plain[0], atol=1e-6, rtol=1e-6)
    for name, g in auto[2].items():
        torch.testing.assert_close(g, plain[2][name], atol=2e-6, rtol=1e-4, msg=name)


@pytest.mark.parametrize("peak,warmup,total,floor", [(3e-4, 100, 1000, 0.1), (0.05, 7, 60, 0.1),
                                                     (1e-2, 0, 12, 0.2), (1e-3, 20, 20, 0.1)])
def test_warmup_cosine_matches_the_reference(peak, warmup, total, floor):
    want = ref_train.warmup_cosine(peak, warmup, total, floor)
    got = warmup_cosine(peak, warmup, total, floor)
    for step in range(0, total + 5):
        assert abs(got(step) - float(want(step))) <= 1e-7, step


@pytest.mark.parametrize("arch", ["smollm-135m", "llava-next-34b", "musicgen-medium"])
@pytest.mark.parametrize("structured", [True, False])
def test_synthetic_batches_are_bit_identical(arch, structured):
    ref_cfg, cfg = _configs(arch)
    want = ref_train.SyntheticLM(ref_cfg, batch=3, seq=32, seed=9, structured=structured)
    got = SyntheticLM(cfg, batch=3, seq=32, seed=9, structured=structured)
    got.skip_to(5)
    want.skip_to(5)
    for _ in range(3):
        a, b = got.next_batch(), want.next_batch()
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == torch.from_numpy(np.array(b[key])).dtype, key
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=key)


def test_memmap_batches_are_bit_identical(tmp_path):
    ref_cfg, cfg = _configs("smollm-135m")
    path = str(tmp_path / "tokens.int32")
    np.arange(3 * 4 * 17 + 5, dtype=np.int32).tofile(path)
    want = ref_train.MemmapTokens(path, ref_cfg, batch=4, seq=16)
    got = MemmapTokens(path, cfg, batch=4, seq=16)
    got.skip_to(2)
    want.skip_to(2)
    for _ in range(4):  # wraps around the 3 whole batches the file holds
        a, b = got.next_batch(), want.next_batch()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=key)
