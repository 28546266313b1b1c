"""The port's dense, Mamba2 hybrid (zamba2) and xLSTM (xlstm) models against
the reference on the CPU.

The reference initializes each smoke config's weights
(``repro.models.init_model_params``); ``params_from_jax`` carries them into
the port's ``Transformer``.  The same numpy-seeded batches then go through
``forward`` in the train, prefill and decode modes of both packages, and
the logits (``logits_from_hidden``) and the KV caches are compared:

* with ``compute_dtype="float32"`` and a float32 cache in both packages,
  within atol / rtol 1e-4 (float rounding).  With the default bfloat16
  cache, a key computed about 4e-7 apart by the two frameworks can straddle
  a bfloat16 rounding midpoint and come out one bfloat16 step (0.0078 at
  1.0) apart; the flip then moves later layers by about 1e-4 (seen on the
  smollm smoke config's decode step), a jump of the rounding and not of
  the algorithm;
* with the configs' bfloat16 (and the default bfloat16 cache) within
  8e-2, the reference's own
  prefill / decode bound (``tests/test_models_smoke.py``): the port keeps
  the attention probabilities in float32 for ``P V``, where the reference
  rounds them to bfloat16 first, and the two frameworks round bfloat16
  matmuls at different places.  zamba2's caches (the mamba2 blocks' conv
  inputs and float32 states, the shared block's k/v) are held to 1.25e-1 in
  bfloat16: XLA's bfloat16 ``jax.nn.silu`` (its ``logistic``) differs from
  the correctly rounded one in 39% of values by up to one bfloat16 step, and
  each mamba2 block gates twice through it, so over the smoke model's five
  blocks the caches drift by up to 0.090 (the shared block's v at the decode
  step, on values up to 3.9; 0.086 on the last block's conv input) while
  the logits stay within 0.015.  In float32 every cache agrees within 5e-6.
  xlstm's bfloat16 caches (the mLSTM ``C``, ``n``, ``m`` and sLSTM ``c``,
  ``n``, ``h``, ``m``, float32 states fed by bfloat16 activations) are each
  held to a tenth of the leaf's largest magnitude: the sLSTM state
  accumulates over the steps (``m`` up to 26, ``n`` up to 14 on the smoke
  config), and each package's bfloat16 state lies up to 6% of that from its
  own float32 one (``n``: 0.91 of 14.4 in both; the mLSTM blocks gate
  through XLA's bfloat16 ``silu``, see above), while the two packages lie at
  most 3.8% apart (the sLSTM ``h``: 0.030 of 0.78; ``n`` 0.36 of 14.4, ``c``
  0.096 of 3.75, ``C`` 0.017 of 1.71).  The port's mLSTM prefill folds the
  prompt into ``C`` in closed form with exact float32 products, where the
  reference rounds each step's outer product ``k v^T`` to bfloat16 before
  scaling it.  In float32 every xlstm cache agrees within 2e-5 (the
  logits within 5e-6).

Parameter counts of the full configs equal the reference's, and every
config the port copied equals its reference twin field by field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro_torch import configs
from repro_torch.models import (
    Transformer,
    count_params,
    forward,
    init_cache,
    logits_from_hidden,
    params_from_jax,
)
from repro_torch.models.layers import Spec, init_params

DENSE = ["tinyllama-1.1b", "smollm-135m", "internlm2-1.8b", "gemma2-9b", "llava-next-34b",
         "musicgen-medium"]
ARCHS = DENSE + ["zamba2-1.2b", "xlstm-1.3b"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=8e-2, rtol=0)}
#: zamba2's bfloat16 caches (see the module docstring)
HYBRID_CACHE_TOL = dict(atol=1.25e-1, rtol=0)
#: xlstm's bfloat16 caches: this share of each leaf's largest |value| (see the
#: module docstring)
XLSTM_CACHE_REL = 0.1
B, S, CAPACITY = 2, 16, 32


def make_batch(cfg, seed=3):
    """``tests/test_models_smoke.py``'s batches, as numpy."""
    rng = np.random.RandomState(seed)
    if cfg.modality == "audio":
        return {"tokens": rng.randint(0, cfg.vocab, (B, cfg.num_codebooks, S))}
    if cfg.modality == "vlm":
        toks = rng.randint(0, cfg.vocab, (B, S - cfg.img_tokens))
        img = (rng.randn(B, cfg.img_tokens, cfg.d_model) * 0.02).astype(np.float32)
        return {"tokens": toks, "image_embeds": img}
    return {"tokens": rng.randint(0, cfg.vocab, (B, S))}


def split_batch(cfg, batch):
    """(prefill batch of all but the last token, the last token)."""
    toks = batch["tokens"]
    pre = dict(batch, tokens=toks[..., :-1])
    return pre, toks[..., -1:]


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def run_reference(cfg, params, batch):
    x, _, _ = ref_models.forward(params, cfg, batch, mode="train")
    train = ref_models.logits_from_hidden(params, cfg, x)
    pre, last = split_batch(cfg, batch)
    # the cache in the compute dtype (see the module docstring)
    cache = ref_models.init_cache(cfg, B, CAPACITY, dtype=jnp.dtype(cfg.compute_dtype))
    x, cache, _ = ref_models.forward(params, cfg, pre, cache=cache, cache_index=0, mode="prefill")
    prefill = ref_models.logits_from_hidden(params, cfg, x)
    x, cache_d, _ = ref_models.forward(params, cfg, {"tokens": last}, cache=cache,
                                       cache_index=S - 1, mode="decode")
    decode = ref_models.logits_from_hidden(params, cfg, x)
    as_np = lambda t: jax.tree.map(lambda a: np.asarray(a.astype(np.float32)), t)  # noqa: E731
    return {"train": np.asarray(train), "prefill": np.asarray(prefill), "decode": np.asarray(decode),
            "prefill_cache": as_np(cache), "decode_cache": as_np(cache_d)}


def run_port(cfg, model, batch):
    batch = to_torch(batch)
    x, _, _ = forward(model, batch, mode="train")
    train = logits_from_hidden(model, x)
    pre, last = split_batch(cfg, batch)
    cache = init_cache(cfg, B, CAPACITY, dtype=getattr(torch, cfg.compute_dtype), device="cpu")
    x, cache, _ = forward(model, pre, cache=cache, cache_index=0, mode="prefill")
    prefill = logits_from_hidden(model, x)
    prefill_cache = {seg: {i: {k: t.float().clone() for k, t in c.items()} for i, c in sub.items()}
                     for seg, sub in cache.items()}
    x, cache, _ = forward(model, {"tokens": last}, cache=cache, cache_index=S - 1, mode="decode")
    decode = logits_from_hidden(model, x)
    return {"train": train.numpy(), "prefill": prefill.numpy(), "decode": decode.numpy(),
            "prefill_cache": prefill_cache,
            "decode_cache": {seg: {i: {k: t.float() for k, t in c.items()} for i, c in sub.items()}
                             for seg, sub in cache.items()}}


_RUNS: dict = {}
_PARAMS: dict = {}


@pytest.fixture
def runs(request):
    """Both packages' outputs for ``(arch, dtype)``, computed once per process
    (the float32 weights once per arch: the compute dtype does not change them)."""
    arch, dtype = request.param
    if (arch, dtype) not in _RUNS:
        ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), compute_dtype=dtype)
        cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype=dtype)
        if arch not in _PARAMS:
            _PARAMS[arch] = ref_models.init_model_params(ref_cfg, jax.random.PRNGKey(1))
        params = _PARAMS[arch]
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, params)))
        batch = make_batch(cfg)
        _RUNS[arch, dtype] = (arch, dtype, run_reference(ref_cfg, params, batch),
                              run_port(cfg, model, batch))
    return _RUNS[arch, dtype]


CASES = [(a, d) for a in ARCHS for d in TOL]
IDS = [f"{a}-{d}" for a, d in CASES]


@pytest.mark.parametrize("runs", CASES, ids=IDS, indirect=True)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_logits_match_the_reference(runs, mode):
    _, dtype, ref, port = runs
    assert port[mode].dtype == np.float32 and port[mode].shape == ref[mode].shape
    assert np.isfinite(port[mode]).all()
    np.testing.assert_allclose(port[mode], ref[mode], **TOL[dtype])


@pytest.mark.parametrize("runs", CASES, ids=IDS, indirect=True)
@pytest.mark.parametrize("step", ["prefill_cache", "decode_cache"])
def test_kv_cache_matches_the_reference(runs, step):
    arch, dtype, ref, port = runs
    tol = HYBRID_CACHE_TOL if (arch, dtype) == ("zamba2-1.2b", "bfloat16") else TOL[dtype]
    assert ref[step].keys() == port[step].keys()
    for seg, sub in ref[step].items():
        for i, c in sub.items():
            for key, want in c.items():
                got = port[step][seg][i][key].numpy()
                assert got.shape == want.shape, (seg, i, key)
                if (arch, dtype) == ("xlstm-1.3b", "bfloat16"):
                    tol = dict(atol=XLSTM_CACHE_REL * float(np.abs(want).max()), rtol=0)
                np.testing.assert_allclose(got, want, **tol, err_msg=f"{seg}/{i}/{key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_counts_equal_the_reference(arch):
    n = count_params(configs.get_config(arch))
    assert n == ref_models.count_params(ref_configs.get_config(arch))
    assert Transformer(configs.get_config(arch), device="meta").state_dict().keys()
    assert sum(p.numel() for p in Transformer(configs.get_config(arch), device="meta").parameters()) == n


@pytest.mark.parametrize("arch", list(ref_configs.ARCH_IDS))
def test_copied_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ours = dataclasses.asdict(getattr(configs, get)(arch))
        theirs = dataclasses.asdict(getattr(ref_configs, get)(arch))
        assert ours == theirs, get
    assert configs.cells(arch) == ref_configs.cells(arch)


def test_init_params_follows_the_reference_std_rules():
    """Zeros for norm scales, 0.02 for embeddings, ``1/sqrt(fan_in)`` by
    default (fan-in: all dims but the last), an explicit std where given,
    and the same draws from the same seed."""
    tree = {
        "norm": Spec((64,), ("embed",), init="zeros"),
        "embed": Spec((512, 64), ("vocab", "embed"), init="embed"),
        "w": Spec((64, 8, 32), ("embed", "heads", "head_dim")),
        "deep": {"w2": Spec((256, 64), ("mlp", "embed"), std=0.5)},
    }
    params = init_params(tree, torch.Generator().manual_seed(0), "cpu")
    again = init_params(tree, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(params["w"], again["w"]) and params["w"].dtype == torch.float32
    assert not params["norm"].any()
    for got, std in ((params["embed"], 0.02), (params["w"], 1 / np.sqrt(64 * 8)),
                     (params["deep"]["w2"], 0.5)):
        assert abs(float(got.std()) / std - 1) < 0.05, (got.shape, float(got.std()), std)
