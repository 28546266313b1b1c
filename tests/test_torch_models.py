"""The port's dense, Mamba2 hybrid (zamba2), xLSTM (xlstm) and MLA / MoE
(deepseek-v2-lite, qwen3-moe) models against the reference on the CPU.

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
* The MoE configs in bfloat16: the router picks its top-k experts from
  float32 probabilities of the bfloat16 activations, which differ between
  the packages by a bfloat16 step here and there; at a near-tie the k-th
  and (k+1)-th expert then swap.  On the deepseek smoke config the second
  choice of one token (batch 1, position 12) flips in the first MoE layer,
  where its k-th and (k+1)-th probabilities lie 0.0012 apart in the
  reference and 0.0004 in the port; that row's logits then lie 0.62 apart
  in train and prefill (max |logit| 4.3).  On qwen3-moe's, one prefill
  token (batch 0, position 6; margins 0.00006 and 0.0007) flips in the
  last MoE layer (0.42 apart) and, through the expert's changed buffer
  count in the einsum group, another token of the group (batch 1, position
  10) is dropped in one package and kept in the other (0.61 apart).  A
  flip is a property of bfloat16, not of the port, so these two configs
  are held in bfloat16 to a rule that follows each flip
  (``follow_flips``, from both packages' recorded router choices): every
  token whose experts differ where nothing upstream had moved it must be
  a near-tie in both packages (margin under FLIP_MARGIN); every row past
  8e-2 must be one such a flip can move (the flipped token, the later
  positions of its batch row, or a token of its dispatch group that chose
  an expert the flip added or left, where that expert's buffer overflows);
  and no row may lie further apart than FLIP_REL of the largest |value|.
  In float32 (and at the decode step in bfloat16) both hold the plain
  1e-4 / 8e-2 bounds.

Parameter counts of the full configs equal the reference's, and every
config the port copied equals its reference twin field by field.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.models import (
    Transformer,
    count_params,
    forward,
    init_cache,
    logits_from_hidden,
    params_from_jax,
)
from repro_torch.models import moe
from repro_torch.models.layers import Spec, init_params

DENSE = ["tinyllama-1.1b", "smollm-135m", "internlm2-1.8b", "gemma2-9b", "llava-next-34b",
         "musicgen-medium"]
MOE = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
ARCHS = DENSE + ["zamba2-1.2b", "xlstm-1.3b"] + MOE
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=8e-2, rtol=0)}
#: zamba2's bfloat16 caches (see the module docstring)
HYBRID_CACHE_TOL = dict(atol=1.25e-1, rtol=0)
#: xlstm's bfloat16 caches: this share of each leaf's largest |value| (see the
#: module docstring)
XLSTM_CACHE_REL = 0.1
#: the MoE configs' bfloat16 routing flips (see the module docstring): a
#: near-tie is a token whose k-th and (k+1)-th router probabilities lie
#: within FLIP_MARGIN, and a row a flip moves is held to FLIP_REL x the
#: largest |value| of the compared tensor
FLIP_MARGIN, FLIP_REL = 2e-3, 0.25
B, S, CAPACITY = 2, 16, 32
MODES = ("train", "prefill", "decode")


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
    choices = {mode: [] for mode in MODES}
    with ref_router_choices(choices["train"]):
        x, _, _ = ref_models.forward(params, cfg, batch, mode="train")
    train = ref_models.logits_from_hidden(params, cfg, x)
    pre, last = split_batch(cfg, batch)
    # the cache in the compute dtype (see the module docstring)
    cache = ref_models.init_cache(cfg, B, CAPACITY, dtype=jnp.dtype(cfg.compute_dtype))
    with ref_router_choices(choices["prefill"]):
        x, cache, _ = ref_models.forward(params, cfg, pre, cache=cache, cache_index=0,
                                         mode="prefill")
    prefill = ref_models.logits_from_hidden(params, cfg, x)
    with ref_router_choices(choices["decode"]):
        x, cache_d, _ = ref_models.forward(params, cfg, {"tokens": last}, cache=cache,
                                           cache_index=S - 1, mode="decode")
    decode = ref_models.logits_from_hidden(params, cfg, x)
    as_np = lambda t: jax.tree.map(lambda a: np.asarray(a.astype(np.float32)), t)  # noqa: E731
    return {"train": np.asarray(train), "prefill": np.asarray(prefill), "decode": np.asarray(decode),
            "prefill_cache": as_np(cache), "decode_cache": as_np(cache_d), "choices": choices}


@contextlib.contextmanager
def ref_router_choices(out: list):
    """Appends each of the reference's MoE router calls, in layer order, to
    ``out`` as (the per-token margin between the k-th and (k+1)-th
    probability [T], the chosen experts [T, k]), through an ordered debug
    callback inside its layer scan."""
    real = ref_moe._router

    def recording(p, x, cfg):
        w, idx, aux = real(p, x, cfg)
        k = cfg.moe_top_k
        logits = jnp.einsum("td,de->te", x.astype(jnp.float32), p["router"].astype(jnp.float32))
        top = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k + 1)[0]
        jax.debug.callback(lambda m, i: out.append((np.asarray(m), np.asarray(i))),
                           top[:, k - 1] - top[:, k], idx, ordered=True)
        return w, idx, aux

    ref_moe._router = recording
    try:
        yield
        jax.effects_barrier()
    finally:
        ref_moe._router = real


@contextlib.contextmanager
def router_choices(out: list):
    """The port's twin of :func:`ref_router_choices`."""
    real = moe.top_k

    def recording(probs, k):
        top = torch.sort(probs, dim=-1, descending=True).values
        values, idx = real(probs, k)
        out.append(((top[..., k - 1] - top[..., k]).numpy(), idx.numpy()))
        return values, idx

    moe.top_k = recording
    try:
        yield
    finally:
        moe.top_k = real


def run_port(cfg, model, batch):
    batch = to_torch(batch)
    choices = {mode: [] for mode in MODES}
    with router_choices(choices["train"]):
        x, _, _ = forward(model, batch, mode="train")
    train = logits_from_hidden(model, x)
    pre, last = split_batch(cfg, batch)
    cache = init_cache(cfg, B, CAPACITY, dtype=getattr(torch, cfg.compute_dtype), device="cpu")
    with router_choices(choices["prefill"]):
        x, cache, _ = forward(model, pre, cache=cache, cache_index=0, mode="prefill")
    prefill = logits_from_hidden(model, x)
    prefill_cache = {seg: {i: {k: t.float().clone() for k, t in c.items()} for i, c in sub.items()}
                     for seg, sub in cache.items()}
    with router_choices(choices["decode"]):
        x, cache, _ = forward(model, {"tokens": last}, cache=cache, cache_index=S - 1,
                              mode="decode")
    decode = logits_from_hidden(model, x)
    return {"train": train.numpy(), "prefill": prefill.numpy(), "decode": decode.numpy(),
            "prefill_cache": prefill_cache,
            "decode_cache": {seg: {i: {k: t.float() for k, t in c.items()} for i, c in sub.items()}
                             for seg, sub in cache.items()},
            "choices": choices}


def follow_flips(cfg, port_calls, ref_calls, rows: int, upstream=None):
    """Follows one forward's routing flips through its MoE layers.

    Returns ``(flips, moved)``.  ``flips``: every token whose chosen experts
    differ between the packages at a layer where no earlier flip could have
    moved it, as ``(layer, batch, position, port margin, reference
    margin)``.  ``moved`` [B, rows]: the rows a flip can move, namely each
    token whose experts differ (a flip or a moved token's), the later
    positions of a moved token's batch row (the next layer's causal
    attention), and, in the dispatch group of a token whose experts differ,
    the tokens that chose an expert it added or left where that expert's
    buffer overflows its capacity in either package (who is dropped
    changes).  ``upstream`` [B]: batch rows whose earlier call moved (the
    decode step attends to the prefill's cache)."""
    assert len(port_calls) == len(ref_calls)
    T = B * rows
    if not port_calls:
        return [], np.zeros((B, rows), bool)
    Sg = T if cfg.moe_dispatch == "sort" else moe.group_size(T, cfg)
    C = moe._capacity(Sg, cfg)
    row, pos = np.divmod(np.arange(T), rows)
    moved = np.zeros(T, bool) if upstream is None else np.repeat(upstream, rows)
    flips = []
    for layer, ((p_margin, p_idx), (r_margin, r_idx)) in enumerate(zip(port_calls, ref_calls)):
        for t in np.flatnonzero(moved):  # this layer's attention
            moved |= (row == row[t]) & (pos >= pos[t])
        differ = np.flatnonzero((np.sort(p_idx, -1) != np.sort(r_idx, -1)).any(-1))
        flips += [(layer, int(row[t]), int(pos[t]), float(p_margin[t]), float(r_margin[t]))
                  for t in differ if not moved[t]]
        for t in differ:
            g = slice(t // Sg * Sg, (t // Sg + 1) * Sg)
            for e in set(p_idx[t].tolist()) ^ set(r_idx[t].tolist()):
                if max((p_idx[g] == e).sum(), (r_idx[g] == e).sum()) > C:
                    moved[g] |= (p_idx[g] == e).any(-1) | (r_idx[g] == e).any(-1)
        moved[differ] = True
    return flips, moved.reshape(B, rows)


def assert_close_but_routing_flips(row_diff, largest, flips, moved, err_msg=""):
    """The MoE configs' bfloat16 rule (see the module docstring).
    ``row_diff``: the largest |difference| of each (batch, position) row;
    ``flips`` and ``moved``: :func:`follow_flips` of the calls that made
    those rows."""
    for layer, b, p, port_margin, ref_margin in flips:
        assert port_margin < FLIP_MARGIN and ref_margin < FLIP_MARGIN, (
            err_msg, "a flip away from a near-tie", layer, b, p, port_margin, ref_margin)
    far = row_diff > TOL["bfloat16"]["atol"]
    assert not (far & ~moved).any(), (err_msg, np.argwhere(far & ~moved).tolist(), flips)
    assert row_diff.max() <= FLIP_REL * largest, (err_msg, row_diff.max(), largest)


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
        ref, port = run_reference(ref_cfg, params, batch), run_port(cfg, model, batch)
        rows = {"train": S, "prefill": S - 1, "decode": 1}
        routing = {}
        for mode in MODES:
            upstream = routing["prefill"][1].any(-1) if mode == "decode" else None
            routing[mode] = follow_flips(cfg, port["choices"][mode], ref["choices"][mode],
                                         rows[mode], upstream)
        port["routing"] = routing
        _RUNS[arch, dtype] = (arch, dtype, ref, port)
    return _RUNS[arch, dtype]


CASES = [(a, d) for a in ARCHS for d in TOL]
IDS = [f"{a}-{d}" for a, d in CASES]


@pytest.mark.parametrize("runs", CASES, ids=IDS, indirect=True)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_logits_match_the_reference(runs, mode):
    arch, dtype, ref, port = runs
    assert port[mode].dtype == np.float32 and port[mode].shape == ref[mode].shape
    assert np.isfinite(port[mode]).all()
    if arch in MOE and dtype == "bfloat16":
        diff = np.abs(port[mode] - ref[mode])
        assert_close_but_routing_flips(diff.reshape(B, diff.shape[1], -1).max(-1),
                                       float(np.abs(ref[mode]).max()), *port["routing"][mode],
                                       mode)
        return
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
                if arch in MOE and dtype == "bfloat16":
                    # rows (batch, position), over the stacked layers and the row's width
                    diff = np.abs(got - want)
                    if seg == "stack":
                        diff = diff.max(0)
                    # the prefill wrote positions 0 .. S - 2, the decode step S - 1
                    flips, moved = port["routing"]["prefill"]
                    if step == "decode_cache":
                        flips = flips + port["routing"]["decode"][0]
                        moved = np.concatenate([moved, port["routing"]["decode"][1]], 1)
                    moved = np.pad(moved, ((0, 0), (0, CAPACITY - moved.shape[1])))
                    assert_close_but_routing_flips(
                        diff.reshape(B, CAPACITY, -1).max(-1), float(np.abs(want).max()),
                        flips, moved, f"{seg}/{i}/{key}")
                    continue
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
