"""The port's sharding rules against the reference's, in one process.

No collective runs here: the rules only read the mesh's axis sizes.  The
reference's functions are called with a jax ``AbstractMesh`` (its
``logical_to_spec`` reads ``mesh.shape``, the axis map; ``NamedSharding``
takes an abstract mesh), the port's with the same ``{axis: size}`` map.

* ``logical_to_spec`` gives the reference's spec for every parameter and
  every cache leaf (the decode_32k cache, 128 x 32768) of all ten full-size
  configs, under ``TRAIN_RULES``, ``SERVE_RULES`` and the ``serve_fsdp``
  variant, on the (16, 16), (2, 16, 16), (32, 8), (2, 32, 8) and (2, 2)
  meshes; ``logical_to_sharding``'s placements say the same;
* ``params_logical``, ``cache_logical`` and ``abstract_params`` (shapes and
  dtypes, meta tensors) equal the reference's;
* ``_opt_shardings`` gives the reference's optimizer-state specs where the
  reference applies its rule (AdamW's m / v and Adafactor's unfactored v
  inherit the parameter's spec).  Adafactor's factored vr / vc follow the
  rule the reference's docstring states — the parameter's spec minus the
  reduced axis, then minus any axis that no longer divides — computed here
  independently: the reference's own code never applies it (it compares
  ``str(DictKey)``, ``"['vr']"``, with ``"vr"``) and replicates them;
* ``int8_compress``, ``int8_decompress`` and ``topk_mask`` give the
  reference's bits on numpy-seeded arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro import models as ref_models
from repro.models import sharding as ref_sharding
from repro.train import compression as ref_compression
from repro.train import train_loop as ref_train_loop
from repro_torch import configs
from repro_torch import models
from repro_torch.models import sharding
from repro_torch.train import compression, train_loop

ARCHS = list(configs.ARCH_IDS)
MESHES = [(16, 16), (2, 16, 16), (32, 8), (2, 32, 8), (2, 2)]
RULES = ["train", "serve", "serve_fsdp"]


def _axes(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return dict(zip(names, shape))


def _rules(pkg, which):
    if which == "train":
        return pkg.TRAIN_RULES
    if which == "serve":
        return pkg.SERVE_RULES
    return pkg.ShardingRules({**pkg.SERVE_RULES.rules, "fsdp_embed": ("pod", "data")})


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], (*path, key))
    else:
        yield path, tree


def _ref_flat(tree, is_leaf=None):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf):
        out[tuple(k.key for k in path)] = leaf
    return out


def _is_logical(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _spec_of(placements, names, ndim):
    """The reference's spec of DTensor placements (trailing Nones trimmed)."""
    spec = [None] * ndim
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            cur = spec[p.dim]
            spec[p.dim] = name if cur is None else (*(cur if isinstance(cur, tuple) else (cur,)), name)
        else:
            assert isinstance(p, Replicate)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _ref_cache(cfg):
    return jax.eval_shape(lambda: ref_models.init_cache(cfg, 128, 32768, jnp.bfloat16))


@pytest.mark.parametrize("which", RULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_to_spec_matches_the_reference(arch, which):
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    ref_rules, rules = _rules(ref_sharding, which), _rules(sharding, which)
    ref_leaves = _ref_flat(ref_models.abstract_params(ref_cfg))
    ref_logical = _ref_flat(ref_models.params_logical(ref_cfg), is_leaf=_is_logical)
    port_shapes = dict(_flat(models.abstract_params(cfg)))
    port_logical = dict(_flat(models.params_logical(cfg)))
    ref_cache = _ref_cache(ref_cfg)
    cache = models.init_cache(cfg, 128, 32768, torch.bfloat16, device="meta")
    ref_cache_leaves = _ref_flat(ref_cache)
    ref_cache_logical = _ref_flat(ref_models.cache_logical(ref_cache), is_leaf=_is_logical)
    port_cache_logical = dict(_flat(models.cache_logical(cache)))
    port_cache = dict(_flat(cache))
    cases = [(ref_leaves, ref_logical, port_shapes, port_logical),
             (ref_cache_leaves, ref_cache_logical, port_cache, port_cache_logical)]
    checked = 0
    for shape in MESHES:
        axes = _axes(shape)
        amesh = AbstractMesh(tuple(axes.values()), tuple(axes))
        for r_leaves, r_logical, p_leaves, p_logical in cases:
            assert set(r_leaves) == set(p_leaves)
            for path, leaf in r_leaves.items():
                want = tuple(ref_sharding.logical_to_spec(r_logical[path], leaf.shape, amesh,
                                                          ref_rules))
                got = sharding.logical_to_spec(p_logical[path], tuple(p_leaves[path].shape), axes,
                                               rules)
                assert got == want, (shape, path, got, want)
                placements = sharding.logical_to_sharding(p_logical[path],
                                                          tuple(p_leaves[path].shape), axes, rules)
                assert _spec_of(placements, tuple(axes), leaf.ndim) == want, (shape, path)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_trees_and_abstract_params_match_the_reference(arch):
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    ref_aps = _ref_flat(ref_models.abstract_params(ref_cfg))
    aps = dict(_flat(models.abstract_params(cfg)))
    assert set(aps) == set(ref_aps)
    for path, leaf in aps.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(ref_aps[path].shape), path
        assert str(leaf.dtype).split(".")[-1] == str(ref_aps[path].dtype), path
    ref_logical = _ref_flat(ref_models.params_logical(ref_cfg), is_leaf=_is_logical)
    assert dict(_flat(models.params_logical(cfg))) == ref_logical
    ref_cache = _ref_cache(ref_cfg)
    cache = models.init_cache(cfg, 128, 32768, torch.bfloat16, device="meta")
    assert {p: tuple(t.shape) for p, t in _flat(cache)} == {
        p: tuple(t.shape) for p, t in _ref_flat(ref_cache).items()}
    assert dict(_flat(models.cache_logical(cache))) == _ref_flat(
        ref_models.cache_logical(ref_cache), is_leaf=_is_logical)
    # the per-layer names drop the stacked leaves' "layers" axis
    named = models.named_params_logical(cfg)
    for name, logical in named.items():
        parts = name.split(".")
        if parts[0] == "stack":
            assert ref_logical[("stack", *parts[2:])] == ("layers", *logical)
        else:
            assert ref_logical[tuple(parts)] == logical


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "tinyllama-1.1b", "gemma2-9b",
                                  "deepseek-v2-lite-16b"])
def test_opt_shardings_match_the_reference(arch, optimizer):
    import dataclasses

    ref_cfg = dataclasses.replace(ref_configs.get_config(arch), optimizer=optimizer)
    cfg = dataclasses.replace(configs.get_config(arch), optimizer=optimizer)
    for shape in ((16, 16), (2, 32, 8)):
        axes = _axes(shape)
        amesh = AbstractMesh(tuple(axes.values()), tuple(axes))
        ref_aps = ref_models.abstract_params(ref_cfg)
        ref_psh = ref_sharding.tree_shardings(ref_aps, ref_models.params_logical(ref_cfg), amesh,
                                              ref_sharding.TRAIN_RULES)
        ref_opt = ref_train_loop.make_optimizer_for(ref_cfg, ref_train_loop.TrainConfig())
        ref_abs = jax.eval_shape(ref_opt.init, ref_aps)
        want = {p: tuple(s.spec) for p, s in _ref_flat(ref_train_loop._opt_shardings(
            ref_abs, ref_psh)).items()}
        want = {p: s[:len(s) - next((i for i, e in enumerate(reversed(s)) if e is not None),
                                    len(s))] for p, s in want.items()}
        psh = sharding.tree_shardings(models.abstract_params(cfg), models.params_logical(cfg),
                                      axes, sharding.TRAIN_RULES)
        opt = train_loop.make_optimizer_for(cfg, train_loop.TrainConfig())
        opt_abs = opt.init(dict(models.Transformer(cfg, device="meta").named_parameters()))
        got = train_loop._opt_shardings(opt_abs, psh, axes)
        shapes = dict(_flat(opt_abs))
        got = {p: _spec_of(pl, tuple(axes), shapes[p].dim()) for p, pl in _flat(got)}
        assert set(got) == set(want)
        param_specs = {p: tuple(s.spec) for p, s in _ref_flat(ref_psh).items()}
        factored = 0
        for path, spec in got.items():
            if path[-1] not in ("vr", "vc"):
                assert spec == want[path], (shape, path)
                continue
            assert want[path] == ()  # the reference's replicated vr / vc
            pspec = list(param_specs[path[1:-1]])
            pspec += [None] * (shapes[path].dim() + 1 - len(pspec))
            del pspec[-1 if path[-1] == "vr" else -2]
            rule = [ax if dim % int(np.prod([axes[a] for a in ((ax,) if isinstance(ax, str)
                                                                   else (ax or ()))])) == 0
                    else None for dim, ax in zip(shapes[path].shape, pspec)]
            while rule and rule[-1] is None:
                rule.pop()
            assert spec == tuple(rule), (shape, path)
            factored += bool(spec)
        if optimizer == "adafactor":
            assert factored > 0  # some factored state stays sharded


@pytest.mark.parametrize("shape,seed", [((3,), 0), ((17, 5), 1), ((4, 33, 7), 2), ((1000,), 3)])
def test_int8_codec_and_topk_give_the_reference_bits(shape, seed):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32) * (seed + 0.5)
    ref_q, ref_s = ref_compression.int8_compress(jnp.asarray(x))
    q, s = compression.int8_compress(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    assert np.float32(s.item()).tobytes() == np.asarray(ref_s, np.float32).tobytes()
    back = compression.int8_decompress(q, s).numpy()
    np.testing.assert_array_equal(back, np.asarray(ref_compression.int8_decompress(ref_q, ref_s)))
    for frac in (0.01, 0.1, 0.5):
        got = compression.topk_mask(torch.from_numpy(x), frac).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref_compression.topk_mask(jnp.asarray(x),
                                                                                frac)))
