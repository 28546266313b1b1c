"""``init_model_params`` draws a stacked leaf one layer slice at a time
(``models/transformer.py::init_items``), so that ``make_sharded_init``
never draws more than one layer of a leaf.  On the CPU generator the
weights keep the bits of drawing each leaf whole, the rule before: its
normal fill works in blocks of 16 elements, and every smoke config's layer
slices hold a multiple of 16.  Each smoke config's weights are held bit for
bit to that whole-leaf rule, written out here; the weight-transfer parity
tests rest on these weights."""

import pytest
import torch

from repro_torch import configs
from repro_torch.models import init_model_params
from repro_torch.models.layers import spec_leaves
from repro_torch.models.transformer import param_specs, state_items

SEED = 6


def _whole_leaf_draws(cfg) -> dict:
    """``{module-state name: value}`` with each leaf of the reference's tree
    drawn whole (a stacked leaf in one draw), in ``spec_leaves`` order."""
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for path, s in spec_leaves(param_specs(cfg)):
        if s.init in ("zeros", "ones"):
            value = (torch.zeros if s.init == "zeros" else torch.ones)(s.shape)
        else:
            std = s.std if s.std is not None else (
                s._default_std() if s.init == "normal" else 0.02)
            value = torch.randn(s.shape, generator=gen).mul_(std)
        out.update(state_items(path, value))
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_smoke_weights_keep_the_whole_leaf_bits(arch):
    cfg = configs.get_smoke_config(arch)
    model = init_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    want = _whole_leaf_draws(cfg)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    bad = [n for n, v in want.items() if not torch.equal(got[n].detach(), v)]
    assert not bad, bad


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "zamba2-1.2b"])
def test_a_stacked_leaf_is_drawn_a_layer_at_a_time(arch):
    from torch.utils._python_dispatch import TorchDispatchMode

    draws = []

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket is torch.ops.aten.randn:
                draws.append(tuple(out.shape))
            return out

    cfg = configs.get_smoke_config(arch)
    with Mode():
        init_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    want = []
    for path, s in spec_leaves(param_specs(cfg)):
        if s.init not in ("zeros", "ones"):
            want += [tuple(s.shape[1:])] * s.shape[0] if path[0] == "stack" else [tuple(s.shape)]
    assert draws == want
