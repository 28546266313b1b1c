"""The port's train steps against the reference's on the CPU.

From the same weights (``params_from_jax``) with the optimizer state at
zero in both packages, ``make_train_step`` runs on the same ``SyntheticLM``
batches in float32 compute: 5 AdamW steps, 3 Adafactor steps, 3 SGD steps
and 3 AdamW steps with ``microbatch=2``, the optimizers built as
``make_optimizer_for`` builds them (warmup + cosine, clipping, weight
decay) but for AdamW's ``eps``, 1e-4 here against the default 1e-8;
deepseek-v2-lite (MLA, MoE) with AdamW and qwen3-moe (GQA, MoE) with its
config's Adafactor and microbatches.  With
1e-8 an entry whose gradient is near zero (|g| about 1e-7, the size of the
two frameworks' float32 disagreement) takes a normalized step of either
sign: 6 of 16384 embedding entries ended 1e-3 apart after 5 steps at lr
1e-2, while the other entries agreed to 1e-6.  With 1e-4 that
amplification stays below 1e-3 of a step.  One more case runs AdamW as
shipped (eps 1e-8) and names those near-zero-gradient entries.

Each step's loss must agree within rtol 1e-5 (a float32 mean over 128
tokens, the parameters a few float32 updates apart), every parameter after
the last step within atol 1e-5, and the optimizer state (the reference's
tree, stacked leaves and all) within atol 1e-5 / rtol 1e-3.  xlstm's
parameters are held within atol 2e-4, 2% of the largest step AdamW takes
at lr 1e-2: its gradients are an order of magnitude noisier in float32 (the
embedding's reach 3.9; at step 0 the two packages' lie 2.4e-5 apart, and
the reference's own float32 gradient lies 1.4e-5 from its float64 one), and
AdamW normalizes that noise in entries whose gradient is near eps; after 3
steps the embedding was up to 1.5e-4 apart, every other leaf within 2.8e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro import train as ref_train
from repro.train.train_loop import make_optimizer_for as ref_make_optimizer_for
from repro_torch import configs
from repro_torch.models import Transformer, params_from_jax
from repro_torch.models.transformer import state_items
from repro_torch.train import SyntheticLM, TrainConfig, adamw, make_train_step, warmup_cosine
from repro_torch.train.train_loop import make_optimizer_for

B, S = 4, 32
TCFG = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1)
#: xlstm's parameters after the steps (see the module docstring)
XLSTM_PARAM_ATOL = 2e-4


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], (*path, key))
    else:
        yield path, tree


def _run_both(arch, optimizer, steps, microbatch=0, eps=1e-4):
    over = dict(compute_dtype="float32", optimizer=optimizer)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    ref_tcfg = ref_train.TrainConfig(microbatch=microbatch, **TCFG)
    tcfg = TrainConfig(microbatch=microbatch, **TCFG)

    params = ref_models.init_model_params(ref_cfg, jax.random.PRNGKey(6))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, params)))

    ref_opt = ref_make_optimizer_for(ref_cfg, ref_tcfg)
    opt = make_optimizer_for(cfg, tcfg)
    if optimizer == "adamw" and eps is not None:
        kw = dict(b1=tcfg.b1, b2=tcfg.b2, eps=eps, weight_decay=tcfg.weight_decay,
                  clip_norm=tcfg.clip_norm)
        ref_opt = ref_train.adamw(ref_train.warmup_cosine(tcfg.lr, tcfg.warmup_steps,
                                                          tcfg.total_steps), **kw)
        opt = adamw(warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps), **kw)
    ref_state = ref_opt.init(params)
    ref_step = jax.jit(ref_train.make_train_step(ref_cfg, ref_opt, microbatch))
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, opt, microbatch)

    data = SyntheticLM(cfg, batch=B, seq=S, seed=3)
    ref_data = ref_train.SyntheticLM(ref_cfg, batch=B, seq=S, seed=3)
    losses = []
    grad_rms = None  # per entry, the least over steps of AdamW's sqrt(v_hat)
    for step in range(steps):
        params, ref_state, ref_metrics = ref_step(params, ref_state, jax.numpy.int32(step),
                                                  ref_data.next_batch())
        model, state, metrics = step_fn(model, state, step, data.next_batch())
        losses.append((float(metrics["loss"]), float(ref_metrics["loss"])))
        if optimizer == "adamw":
            c2 = 1.0 - tcfg.b2 ** (step + 1)
            rms = {path: np.sqrt(np.asarray(v) / c2) for path, v in _flat(ref_state["v"])}
            grad_rms = rms if grad_rms is None else {
                path: np.minimum(grad_rms[path], r) for path, r in rms.items()}
    return model, state, params, ref_state, losses, grad_rms


@pytest.mark.parametrize(
    "arch,optimizer,steps,microbatch",
    [("smollm-135m", "adamw", 5, 0), ("gemma2-9b", "adamw", 5, 0),
     ("smollm-135m", "adafactor", 3, 0), ("smollm-135m", "sgd", 3, 0),
     ("musicgen-medium", "adamw", 3, 2), ("zamba2-1.2b", "adamw", 3, 2),
     ("xlstm-1.3b", "adamw", 3, 2), ("deepseek-v2-lite-16b", "adamw", 3, 0),
     ("qwen3-moe-235b-a22b", "adafactor", 3, 2)],
)
def test_train_steps_match_the_reference(arch, optimizer, steps, microbatch):
    model, state, params, ref_state, losses, _ = _run_both(arch, optimizer, steps, microbatch)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    named = dict(model.named_parameters())
    atol = XLSTM_PARAM_ATOL if arch == "xlstm-1.3b" else 1e-5
    for path, leaf in _flat(params):
        for name, part in state_items(path, np.asarray(leaf)):
            np.testing.assert_allclose(named[name].detach().numpy(), part, atol=atol,
                                       err_msg=name)
    got_state = dict(_flat(state))
    want_state = dict(_flat(ref_state))
    assert sorted(got_state) == sorted(want_state)
    for path, want in want_state.items():
        got = got_state[path]
        assert tuple(got.shape) == tuple(want.shape), path
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-3,
                                   err_msg=str(path))


def test_optimizer_refuses_non_float32_parameters():
    opt = make_optimizer_for(configs.get_smoke_config("smollm-135m"), TrainConfig())
    with pytest.raises(TypeError):
        opt.init({"embed": torch.zeros(4, 4, dtype=torch.bfloat16)})


def test_default_adamw_matches_the_reference():
    """AdamW as ``make_optimizer_for`` ships it (eps 1e-8), 5 steps.

    Each step's loss within rtol 1e-5.  An entry whose root-mean-square
    gradient (AdamW's own ``sqrt(v_hat)``) fell below 1e-7 at some step,
    the size of the frameworks' float32 disagreement, takes a normalized
    step whose sign follows that disagreement.  Those entries (at most a
    thousandth of all) are named and held only to the most that 5 such
    steps can move them; every other entry within atol 1e-5.
    """
    model, _, params, _, losses, grad_rms = _run_both("smollm-135m", "adamw", 5, eps=None)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    tcfg = TrainConfig(**TCFG)
    # |m_hat / sqrt(v_hat)| <= (1 - b1) / sqrt(1 - b2) * sqrt(c2) / c1 per step; 2x for
    # the two frameworks, plus the weight decay's own term.
    sched = warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    most = sum(2 * float(sched(t)) * ((1 - tcfg.b1) / np.sqrt(1 - tcfg.b2)
                                      * np.sqrt(1 - tcfg.b2 ** (t + 1))
                                      / (1 - tcfg.b1 ** (t + 1)) + tcfg.weight_decay)
               for t in range(5))
    named = dict(model.named_parameters())
    n_near_zero = n_entries = 0
    for path, leaf in _flat(params):
        for (name, want), (_, rms) in zip(state_items(path, np.asarray(leaf)),
                                          state_items(path, grad_rms[path])):
            got = named[name].detach().numpy()
            near_zero = rms < 1e-7
            n_near_zero += int(near_zero.sum())
            n_entries += near_zero.size
            np.testing.assert_allclose(got[~near_zero], want[~near_zero], atol=1e-5,
                                       err_msg=name)
            assert np.all(np.abs(got - want)[near_zero] <= most), name
    assert n_near_zero <= 1e-3 * n_entries, (n_near_zero, n_entries)
