"""The port's checkpoints: the reference's tests (``tests/test_checkpoint.py``)
as twins, and files crossing between the two packages.

The format is the reference's (``.npz`` + a JSON manifest keyed by
``jax.tree_util.keystr`` paths), so a parameter tree that the reference
saves restores into the port (dense, zamba2 and xlstm smoke configs), one
the port saves restores into the reference, and ``repro_torch.launch.serve
--checkpoint`` on it gives the same greedy tokens as ``repro.launch.serve``
reading the same file (float32 compute in both, as
``tests/test_torch_serve.py`` holds the engines).
"""

import dataclasses
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs_pkg
import repro.launch.serve as ref_launch_serve
import repro.serve as ref_serve
from repro import models as ref_models
from repro import train as ref_train
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Transformer, init_model_params, params_tree
from repro_torch.models.transformer import state_items
from repro_torch.train import (
    CheckpointManager,
    SyntheticLM,
    TrainConfig,
    Trainer,
    restore_pytree,
    save_pytree,
)


def test_roundtrip_pytree(tmp_path):
    tree = {
        "a": torch.arange(12.0).reshape(3, 4),
        "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16),
                   "c": torch.tensor(7, dtype=torch.int32)},
    }
    path = str(tmp_path / "ck.ckpt")
    save_pytree(path, tree, step=42)
    target = {"a": torch.empty(3, 4), "nested": {"b": torch.empty(2, 2, dtype=torch.bfloat16),
                                                 "c": torch.empty((), dtype=torch.int32)}}
    step, restored = restore_pytree(path, target)
    assert step == 42
    for key in ("a",):
        assert torch.equal(restored[key], tree[key])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    assert int(restored["nested"]["c"]) == 7


def test_manager_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, {"x": torch.full((4,), float(step))}, blocking=True)
    assert mgr.all_steps() == [20, 30]
    step, tree = mgr.restore_latest({"x": torch.empty(4)})
    assert step == 30
    assert float(tree["x"][0]) == 30.0


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.zeros((128, 128))
    mgr.save(1, {"x": x})
    x.fill_(5.0)  # the save took a snapshot first
    mgr.wait()
    assert mgr.all_steps() == [1]
    _, tree = mgr.restore_latest({"x": torch.empty(128, 128)})
    assert float(tree["x"].abs().max()) == 0.0


def test_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck.ckpt")
    save_pytree(path, {"x": torch.zeros(4)}, 0)
    with pytest.raises(ValueError):
        restore_pytree(path, {"x": torch.empty(5)})
    with pytest.raises(KeyError):
        restore_pytree(path, {"y": torch.empty(4)})


def test_trainer_resume_continues_step_count(tmp_path):
    cfg = configs.get_smoke_config("smollm-135m")
    data = SyntheticLM(cfg, batch=2, seq=32, seed=0)
    t1 = Trainer(cfg, TrainConfig(total_steps=6, checkpoint_every=3, eval_every=2), data,
                 workdir=str(tmp_path), device="cpu")
    t1.run()
    mgr = CheckpointManager(str(tmp_path))
    assert 6 in mgr.all_steps()
    # second trainer resumes from 6 and continues to 10
    t2 = Trainer(cfg, TrainConfig(total_steps=10, checkpoint_every=3, eval_every=2),
                 SyntheticLM(cfg, batch=2, seq=32, seed=0), workdir=str(tmp_path), device="cpu")
    res = t2.run()
    assert res["step"] == 10
    assert len(res["losses"]) == 2  # steps 8 and 10: it did not start again from 0
    assert mgr.all_steps() == [3, 6, 9]  # the resumed run went on checkpointing every 3


def test_sigterm_checkpoints_and_the_resumed_run_continues_exactly(tmp_path):
    """SIGTERM during a run checkpoints (params and optimizer state) and
    stops; a new Trainer resumes there, and its losses equal those of one
    uninterrupted run."""
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    tcfg = TrainConfig(total_steps=8, checkpoint_every=100, eval_every=2, warmup_steps=2,
                       lr=1e-2)
    whole = Trainer(cfg, tcfg, SyntheticLM(cfg, batch=2, seq=16), device="cpu").run()

    def stop_at_4(step, loss):
        if step == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return False

    previous = signal.getsignal(signal.SIGTERM)
    try:
        cut = Trainer(cfg, tcfg, SyntheticLM(cfg, batch=2, seq=16), workdir=str(tmp_path),
                      report_fn=stop_at_4, device="cpu").run()
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert cut["preempted"] and cut["step"] == 4
    assert CheckpointManager(str(tmp_path)).all_steps() == [4]
    rest = Trainer(cfg, tcfg, SyntheticLM(cfg, batch=2, seq=16), workdir=str(tmp_path),
                   device="cpu").run()
    assert rest["losses"] == whole["losses"][2:]
    for name, p in whole["model"].named_parameters():
        assert torch.equal(p, rest["model"].get_parameter(name)), name


def test_trainer_checkpoint_has_the_reference_keys(tmp_path):
    """A Trainer's (params, AdamW state) checkpoint restores into the
    reference's own tree structure (keys and shapes)."""
    cfg = configs.get_smoke_config("gemma2-9b")
    Trainer(cfg, TrainConfig(total_steps=2, checkpoint_every=2, eval_every=1),
            SyntheticLM(cfg, batch=2, seq=16), workdir=str(tmp_path), device="cpu").run()
    ref_cfg = ref_configs_pkg.get_smoke_config("gemma2-9b")
    ref_params = ref_models.init_model_params(ref_cfg, jax.random.PRNGKey(0))
    ref_opt = ref_train.adamw(ref_train.constant_schedule(1e-3))
    target = jax.eval_shape(lambda: (ref_params, ref_opt.init(ref_params)))
    step, (params, state) = ref_train.CheckpointManager(str(tmp_path)).restore_latest(target)
    assert step == 2
    assert set(state) == {"m", "v"}
    assert float(jnp.abs(state["v"]["stack"]["0"]["attn"]["wq"]).max()) > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-9b", "zamba2-1.2b", "xlstm-1.3b"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, arch):
    ref_cfg = ref_configs_pkg.get_smoke_config(arch)
    params = ref_models.init_model_params(ref_cfg, jax.random.PRNGKey(5))
    path = str(tmp_path / "params.ckpt")
    ref_train.save_pytree(path, params)
    model = Transformer(configs.get_smoke_config(arch), device="cpu")
    step, tree = restore_pytree(path, params_tree(model))
    assert step == 0
    flat = dict(model.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    for keys, leaf in leaves:
        path_ = tuple(k.key for k in keys)
        node = tree
        for key in path_:
            node = node[key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert len(leaves) == len(list(jax.tree.leaves(params)))
    assert len({name for keys, leaf in leaves
                for name, _ in state_items(tuple(k.key for k in keys), np.asarray(leaf))}) == len(flat)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    cfg = configs.get_smoke_config("smollm-135m")
    model = init_model_params(cfg, torch.Generator().manual_seed(3), "cpu")
    path = str(tmp_path / "params.ckpt")
    save_pytree(path, params_tree(model), step=7)
    ref_cfg = ref_configs_pkg.get_smoke_config("smollm-135m")
    step, params = ref_train.restore_pytree(path, ref_models.abstract_params(ref_cfg))
    assert step == 7
    np.testing.assert_array_equal(np.asarray(params["embed"]), model.embed.detach().numpy())
    np.testing.assert_array_equal(np.asarray(params["stack"]["0"]["attn"]["wo"][1]),
                                  model.stack[1]["0"].attn.wo.detach().numpy())


def test_port_zamba2_checkpoint_restores_into_the_reference(tmp_path):
    """The shared block, the stacked mamba2 leaves and the tail blocks cross
    to the reference's tree exactly."""
    cfg = configs.get_smoke_config("zamba2-1.2b")
    model = init_model_params(cfg, torch.Generator().manual_seed(4), "cpu")
    path = str(tmp_path / "params.ckpt")
    save_pytree(path, params_tree(model), step=3)
    ref_cfg = ref_configs_pkg.get_smoke_config("zamba2-1.2b")
    step, params = ref_train.restore_pytree(path, ref_models.abstract_params(ref_cfg))
    assert step == 3
    named = dict(model.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    seen = set()
    for keys, leaf in leaves:
        for name, part in state_items(tuple(k.key for k in keys), np.asarray(leaf)):
            np.testing.assert_array_equal(part, named[name].detach().numpy(), err_msg=name)
            seen.add(name)
    assert seen == set(named)
    assert {"shared.attn.wq", "stack.1.0.A_log", "tail.0.conv_w"} <= seen


def test_port_xlstm_checkpoint_restores_into_the_reference(tmp_path):
    """The stacked mLSTM and sLSTM leaves (``wq`` / ``wk`` ``[n, H, D, D]``,
    ``r_zifo`` ``[n, 4, H, D, D]``) cross to the reference's tree exactly."""
    cfg = configs.get_smoke_config("xlstm-1.3b")
    model = init_model_params(cfg, torch.Generator().manual_seed(6), "cpu")
    path = str(tmp_path / "params.ckpt")
    save_pytree(path, params_tree(model), step=5)
    ref_cfg = ref_configs_pkg.get_smoke_config("xlstm-1.3b")
    step, params = ref_train.restore_pytree(path, ref_models.abstract_params(ref_cfg))
    assert step == 5
    assert params["stack"]["1"]["r_zifo"].shape == (cfg.n_superblocks, 4, 2, 32, 32)
    named = dict(model.named_parameters())
    seen = set()
    for keys, leaf in jax.tree_util.tree_leaves_with_path(params):
        for name, part in state_items(tuple(k.key for k in keys), np.asarray(leaf)):
            np.testing.assert_array_equal(part, named[name].detach().numpy(), err_msg=name)
            seen.add(name)
    assert seen == set(named)
    assert {"stack.1.0.wq", "stack.0.1.r_zifo", "stack.1.1.b_zifo"} <= seen


@pytest.fixture
def float32_smoke_configs(monkeypatch):
    """Both packages' launchers load their smoke configs in float32 compute."""
    import repro_torch.configs as port_configs_pkg

    for pkg in (ref_configs_pkg, port_configs_pkg):
        real = pkg.get_smoke_config
        monkeypatch.setattr(pkg, "get_smoke_config",
                            lambda arch, real=real: dataclasses.replace(real(arch),
                                                                        compute_dtype="float32"))


def test_serve_checkpoint_gives_the_reference_launchers_tokens(tmp_path, monkeypatch,
                                                               float32_smoke_configs):
    ref_cfg = ref_configs_pkg.get_smoke_config("tinyllama-1.1b")
    params = ref_models.init_model_params(ref_cfg, jax.random.PRNGKey(8))
    path = str(tmp_path / "params.ckpt")
    ref_train.save_pytree(path, params)
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--checkpoint", path, "--requests", "5",
            "--max-new", "8"]

    want = []
    real_generate = ref_serve.Engine.generate

    def recording(self, prompts, max_new=16):
        out = real_generate(self, prompts, max_new)
        want.append([[int(t) for t in row] for row in out])
        return out

    monkeypatch.setattr(ref_serve.Engine, "generate", recording)
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    ref_launch_serve.main()
    got = launch_serve.main([*argv, "--device", "cpu"])
    assert len(want) == 1 and got["outputs"] == want[0]
    assert [len(o) for o in got["outputs"]] == [8] * 5
