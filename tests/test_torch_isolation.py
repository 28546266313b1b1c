"""The port stands alone and never falls back.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of ``repro`` (AST scan), and the port runs a study in
  a process where both are blocked.
* Without a CUDA device every engine but ``"numpy"`` raises unless the
  caller passes ``device="cpu"``; ``engine="cuda"`` never runs on the CPU.
* The sampling and serving paths hold no broad ``except`` that could hide a
  device error; the storage modules, whose server and client map a failed
  call to a typed error on the client as the reference's do, import no
  ``torch``, so no device code runs inside those handlers.
* The storage URLs resolve to their backends and ``get_observation_block``
  returns the reference's columns; the xlstm and the MLA / MoE families
  build and run.  These cases keep the names and ids they had when they
  held the storage backends and those configs to ``NotImplementedError``.
* A default serving ``Engine``, ``Trainer``, train launcher and tune
  objective need a CUDA device unless the caller passes ``device="cpu"``.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as hpo
from repro_torch import configs
from repro_torch.core.pruners import pruner_from_spec
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Transformer, init_model_params, loss_fn, params_tree
from repro_torch.models import attention as attn
from repro_torch.serve import Engine
from repro_torch.train import SyntheticLM, TrainConfig, Trainer, save_pytree
from repro_torch.tune import LMTuneSpec, make_lm_objective

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_runs_with_jax_and_reference_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.core as hpo

        mo = hpo.create_study(
            directions=["minimize"] * 5,
            sampler=hpo.TPESampler(seed=0, multi_objective=True, engine="torch", device="cpu"),
        )
        mo.optimize(lambda t: [t.suggest_float(f"x{i}", 0, 1) + i for i in range(5)],
                    n_trials=14)
        assert len(mo.best_trials) >= 1

        study = hpo.create_study(
            sampler=hpo.TPESampler(seed=0, engine="torch", device="cpu"),
            pruner=hpo.MedianPruner(),
        )
        def objective(t):
            x = t.suggest_float("x", -3, 3)
            for step in range(3):
                t.report(x * x + 1.0 / (step + 1), step)
                if t.should_prune():
                    raise hpo.TrialPruned()
            return x * x
        study.optimize(objective, n_trials=20, ask_batch=4)
        assert len(study.trials) == 20
        assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
                       if sys.modules[m] is not None)
        print("ok", study.best_value)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("engine", ["auto", "torch", "cuda"])
def test_device_engines_need_cuda_or_an_explicit_cpu(no_cuda, engine):
    with pytest.raises(RuntimeError, match="CUDA"):
        hpo.TPESampler(engine=engine)
    if engine == "cuda":
        with pytest.raises(RuntimeError):
            hpo.TPESampler(engine="cuda", device="cpu")
    else:
        assert hpo.TPESampler(engine=engine, device="cpu")._device == torch.device("cpu")


def test_default_study_needs_cuda_or_an_explicit_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        hpo.create_study()
    with pytest.raises(RuntimeError, match="CUDA"):
        hpo.create_study(engine="cuda")
    assert hpo.create_study(device="cpu").sampler._device == torch.device("cpu")
    hpo.create_study(engine="numpy")  # the host path needs no device


def test_resolve_device(no_cuda):
    assert ops.resolve_device("numpy") == torch.device("cuda")
    assert ops.resolve_device("torch", "cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        ops.resolve_device("auto")
    with pytest.raises(RuntimeError):
        ops.resolve_device("cuda", "cpu")
    with pytest.raises(RuntimeError):
        ops.resolve_device("torch", "meta")


def _broad_handlers(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            if node.type is None or (
                isinstance(node.type, ast.Name) and node.type.id in ("Exception", "BaseException")
            ):
                yield node.lineno


@pytest.mark.parametrize(
    "rel",
    ["core/samplers/tpe.py", "kernels/ops.py", "kernels/parzen.py",
     "kernels/ref.py", "kernels/_build.py", "core/moo.py", "core/samplers/nsga2.py",
     "core/pruners/moo.py", "kernels/hypervolume.py", "kernels/flash_attention.py",
     "models/attention.py", "models/transformer.py", "models/transfer.py", "serve/engine.py",
     "launch/serve.py", "kernels/crossentropy.py", "models/layers.py", "train/optimizer.py",
     "train/data.py", "train/checkpoint.py", "train/train_loop.py", "launch/train.py",
     "tune/objective.py", "kernels/ssd.py", "models/mamba2.py", "kernels/slstm.py",
     "models/ssm_xlstm.py", "models/moe.py", "core/distributed.py"],
)
def test_sampling_path_has_no_broad_except(rel):
    assert list(_broad_handlers(PORT / rel)) == []


STORAGE_FILES = sorted((PORT / "core" / "storage").glob("*.py"))


@pytest.mark.parametrize("path", STORAGE_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_storage_modules_import_no_torch(path):
    """Storage moves numpy columns and JSON: no module of ``core/storage``
    imports ``torch``, at the top or inside a function."""
    for mod in _imported_modules(path):
        assert mod.split(".")[0] != "torch", f"{path}: imports {mod}"


def test_import_scan_covers_the_storage_slice():
    scanned = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    for name in ("serde", "base", "sqlite", "journal", "cached", "server", "client",
                 "cluster", "chaos", "inmemory", "__init__"):
        assert f"core/storage/{name}.py" in scanned
    assert "core/distributed.py" in scanned


#: the reference's observation-block layout: key -> dtype (``None``: not an array)
OBSERVATION_BLOCK = {
    "n": None, "n_objectives": None, "numbers": "int64", "states": "int8",
    "values": "float64", "values_len": "int64", "values_mat": "float64",
    "last_iv": "float64", "grid_ids": "int64", "params": None,
}


def test_later_slices_raise_not_implemented(tmp_path):
    """The multi-objective calls work; the storage URLs resolve to their
    backends (``cache=True`` wraps them) and ``get_observation_block``
    returns the reference's columns."""
    import importlib.util

    from repro_torch.core.exceptions import RetryableStorageError
    from repro_torch.core.storage import CachedStorage, ShardedStorage, StorageServer

    assert hpo.TPESampler(multi_objective=True, engine="numpy")._multi_objective
    pruner = pruner_from_spec({"name": "pareto", "wrapped": {"name": "median"}})
    assert isinstance(pruner, hpo.ParetoPruner)
    for url, kind in ((f"sqlite:///{tmp_path}/x.db", hpo.SQLiteStorage),
                      (f"journal://{tmp_path}/x.journal", hpo.JournalStorage),
                      (str(tmp_path / "y.sqlite3"), hpo.SQLiteStorage),
                      (str(tmp_path / "y.jsonl"), hpo.JournalStorage)):
        assert isinstance(hpo.get_storage(url), kind)
        assert isinstance(hpo.get_storage(url, cache=True), CachedStorage)
    with pytest.raises(RetryableStorageError):  # resolves, then finds no server
        hpo.get_storage("remote://127.0.0.1:1")
    with StorageServer(hpo.InMemoryStorage()) as a, StorageServer(hpo.InMemoryStorage()) as b:
        assert isinstance(hpo.get_storage(a.url), hpo.RemoteStorage)
        sharded = hpo.get_storage("remote://" + ",".join(s.url.split("://")[1] for s in (a, b)))
        assert isinstance(sharded, ShardedStorage)
        sharded.close()
    study = hpo.create_study(engine="numpy", directions=["minimize", "maximize"])
    assert study.best_trials == []
    for i in range(3):
        t = study.ask()
        t.suggest_float("x", 0, 1)
        t.report([float(i), 1.0], 0)
        study.tell(t, [float(i), -float(i)])
    block = study._storage.get_observation_block(study._study_id)
    assert {k: getattr(v, "dtype", None) for k, v in block.items()} == {
        k: (None if dt is None else np.dtype(dt)) for k, dt in OBSERVATION_BLOCK.items()
    }
    assert block["n"] == 3 and block["values_mat"].shape == (3, 2)
    assert study._storage.get_iv_block(study._study_id)["vec_vals"].tolist() == [
        0.0, 1.0, 1.0, 1.0, 2.0, 1.0,
    ]
    if importlib.util.find_spec("jax") is not None:  # and the reference's own bytes
        from repro.core.storage import serde as ref_serde

        from repro_torch.core.storage import serde

        trials = study._storage.get_all_trials(study._study_id)
        assert serde.bdumps(block) == ref_serde.bdumps(
            ref_serde.build_observation_block(trials, 2)
        )


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"],
                         ids=lambda arch: f"{arch}-MLA/MoE")
def test_unported_model_families_raise(arch):
    """The MLA / MoE configs build on ``meta`` at full size; the smoke
    config builds on the CPU and its loss is finite, the MoE aux loss
    included."""
    full = configs.get_config(arch)
    model = Transformer(full, device="meta")
    assert any(".moe.w1" in name for name, _ in model.named_parameters())
    cfg = configs.get_smoke_config(arch)
    model = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    loss, metrics = loss_fn(model, SyntheticLM(cfg, batch=2, seq=16).batch_at(0))
    assert torch.isfinite(loss) and float(metrics["aux"]) > 0


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_xlstm_family_builds(get):
    """The xlstm configs (mLSTM and sLSTM blocks) build on ``meta``; the
    smoke config builds on the CPU and its loss is finite."""
    cfg = getattr(configs, get)("xlstm-1.3b")
    model = Transformer(cfg, device="meta")
    kinds = {b.kind for b in cfg.superblock}
    assert kinds == {"mlstm", "slstm"}
    assert any(name.endswith("r_zifo") for name, _ in model.named_parameters())
    if get == "get_smoke_config":
        model = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
        loss, _ = loss_fn(model, SyntheticLM(cfg, batch=2, seq=16).batch_at(0))
        assert torch.isfinite(loss)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_kinds_build(kind):
    """A stack of one block kind builds and runs train, prefill and decode."""
    import dataclasses

    from repro_torch.models import BlockDef, forward, init_cache

    cfg = dataclasses.replace(configs.get_smoke_config("tinyllama-1.1b"),
                              superblock=(BlockDef(kind=kind, ffn="none"),), d_ff=0)
    Transformer(cfg, device="meta")
    model = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    x, _, _ = forward(model, {"tokens": tokens}, mode="train")
    cache = init_cache(cfg, 2, 16, device="cpu")
    _, cache, _ = forward(model, {"tokens": tokens[:, :7]}, cache=cache, mode="prefill")
    y, cache, _ = forward(model, {"tokens": tokens[:, 7:]}, cache=cache, cache_index=7,
                          mode="decode")
    assert torch.isfinite(x).all() and torch.isfinite(y).all()
    assert all(t.dtype == torch.float32 for t in cache["stack"]["0"].values())


def test_mla_block_kind_raises():
    """A stack of MLA blocks builds and runs train, prefill and decode, its
    cache a ``c_kv`` / ``k_rope`` pair in the cache dtype."""
    import dataclasses

    from repro_torch.models import BlockDef, forward, init_cache

    cfg = dataclasses.replace(configs.get_smoke_config("tinyllama-1.1b"),
                              superblock=(BlockDef(kind="mla"),), kv_lora_rank=16,
                              qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8)
    Transformer(cfg, device="meta")
    model = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    x, _, _ = forward(model, {"tokens": tokens}, mode="train")
    cache = init_cache(cfg, 2, 16, device="cpu")
    _, cache, _ = forward(model, {"tokens": tokens[:, :7]}, cache=cache, mode="prefill")
    y, cache, _ = forward(model, {"tokens": tokens[:, 7:]}, cache=cache, cache_index=7,
                          mode="decode")
    assert torch.isfinite(x).all() and torch.isfinite(y).all()
    assert sorted(cache["stack"]["0"]) == ["c_kv", "k_rope"]
    assert cache["stack"]["0"]["c_kv"].shape == (cfg.n_superblocks, 2, 16, 16)
    assert cache["stack"]["0"]["c_kv"].dtype == torch.bfloat16
    assert cache["stack"]["0"]["c_kv"][:, :, :8].any() and not cache["stack"]["0"]["c_kv"][:, :, 8:].any()


def test_moe_ffn_loss_mla_and_checkpoint_raise(tmp_path):
    """The MoE FFN builds and trains a step's loss, the MLA parts build
    their specs and cache; the training slice's ``loss_fn`` and ``launch.
    serve --checkpoint`` run."""
    import dataclasses

    from repro_torch.models import BlockDef

    cfg = dataclasses.replace(configs.get_smoke_config("tinyllama-1.1b"),
                              superblock=(BlockDef(kind="attn", ffn="moe"),), moe_experts=4,
                              moe_top_k=2, moe_d_ff=32, moe_group=16)
    Transformer(cfg, device="meta")
    moe_model = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for p in moe_model.parameters():
        p.requires_grad_(True)
    loss, metrics = loss_fn(moe_model, SyntheticLM(cfg, batch=2, seq=16).batch_at(0))
    loss.backward()
    assert torch.isfinite(loss) and float(metrics["aux"].detach()) > 0
    assert moe_model.stack[0]["0"].moe.router.grad.abs().sum() > 0
    assert sorted(attn.mla_specs(cfg)) == ["kv_norm", "w_dkv", "w_kr", "w_uk", "w_uv", "wo", "wq"]
    mla_cache = attn.empty_mla_cache(cfg, 2, 8, torch.float32)
    assert mla_cache["c_kv"].shape == (2, 8, cfg.kv_lora_rank)
    assert callable(attn.mla_block_full) and callable(attn.mla_block_decode)
    dense = configs.get_smoke_config("tinyllama-1.1b")
    model = init_model_params(dense, torch.Generator().manual_seed(0), "cpu")
    loss, metrics = loss_fn(model, SyntheticLM(dense, batch=2, seq=16).batch_at(0))
    assert loss.shape == () and torch.isfinite(loss) and float(metrics["ce"]) > 0
    path = str(tmp_path / "params.ckpt")
    save_pytree(path, params_tree(model))
    result = launch_serve.main(["--smoke", "--device", "cpu", "--checkpoint", path,
                                "--requests", "2", "--max-new", "3"])
    assert [len(o) for o in result["outputs"]] == [3, 3]


def test_default_engine_needs_cuda_or_an_explicit_cpu(no_cuda):
    cfg = configs.get_smoke_config("smollm-135m")
    model = Transformer(cfg, device="cpu")
    for engine in ("auto", "torch", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(cfg, model, engine=engine)
    with pytest.raises(RuntimeError):
        Engine(cfg, model, device="cpu", engine="cuda")
    assert Engine(cfg, model, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="cannot run"):
        attn.attention_full(*[torch.zeros(1, 4, 2, 16)] * 3, engine="cuda")


def test_default_trainer_and_train_launcher_need_cuda_or_an_explicit_cpu(no_cuda):
    cfg = configs.get_smoke_config("smollm-135m")
    data = SyntheticLM(cfg, batch=2, seq=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainConfig(total_steps=1), data)
    assert Trainer(cfg, TrainConfig(total_steps=1), data, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])
    spec = LMTuneSpec(vocab=64, seq=16, batch=2, total_steps=2, eval_every=1, max_layers=1,
                      max_width=32, families=("dense",))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_lm_objective(spec)(hpo.FixedTrial({"family": "dense", "n_layers": 1, "width_exp": 5,
                                               "n_heads": 2, "ff_mult": 1, "window": -1,
                                               "lr": 1e-3, "warmup": 0, "weight_decay": 0.01}))
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        Trainer(cfg, TrainConfig(total_steps=1), data, device="cpu", mesh=object())
