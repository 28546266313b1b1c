"""The port's serving engine against the reference on the CPU.

``repro.serve.Engine`` and ``repro_torch.serve.Engine`` generate greedily
from the same weights (carried across by ``params_from_jax``) and the same
prompts of unequal length, so left padding, the bfloat16 KV cache, ring
caches (gemma2's window of 8 under prompts of up to 12 tokens and 10 new
tokens), zamba2's float32 mamba2 states and shared-block KV caches, xlstm's
float32 mLSTM and sLSTM states, deepseek-v2-lite's MLA caches (``c_kv``,
``k_rope``) and MoE FFNs, qwen3-moe's GQA and MoE FFNs, and slot groups all
take part.  In float32
compute the tokens must be identical.  The launcher runs with ``--smoke
--device cpu`` on tinyllama, zamba2, xlstm, deepseek-v2-lite and qwen3-moe.  The ``Engine`` casts the
matrices to the compute dtype once but keeps an sLSTM block's recurrent
weights ``r_zifo`` and a MoE router float32, as the reference reads them
at every step.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.serve import Engine as RefEngine
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Transformer, params_from_jax
from repro_torch.serve import Engine, sample_token

TEXT = ["tinyllama-1.1b", "smollm-135m", "internlm2-1.8b", "gemma2-9b", "zamba2-1.2b",
        "xlstm-1.3b", "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
PROMPT_LENS = [5, 12, 3, 9, 7]  # slots=4: a group of four, then one alone
MAX_NEW, CAPACITY, SLOTS = 10, 32, 4


@pytest.mark.parametrize("arch", TEXT)
def test_greedy_tokens_equal_the_reference(arch):
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), compute_dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="float32")
    params = ref_models.init_model_params(ref_cfg, jax.random.PRNGKey(2))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, params)))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]

    want = RefEngine(ref_cfg, params, capacity=CAPACITY, slots=SLOTS).generate(prompts, MAX_NEW)
    engine = Engine(cfg, model, capacity=CAPACITY, slots=SLOTS, device="cpu")
    got = engine.generate(prompts, MAX_NEW)
    assert got == [[int(t) for t in row] for row in want]
    assert all(len(row) == MAX_NEW for row in got)


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-1.2b", "xlstm-1.3b",
                                  "deepseek-v2-lite-16b"])
def test_engine_casts_matrices_once_and_keeps_norms_float32(arch):
    cfg = configs.get_smoke_config(arch)  # bfloat16 compute
    model = Transformer(cfg, device="cpu")
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    engine = Engine(cfg, model, capacity=16, slots=2, device="cpu")
    for name, p in engine.model.named_parameters():
        cast = p.dim() >= 2 and not name.endswith(("r_zifo", "moe.router"))
        assert p.dtype == (torch.bfloat16 if cast else torch.float32), name
    out = engine.generate([np.arange(1, 6), np.arange(3, 12)], max_new=4)
    assert [len(o) for o in out] == [4, 4]
    assert all(0 <= t < cfg.vocab for o in out for t in o)


def test_prompt_past_the_capacity_raises():
    cfg = configs.get_smoke_config("smollm-135m")
    model = Transformer(cfg, device="cpu")
    for p in model.parameters():
        torch.nn.init.zeros_(p)
    engine = Engine(cfg, model, capacity=8, slots=1, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        engine.generate([np.arange(6)], max_new=4)


def test_sample_token_greedy_and_top_k():
    logits = torch.tensor([[[0.1, 3.0, 3.0, -1.0]], [[2.0, 0.0, 1.0, 5.0]]])
    assert sample_token(None, logits).tolist() == [[1], [3]]  # first maximum on ties
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([sample_token(gen, logits, temperature=1.0, top_k=2) for _ in range(200)])
    assert set(draws[:, 0, 0].tolist()) <= {1, 2} and set(draws[:, 1, 0].tolist()) <= {0, 3}


@pytest.mark.parametrize("arch,name", [("tinyllama-1.1b", "tinyllama-smoke"),
                                       ("zamba2-1.2b", "zamba2-smoke"),
                                       ("xlstm-1.3b", "xlstm-smoke"),
                                       ("deepseek-v2-lite-16b", "deepseek-smoke"),
                                       ("qwen3-moe-235b-a22b", "qwen3-moe-smoke")])
def test_launcher_smoke_on_the_cpu(capsys, arch, name):
    result = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                                "--requests", "3", "--max-new", "5"])
    assert result["device"] == "cpu" and result["tokens"] == 15
    assert [len(o) for o in result["outputs"]] == [5, 5, 5]
    assert f"[serve] {name} on cpu: 15 tokens" in capsys.readouterr().out
