"""The port's sharded serving caches on 4 CPU processes (gloo).

``launch.specs.build_step``'s prefill and decode cells under ``SERVE_RULES``
on a (2, 2) ("data", "model") mesh and on a (1, 2, 2) ("pod", "data",
"model") mesh, at batch 1 (the batch takes no "data" shard, so ``kv_seq``
splits every KV / MLA cache's rows over "data") and batch 2 (the batch takes
"data", the rows stay whole), and at batch 3 on the (2, 2) mesh (the rows
split over "data", each rank holding all 3 of them).  Six smoke configs,
float32 compute with a float32 cache:

* tinyllama (kv heads over "model"), smollm (3 kv heads: ``head_dim`` over
  "model", with the sequence split), gemma2 (a window-8 ring cache that
  wraps, split into 4-slot shards; the attention and final softcaps),
  deepseek-v2-lite (the MLA latent ``c_kv`` and ``k_rope`` over "model";
  at batch 2 the MoE dispatch groups cut by the batch shards), zamba2 (the
  mamba2 blocks' SSD state over heads and their conv cache, whose
  contiguous column shards are not the columns the local heads read; the
  shared attention block) and musicgen (``[B, K, 1]`` audio decode tokens,
  the audio head as a local product).

Each case runs a prefill of a prompt that ends one or two rows before the
shard boundary at position 16 (capacity 32, 16 rows a shard), then 4 decode
steps across it, teacher-forced with numpy-seeded tokens, and holds:

* every logit within 1e-5 of the one-process ``Engine``'s steps on the same
  weights (float32 sums in another order: partial scores over ``head_dim`` or
  the latent, the shards' sum-exp and ``P v``; the ``head_dim`` split
  alone measured 3.6e-7 in ``tests/test_torch_parallel.py``);
* every logit within 1e-4 of the reference's one-device jitted prefill and
  decode steps (``repro.serve``), ``tests/test_torch_models.py``'s float32
  bound, on the same weights: the port's seeded init carried into the
  reference's tree (``params_tree``; ``repro``'s own init takes 7-17 s a
  config here).  The parent computes them while the ranks run;
* each rank's cache shards, gathered, within 1e-5 of the one-process cache
  (k / v, the latent and the conv inputs come from products of other shapes
  than the one-process ones, so not bit for bit);
* tinyllama in bfloat16 with the ``Engine``'s bfloat16 cache: 5 greedy
  tokens equal to ``Engine.generate``'s;
* a prompt prefilled in three parts, from cache indices 0, 9 (below a
  shard's 16 rows: the earlier rows lie in the first shard) and 18 (past
  it), at batch 1 on both meshes, for every config but gemma2 (whose window
  ring is prefilled from 0 only, in the one-process block too): each part's
  last logits and the gathered cache within 1e-5 of the one-process
  ``forward`` run on the same parts.

One spawn of 4 ranks serves every case, as in ``tests/test_torch_parallel.py``:
a ``FileStore`` in ``tmp_path``, one torch thread a rank, a join timeout; a
rank that raises writes its traceback to its results file.
"""

import copy
import dataclasses
import json
import logging
import os
import time
import traceback

import numpy as np
import pytest
import torch

ARCHS = ["tinyllama-1.1b", "smollm-135m", "gemma2-9b", "deepseek-v2-lite-16b", "zamba2-1.2b",
         "musicgen-medium"]
MESHES = {"(2, 2)": ((2, 2), ("data", "model")),
          "(1, 2, 2)": ((1, 2, 2), ("pod", "data", "model"))}
BATCHES = (1, 2)
#: batch 3 on the (2, 2) mesh: "data" does not divide it either, so the caches' rows split
#: over "data" and each rank holds all 3 rows
ODD = 3
WORLD = 4
JOIN_TIMEOUT = 240
#: a cache split over "data" holds 16 rows a shard; the prompts end 2 or 1 rows before row 16
CAPACITY, BOUNDARY = 32, 16
PROMPT = {"tinyllama-1.1b": 14, "smollm-135m": 15, "gemma2-9b": 14, "deepseek-v2-lite-16b": 15,
          "zamba2-1.2b": 14, "musicgen-medium": 15}
STEPS = 4
SEED = 25
ENGINE_TOL, REF_TOL = 1e-5, 1e-4
CASES = ([(a, m, b) for a in ARCHS for m in MESHES for b in BATCHES]
         + [(a, "(2, 2)", ODD) for a in ARCHS])
IDS = [f"{a}-{m}-B{b}" for a, m, b in CASES]
#: a prompt prefilled in parts from these cache indices (a shard holds 16 rows)
PARTS = (0, 9, 18, 24)
PREFIX_ARCHS = [a for a in ARCHS if a != "gemma2-9b"]


def _cfg(arch):
    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="float32",
                               serve_param_dtype="float32")


def _model(cfg):
    from repro_torch.models import init_model_params

    return init_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")


def _tokens(arch, batch: int) -> tuple:
    """``(prompt, [decode tokens of each step])`` as numpy, ``[B, S]`` (``[B,
    K, S]`` audio)."""
    cfg = _cfg(arch)
    rng = np.random.RandomState(SEED + batch)
    lead = (batch, cfg.num_codebooks) if cfg.modality == "audio" else (batch,)
    prompt = rng.randint(0, cfg.vocab, (*lead, PROMPT[arch]))
    return prompt, [rng.randint(0, cfg.vocab, (*lead, 1)) for _ in range(STEPS)]


def _kv_positions(cache) -> dict:
    """The stacked KV / MLA cache positions of ``cache``."""
    return {pos: c for pos, c in cache["stack"].items() if "k" in c or "c_kv" in c}


def _leaves(a, b=None):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], None if b is None else b[k])
    else:
        yield a, b


# -- the ranks ----------------------------------------------------------------------------------


def _serve(arch, cfg, mesh, model, batch: int) -> tuple:
    """The sharded prefill and the teacher-forced decode steps with a
    float32 cache: ``(logits, cache)``."""
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache

    prompt, fed = _tokens(arch, batch)
    prefill = build_step(cfg, "prefill_32k", mesh)
    decode = build_step(cfg, "decode_32k", mesh)
    smodel, sbatch, cache = prefill.shard(copy.deepcopy(model),
                                          {"tokens": torch.from_numpy(prompt)},
                                          init_cache(cfg, batch, CAPACITY, torch.float32,
                                                     device="cpu"))
    logits, cache = prefill.step(smodel, sbatch, cache)
    out = [logits.full_tensor()]
    for i, tok in enumerate(fed):
        logits, cache = decode.step(smodel, decode.shard(None, torch.from_numpy(tok))[1], cache,
                                    prompt.shape[-1] + i)
        out.append(logits.full_tensor())
    return out, cache


def _case(ctx, arch) -> tuple:
    """One arch at both batches on both meshes against the one-process
    ``Engine``: ``(summary, sharded logits)``."""
    from repro_torch.models import init_cache
    from repro_torch.serve import Engine

    cfg = _cfg(arch)
    model = _model(cfg)
    summary, logits = {}, {}
    for batch in (*BATCHES, ODD):
        prompt, fed = _tokens(arch, batch)
        engine = Engine(cfg, copy.deepcopy(model), capacity=CAPACITY, slots=batch, device="cpu")
        got, cache = engine._prefill(engine.model, {"tokens": torch.from_numpy(prompt)},
                                     init_cache(cfg, batch, CAPACITY, torch.float32, device="cpu"))
        want = [got]
        for i, tok in enumerate(fed):
            got, cache = engine._decode(engine.model, torch.from_numpy(tok), cache,
                                        prompt.shape[-1] + i)
            want.append(got)
        for name, mesh in ctx["meshes"].items():
            if batch == ODD and name != "(2, 2)":
                continue
            got, scache = _serve(arch, cfg, mesh, model, batch)
            kv = _kv_positions(scache)
            key = f"{arch}-{name}-B{batch}"
            summary[key] = {
                "engine": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                # every rank gathers every leaf (a short-circuit would leave the others waiting)
                "cache": max([float((s.full_tensor() - w).abs().max())
                              for s, w in _leaves(scache, cache)]),
                # each position's leaves' placements and local rows (dim 2 of [L, B, T, ...])
                "placements": {pos: sorted({str(t.placements) for t in c.values()})
                               for pos, c in kv.items()},
                "local_rows": {pos: next(iter(c.values())).to_local().shape[2]
                               for pos, c in kv.items()},
                "capacity": {pos: next(iter(c.values())).shape[2] for pos, c in kv.items()},
                "prompt": prompt.shape[-1],
            }
            logits[key] = got
    return summary, logits


def _case_bf16(ctx) -> dict:
    """tinyllama in bfloat16 with the bfloat16 cache: greedy tokens of the
    sharded steps and of ``Engine.generate``."""
    from repro_torch import configs
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache
    from repro_torch.serve import Engine

    cfg = configs.get_smoke_config("tinyllama-1.1b")
    model = _model(cfg)
    out = {}
    for batch in BATCHES:
        prompt, _ = _tokens("tinyllama-1.1b", batch)
        engine = Engine(cfg, copy.deepcopy(model), capacity=CAPACITY, slots=batch, device="cpu")
        want = engine.generate(list(prompt), max_new=5)
        for name, mesh in ctx["meshes"].items():
            prefill = build_step(cfg, "prefill_32k", mesh)
            decode = build_step(cfg, "decode_32k", mesh)
            smodel, sbatch, cache = prefill.shard(copy.deepcopy(model),
                                                  {"tokens": torch.from_numpy(prompt)},
                                                  init_cache(cfg, batch, CAPACITY, device="cpu"))
            logits, cache = prefill.step(smodel, sbatch, cache)
            got = [[] for _ in range(batch)]
            for i in range(5):
                tok = torch.argmax(logits.full_tensor(), dim=-1)
                for j in range(batch):
                    got[j].append(int(tok[j, 0]))
                if i < 4:
                    logits, cache = decode.step(smodel, decode.shard(None, tok[:, :1])[1], cache,
                                                prompt.shape[-1] + i)
            out[f"{name}-B{batch}"] = {"got": got, "want": want}
    return out


def _prefill_at(model, tokens, cache, ci: int) -> tuple:
    """``forward``'s prefill of ``tokens`` from cache index ``ci``: ``(last
    logits, cache)``."""
    from repro_torch.models import forward, logits_from_hidden

    with torch.no_grad():
        x, cache, _ = forward(model, {"tokens": tokens}, cache=cache, cache_index=ci,
                              mode="prefill")
        return logits_from_hidden(model, x[:, -1:]), cache


def _case_prefix(ctx) -> dict:
    """A batch-1 prompt prefilled in the parts ``PARTS`` cut, sharded on
    both meshes and in one process: the largest logit and cache gaps."""
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache
    from repro_torch.models.sharding import wrap_with_sharding_ctx

    out = {}
    for arch in PREFIX_ARCHS:
        cfg = _cfg(arch)
        model = _model(cfg)
        lead = (1, cfg.num_codebooks) if cfg.modality == "audio" else (1,)
        prompt = torch.from_numpy(np.random.RandomState(SEED).randint(0, cfg.vocab,
                                                                      (*lead, PARTS[-1])))
        parts = [prompt[..., a:z] for a, z in zip(PARTS, PARTS[1:])]
        cache = init_cache(cfg, 1, CAPACITY, torch.float32, device="cpu")
        want = []
        for ci, part in zip(PARTS, parts):
            logits, cache = _prefill_at(model, part, cache, ci)
            want.append(logits)
        for name, mesh in ctx["meshes"].items():
            cell = build_step(cfg, "prefill_32k", mesh)
            step = wrap_with_sharding_ctx(_prefill_at, mesh, cell.rules)
            smodel, _, scache = cell.shard(copy.deepcopy(model), {"tokens": parts[0]},
                                           init_cache(cfg, 1, CAPACITY, torch.float32,
                                                      device="cpu"))
            got = []
            for ci, part in zip(PARTS, parts):
                logits, scache = step(smodel, cell.shard(None, {"tokens": part}, None)[1]["tokens"],
                                      scache, ci)
                got.append(logits.full_tensor())
            out[f"{arch}-{name}"] = {
                "logits": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                "cache": max([float((t.full_tensor() - w).abs().max())
                              for t, w in _leaves(scache, cache)]),
                "split": sorted({str(t.placements) for t, _ in _leaves(_kv_positions(scache))}),
            }
    return out


def _rank(rank, world, store_path, data_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    ctx = {"meshes": {name: init_device_mesh("cpu", shape, mesh_dim_names=names)
                      for name, (shape, names) in MESHES.items()}}
    results, logits = {}, {}
    path = os.path.join(data_dir, f"results{rank}.json")
    for name, fn, args in ([(a, _case, (a,)) for a in ARCHS] + [("bf16", _case_bf16, ()),
                                                                  ("prefix", _case_prefix, ())]):
        t0 = time.perf_counter()
        try:
            value = fn(ctx, *args)
            if name in ARCHS:
                value, got = value
                logits.update(got)
            results[name] = {"ok": True, "value": value, "seconds": time.perf_counter() - t0}
        except Exception:  # recorded for the parent, then the rank stops
            results[name] = {"ok": False, "error": traceback.format_exc()}
            with open(path, "w") as f:
                json.dump(results, f)
            raise
        with open(path, "w") as f:
            json.dump(results, f)
    if rank == 0:
        torch.save(logits, os.path.join(data_dir, "logits.pt"))
    dist.destroy_process_group()


# -- the parent ----------------------------------------------------------------------------------


def _reference_logits() -> dict:
    """The reference's jitted one-device prefill and decode steps with a
    float32 cache on the port's weights: ``{(arch, batch): [logits of each
    step]}``."""
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro import models as ref_models
    from repro.serve import make_decode_step, make_prefill_step
    from repro_torch.models.transfer import params_tree

    out = {}
    for arch in ARCHS:
        ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), compute_dtype="float32")
        cfg = _cfg(arch)
        params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                              params_tree(_model(cfg)))
        prefill, decode = jax.jit(make_prefill_step(ref_cfg)), jax.jit(make_decode_step(ref_cfg))
        for batch in (*BATCHES, ODD):
            prompt, fed = _tokens(arch, batch)
            cache = ref_models.init_cache(ref_cfg, batch, CAPACITY, dtype=jnp.float32)
            logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)}, cache)
            steps = [np.asarray(logits)]
            for i, tok in enumerate(fed):
                logits, cache = decode(params, jnp.asarray(tok), cache, prompt.shape[-1] + i)
                steps.append(np.asarray(logits))
            out[arch, batch] = steps
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import torch.multiprocessing as mp

    data_dir = str(tmp_path_factory.mktemp("serve_sharded"))
    store = os.path.join(data_dir, "store")
    t0 = time.perf_counter()
    procs = mp.start_processes(_rank, args=(WORLD, store, data_dir), nprocs=WORLD,
                               start_method="spawn", join=False)
    failure, reference = None, {}
    try:
        reference = _reference_logits()  # while the ranks run
        while not procs.join(timeout=max(1.0, JOIN_TIMEOUT - (time.perf_counter() - t0))):
            if time.perf_counter() - t0 > JOIN_TIMEOUT:
                failure = f"the ranks did not finish within {JOIN_TIMEOUT} s"
                break
    except Exception as e:  # a rank raised: its traceback is in the results
        failure = f"{type(e).__name__}: {e}"
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = {}
    path = os.path.join(data_dir, "results0.json")
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    logits_path = os.path.join(data_dir, "logits.pt")
    out["_logits"] = torch.load(logits_path) if os.path.exists(logits_path) else {}
    out["_reference"] = reference
    out["_failure"] = failure
    out["_seconds"] = time.perf_counter() - t0
    return out


def _value(results, name):
    got = results.get(name)
    if got is None:
        pytest.fail(f"case {name} did not run: {results['_failure']}")
    assert got["ok"], got["error"]
    return got["value"]


@pytest.mark.parametrize("arch,mesh,batch", CASES, ids=IDS)
def test_sharded_serving_matches_the_engine(results, arch, mesh, batch):
    v = _value(results, arch)[f"{arch}-{mesh}-B{batch}"]
    assert v["engine"] <= ENGINE_TOL, v
    # batch 1 leaves "data" to every KV / MLA cache's rows (the stacked leaf's
    # dim 2), batch 2 takes it (dim 1)
    data = MESHES[mesh][1].index("data")
    rows_split = batch % 2 == 1
    for pos, placements in v["placements"].items():
        assert len(placements) == 1, v  # the leaves of a position alike
        split = placements[0].strip("()").split(", ")[data]
        assert split == ("Shard(dim=2)" if rows_split else "Shard(dim=1)"), v
        assert v["local_rows"][pos] * (2 if rows_split else 1) == v["capacity"][pos], v


@pytest.mark.parametrize("arch,mesh,batch", CASES, ids=IDS)
def test_sharded_serving_matches_the_reference(results, arch, mesh, batch):
    _value(results, arch)
    got = results["_logits"][f"{arch}-{mesh}-B{batch}"]
    want = results["_reference"][arch, batch]
    assert len(got) == len(want) == 1 + STEPS
    worst = max(float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want))
    assert worst <= REF_TOL, worst


@pytest.mark.parametrize("arch,mesh,batch", CASES, ids=IDS)
def test_gathered_cache_equals_the_one_process_cache(results, arch, mesh, batch):
    v = _value(results, arch)[f"{arch}-{mesh}-B{batch}"]
    assert v["cache"] <= ENGINE_TOL, v


def test_decode_crosses_a_shard_boundary_and_the_ring_wraps(results):
    from repro_torch import configs

    for arch in ARCHS:
        v = _value(results, arch)[f"{arch}-(2, 2)-B1"]
        assert max(v["local_rows"].values()) == BOUNDARY, v
        assert v["prompt"] < BOUNDARY <= v["prompt"] + STEPS - 1, v
    v = _value(results, "gemma2-9b")["gemma2-9b-(2, 2)-B1"]
    window = configs.get_smoke_config("gemma2-9b").superblock[0].window
    # the window layer's ring of 8 slots, 4 a shard, which the prompt wraps
    assert v["capacity"]["0"] == window < v["prompt"] and v["local_rows"]["0"] == window // 2, v


@pytest.mark.parametrize("key", [f"{m}-B{b}" for m in MESHES for b in BATCHES])
def test_bf16_greedy_tokens_equal_the_engines(results, key):
    v = _value(results, "bf16")[key]
    assert v["got"] == v["want"], v


@pytest.mark.parametrize("arch", PREFIX_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_from_a_cached_prefix_matches_one_process(results, arch, mesh):
    """The parts start below a shard's rows (9: the earlier rows gathered
    from the first shard alone) and past them (18); every KV / MLA cache's
    rows lie over "data"."""
    v = _value(results, "prefix")[f"{arch}-{mesh}"]
    assert PARTS[1] < BOUNDARY < PARTS[2] < PARTS[-1] <= CAPACITY
    assert v["logits"] <= ENGINE_TOL and v["cache"] <= ENGINE_TOL, v
    data = MESHES[mesh][1].index("data")
    assert v["split"] and all(p.strip("()").split(", ")[data] == "Shard(dim=2)"
                              for p in v["split"]), v


def test_the_spawn_stays_inside_its_budget(results):
    assert results["_failure"] is None, results["_failure"]
    assert results["_seconds"] < JOIN_TIMEOUT
