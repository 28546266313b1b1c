"""The port's xLSTM blocks under a mesh on 4 CPU processes (gloo).

xlstm's smoke config (2 heads; an mLSTM and an sLSTM block a superblock, 2
superblocks), float32 compute with its float32 caches, on three meshes:

* (2, 2) ("data", "model") and (1, 2, 2) ("pod", "data", "model"): the heads
  divide "model", so each rank runs its head (the Megatron layout): the
  mLSTM's xc / z columns of its head, its gate products over its xc rows
  summed over "model" (every head's gates read all of xc), the sLSTM scan on its head
  with ``r_zifo[:, h]`` and the state shards over heads as its initial state,
  the output norms' sums of squares all-reduced over "model";
* (1, 4) ("data", "model"): 2 heads do not divide "model", so each block
  runs whole on every rank.  Under ``SERVE_RULES`` the caches are split along
  ``head_dim`` and stay so: the mLSTM's fold writes each rank's key rows of
  ``C`` and ``n``, a decode step sums the partial ``q . C`` and ``q . n``
  over "model"; the sLSTM state is gathered for the recurrence and each rank
  writes its slice back.

Serving (``launch.specs.build_step``'s prefill and decode cells), at batch 1
and 2 on every mesh and at batch 3 on (2, 2): a prefill of a 14-token prompt
and 4 decode steps teacher-forced with numpy-seeded tokens, held to

* the one-process ``Engine``'s steps on the same weights, every logit within
  1e-5 (float32 sums in another order: partial sums over heads or key rows);
* the reference's one-device jitted prefill and decode steps (``repro.serve``)
  on the same weights carried into its tree (``params_tree``), every logit
  within 1e-4, ``tests/test_torch_models.py``'s float32 bound; the parent
  computes them while the ranks run;
* each rank's cache shards, gathered, within 1e-5 of the one-process cache,
  scaled by each leaf's largest |value| where that is above 1: the sLSTM
  state grows along the sequence (``m`` to 32, ``n`` to 14 here), where
  float32's spacing is 2e-6 to 4e-6, and its recurrence carries the
  roundings of sums taken in another order (measured up to 4.7e-5 on ``n``,
  2.3e-5 on ``m``, 1.7e-5 on ``c``, whose largest value is 3.8; every mLSTM
  leaf within 3e-6);
* the caches' placements (over heads, or along ``head_dim`` with the sLSTM
  ``m`` and the mLSTM ``m`` whole), and the sLSTM scan's calls: one a block
  in the prefill and in each decode step, on 1 head a rank or on both.

A prompt prefilled in three parts (from cache indices 0, 9 and 18) on each
mesh is held to the one-process ``forward`` on the same parts: the mLSTM's
output of a prefill ignores the incoming state there too (the parallel form
over the part alone), while its fold and the sLSTM scan continue it.

Training: ``build_step(cfg, "train_4k", mesh)`` under ``TRAIN_RULES`` on (2,
2) (the heads over "model") and on (1, 4) (each block whole on every rank,
the sequence split over "model" between blocks), 2 float32 steps of 4 x 32
tokens against the one-process port step from the same weights and batches
(AdamW with eps 1e-4, as ``tests/test_torch_parallel.py``): each step's loss
within atol 1e-5 / rtol 1e-4; the first batch's gradients, gathered, within
1e-5 of each leaf's largest |gradient| (``tests/test_torch_train.py``'s
bound for xlstm; measured up to 5.8e-6); every parameter after the steps
within atol 1e-5 / rtol 1e-4 but the embedding, held within atol 2e-4 /
rtol 1e-4, ``tests/test_torch_train_step.py``'s bound for xlstm's
parameters after AdamW: its gradient reaches 7.4 here while AdamW
normalizes the float32 noise of entries whose gradient is near eps (on (2,
2) the embedding ended 2.2e-5 apart, every other leaf within 7.3e-6).

One spawn of 4 ranks serves every case, as in
``tests/test_torch_serve_sharded.py``: a ``FileStore`` in ``tmp_path``, one
torch thread a rank, a join timeout; a rank that raises writes its
traceback to its results file.
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

ARCH = "xlstm-1.3b"
MESHES = {"(2, 2)": ((2, 2), ("data", "model")),
          "(1, 2, 2)": ((1, 2, 2), ("pod", "data", "model")),
          "(1, 4)": ((1, 4), ("data", "model"))}
#: the meshes whose "model" axis the smoke config's 2 heads divide
HEADS_SPLIT = {"(2, 2)": True, "(1, 2, 2)": True, "(1, 4)": False}
BATCHES = (1, 2)
#: batch 3 on the (2, 2) mesh: "data" does not divide it, each rank holds all 3 rows
ODD = 3
WORLD = 4
JOIN_TIMEOUT = 240
CAPACITY, PROMPT, STEPS = 32, 14, 4
SEED = 26
ENGINE_TOL, REF_TOL = 1e-5, 1e-4
CASES = [(m, b) for m in MESHES for b in BATCHES] + [("(2, 2)", ODD)]
IDS = [f"{m}-B{b}" for m, b in CASES]
#: a prompt prefilled in parts from these cache indices
PARTS = (0, 9, 18, 24)
TRAIN_MESHES = ("(2, 2)", "(1, 4)")
TRAIN_B, TRAIN_S = 4, 32
TCFG = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1)
ATOL, RTOL = 1e-5, 1e-4
#: the first step's gradients: each leaf's largest gap over its largest |gradient|
#: (``tests/test_torch_train.py``'s bound for xlstm)
GRAD_RTOL = 1e-5
#: the embedding after the AdamW steps (see the module docstring)
EMBED_ATOL = 2e-4


def _cfg():
    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke_config(ARCH), compute_dtype="float32",
                               serve_param_dtype="float32")


def _model(cfg):
    from repro_torch.models import init_model_params

    return init_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")


def _tokens(batch: int) -> tuple:
    """``(prompt [B, S], [decode tokens [B, 1] of each step])`` as numpy."""
    rng = np.random.RandomState(SEED + batch)
    vocab = _cfg().vocab
    prompt = rng.randint(0, vocab, (batch, PROMPT))
    return prompt, [rng.randint(0, vocab, (batch, 1)) for _ in range(STEPS)]


def _leaves(a, b=None):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], None if b is None else b[k])
    else:
        yield a, b


def _cache_gap(sharded, want) -> float:
    """The largest gap of the gathered cache over the one-process one, each
    leaf's over ``max(1, its largest |value|)`` (every rank gathers every
    leaf: a short-circuit would leave the others waiting)."""
    return max([float((s.full_tensor() - w).abs().max() / max(1.0, float(w.abs().max())))
                for s, w in _leaves(sharded, want)])


# -- the ranks ----------------------------------------------------------------------------------


class _ScanCalls:
    """Records the heads of each ``ssm_xlstm._slstm_scan`` call (``R``'s
    dim 1) while active."""

    def __init__(self):
        from repro_torch.models import ssm_xlstm

        self.module, self.heads = ssm_xlstm, []
        self.scan = ssm_xlstm._slstm_scan

    def __enter__(self):
        def counted(p, *args, **kwargs):
            self.heads.append(int(p.r_zifo.shape[1]))
            return self.scan(p, *args, **kwargs)

        self.module._slstm_scan = counted
        return self

    def __exit__(self, *exc):
        self.module._slstm_scan = self.scan
        return False


def _serve(cfg, mesh, model, batch: int) -> tuple:
    """The sharded prefill and the teacher-forced decode steps with a
    float32 cache: ``(logits, cache, scan heads of the prefill, of each
    decode step)``."""
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache

    prompt, fed = _tokens(batch)
    prefill = build_step(cfg, "prefill_32k", mesh)
    decode = build_step(cfg, "decode_32k", mesh)
    smodel, sbatch, cache = prefill.shard(copy.deepcopy(model),
                                          {"tokens": torch.from_numpy(prompt)},
                                          init_cache(cfg, batch, CAPACITY, torch.float32,
                                                     device="cpu"))
    with _ScanCalls() as calls:
        logits, cache = prefill.step(smodel, sbatch, cache)
    scans = [calls.heads]
    out = [logits.full_tensor()]
    for i, tok in enumerate(fed):
        with _ScanCalls() as calls:
            logits, cache = decode.step(smodel, decode.shard(None, torch.from_numpy(tok))[1],
                                        cache, prompt.shape[-1] + i)
        scans.append(calls.heads)
        out.append(logits.full_tensor())
    return out, cache, scans


def _case_serve(ctx) -> tuple:
    """Every mesh and batch against the one-process ``Engine``: ``(summary,
    sharded logits)``."""
    from repro_torch.models import init_cache
    from repro_torch.serve import Engine

    cfg = _cfg()
    model = _model(cfg)
    summary, logits = {}, {}
    for batch in (*BATCHES, ODD):
        prompt, fed = _tokens(batch)
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
            got, scache, scans = _serve(cfg, mesh, model, batch)
            key = f"{name}-B{batch}"
            summary[key] = {
                "engine": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                "cache": _cache_gap(scache, cache),
                # each leaf's placement over "model"
                "placements": {f"{pos}.{leaf}": str(t.placements[mesh.mesh_dim_names.index(
                    "model")]) for pos, c in scache["stack"].items() for leaf, t in c.items()},
                "scans": scans,
            }
            logits[key] = got
    return summary, logits


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
    every mesh and in one process: the largest logit and cache gaps."""
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache
    from repro_torch.models.sharding import wrap_with_sharding_ctx

    cfg = _cfg()
    model = _model(cfg)
    prompt = torch.from_numpy(np.random.RandomState(SEED).randint(0, cfg.vocab, (1, PARTS[-1])))
    parts = [prompt[:, a:z] for a, z in zip(PARTS, PARTS[1:])]
    cache = init_cache(cfg, 1, CAPACITY, torch.float32, device="cpu")
    want = []
    for ci, part in zip(PARTS, parts):
        logits, cache = _prefill_at(model, part, cache, ci)
        want.append(logits)
    out = {}
    for name, mesh in ctx["meshes"].items():
        cell = build_step(cfg, "prefill_32k", mesh)
        step = wrap_with_sharding_ctx(_prefill_at, mesh, cell.rules)
        smodel, _, scache = cell.shard(copy.deepcopy(model), {"tokens": parts[0]},
                                       init_cache(cfg, 1, CAPACITY, torch.float32, device="cpu"))
        got = []
        for ci, part in zip(PARTS, parts):
            logits, scache = step(smodel, cell.shard(None, {"tokens": part}, None)[1]["tokens"],
                                  scache, ci)
            got.append(logits.full_tensor())
        out[name] = {
            "logits": max(float((g - w).abs().max()) for g, w in zip(got, want)),
            "cache": _cache_gap(scache, cache),
        }
    return out


def _case_train(ctx, name: str) -> dict:
    """2 float32 steps of ``build_step``'s train cell on ``name``'s mesh
    and of the one-process step, from the same weights and batches."""
    from repro_torch.launch.specs import build_step
    from repro_torch.train import SyntheticLM, TrainConfig, adamw, make_train_step, warmup_cosine

    cfg = _cfg()
    model = _model(cfg)
    plain = copy.deepcopy(model)
    tcfg = TrainConfig(**TCFG)
    opt = adamw(warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps), eps=1e-4,
                weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)
    cell = build_step(cfg, "train_4k", ctx["meshes"][name], tcfg, opt=opt)
    plain_step = make_train_step(cfg, opt)
    plain_state = opt.init(dict(plain.named_parameters()))
    smodel, sstate = cell.shard(copy.deepcopy(model),
                                opt.init(dict(model.named_parameters())))[:2]
    data = SyntheticLM(cfg, batch=TRAIN_B, seq=TRAIN_S, seed=3)
    grads = _grad_gaps(cfg, model, cell, data.batch_at(0))
    losses, scans = [], []
    for i in range(2):
        batch = data.next_batch()
        plain, plain_state, pm = plain_step(plain, plain_state, i, batch)
        sbatch = cell.shard(None, None, None, batch)[3]
        with _ScanCalls() as calls:
            smodel, sstate, sm = cell.step(smodel, sstate, i, sbatch)
        scans.append(calls.heads)
        losses.append((float(sm["loss"]), float(pm["loss"])))
    want = dict(plain.named_parameters())
    gaps = {}
    for pname, p in smodel.named_parameters():
        got, w = p.full_tensor().detach(), want[pname].detach()
        gaps[pname] = float(((got - w).abs() - RTOL * w.abs()).max())
    return {"losses": losses, "gaps": gaps, "grads": grads, "scans": scans}


def _grad_gaps(cfg, model, cell, batch) -> dict:
    """The first batch's loss gradients, sharded (gathered) and one-process
    from the same weights: each leaf's largest gap over its largest
    |gradient|."""
    from repro_torch.models import loss_fn
    from repro_torch.models.sharding import wrap_with_sharding_ctx

    plain = copy.deepcopy(model)
    smodel = cell.shard(copy.deepcopy(model))[0]
    names = [n for n, _ in plain.named_parameters()]
    for p in (*plain.parameters(), *smodel.parameters()):
        p.requires_grad_(True)
    want = torch.autograd.grad(loss_fn(plain, batch)[0], list(plain.parameters()))
    sharded_loss = wrap_with_sharding_ctx(lambda m, b: loss_fn(m, b)[0], cell.mesh, cell.rules)
    got = torch.autograd.grad(sharded_loss(smodel, cell.shard(None, None, None, batch)[3]),
                              list(smodel.parameters()))
    return {n: float((g.full_tensor() - w).abs().max() / w.abs().max())
            for n, g, w in zip(names, got, want)}


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
    cases = ([("serve", _case_serve, ()), ("prefix", _case_prefix, ())]
             + [(f"train {m}", _case_train, (m,)) for m in TRAIN_MESHES])
    for name, fn, args in cases:
        t0 = time.perf_counter()
        try:
            value = fn(ctx, *args)
            if name == "serve":
                value, logits = value
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
    float32 cache on the port's weights: ``{batch: [logits of each step]}``."""
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro import models as ref_models
    from repro.serve import make_decode_step, make_prefill_step
    from repro_torch.models.transfer import params_tree

    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), compute_dtype="float32")
    params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params_tree(_model(_cfg())))
    prefill, decode = jax.jit(make_prefill_step(ref_cfg)), jax.jit(make_decode_step(ref_cfg))
    out = {}
    for batch in (*BATCHES, ODD):
        prompt, fed = _tokens(batch)
        cache = ref_models.init_cache(ref_cfg, batch, CAPACITY, dtype=jnp.float32)
        logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)}, cache)
        steps = [np.asarray(logits)]
        for i, tok in enumerate(fed):
            logits, cache = decode(params, jnp.asarray(tok), cache, prompt.shape[-1] + i)
            steps.append(np.asarray(logits))
        out[batch] = steps
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import torch.multiprocessing as mp

    data_dir = str(tmp_path_factory.mktemp("xlstm_sharded"))
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


@pytest.mark.parametrize("mesh,batch", CASES, ids=IDS)
def test_sharded_serving_matches_the_engine(results, mesh, batch):
    v = _value(results, "serve")[f"{mesh}-B{batch}"]
    assert v["engine"] <= ENGINE_TOL, v


@pytest.mark.parametrize("mesh,batch", CASES, ids=IDS)
def test_sharded_serving_matches_the_reference(results, mesh, batch):
    _value(results, "serve")
    got = results["_logits"][f"{mesh}-B{batch}"]
    want = results["_reference"][batch]
    assert len(got) == len(want) == 1 + STEPS
    worst = max(float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want))
    assert worst <= REF_TOL, worst


@pytest.mark.parametrize("mesh,batch", CASES, ids=IDS)
def test_gathered_cache_equals_the_one_process_cache(results, mesh, batch):
    v = _value(results, "serve")[f"{mesh}-B{batch}"]
    assert v["cache"] <= ENGINE_TOL, v


@pytest.mark.parametrize("mesh,batch", CASES, ids=IDS)
def test_caches_keep_their_serving_placements(results, mesh, batch):
    """The stacked leaves ``[L, B, H, ...]``: over heads (dim 2) where the
    heads split, else the mLSTM ``C`` / ``n`` and the sLSTM ``c`` / ``n`` /
    ``h`` along ``head_dim`` (dim 3) and both ``m`` whole over "model"."""
    v = _value(results, "serve")[f"{mesh}-B{batch}"]
    assert len(v["placements"]) == 7, v  # C, n, m; c, n, h, m
    for key, got in v["placements"].items():
        if HEADS_SPLIT[mesh]:
            want = "S(2)"
        else:
            want = "R" if key.endswith(".m") else "S(3)"
        assert got == want, (key, got)


@pytest.mark.parametrize("mesh,batch", CASES, ids=IDS)
def test_slstm_scan_runs_once_a_block_on_the_local_heads(results, mesh, batch):
    """One scan an sLSTM block (2 in the smoke config) in the prefill and in
    each decode step, on this rank's head where the heads split, else on
    both."""
    v = _value(results, "serve")[f"{mesh}-B{batch}"]
    heads = 1 if HEADS_SPLIT[mesh] else 2
    assert v["scans"] == [[heads, heads]] * (1 + STEPS), v["scans"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_in_parts_matches_one_process(results, mesh):
    v = _value(results, "prefix")[mesh]
    assert v["logits"] <= ENGINE_TOL and v["cache"] <= ENGINE_TOL, v


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_sharded_train_losses_match_one_process(results, mesh):
    v = _value(results, f"train {mesh}")
    for got, want in v["losses"]:
        assert abs(got - want) <= ATOL + RTOL * abs(want), v["losses"]
    # an sLSTM block a superblock, 2 superblocks; remat reruns each superblock's forward in
    # the backward pass
    heads = 1 if HEADS_SPLIT[mesh] else 2
    assert v["scans"] == [[heads] * 4] * 2, v["scans"]


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_sharded_gradients_match_one_process(results, mesh):
    v = _value(results, f"train {mesh}")
    assert len(v["grads"]) == 31, v["grads"]
    worst = max(v["grads"].items(), key=lambda kv: kv[1])
    assert worst[1] <= GRAD_RTOL, worst


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_sharded_train_params_match_one_process(results, mesh):
    v = _value(results, f"train {mesh}")
    bad = {n: g for n, g in v["gaps"].items()
           if g > (EMBED_ATOL if n == "embed" else ATOL)}
    assert not bad, bad


def test_the_spawn_stays_inside_its_budget(results):
    assert results["_failure"] is None, results["_failure"]
    assert results["_seconds"] < JOIN_TIMEOUT
