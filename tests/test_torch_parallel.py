"""The port's multi-device path on 4 CPU processes (gloo), a (2, 2)
("data", "model") mesh.

One spawn serves every case: the parent draws the reference's weights
(``repro.models.init_model_params``, carried across by ``params_from_jax``)
and writes them to ``tmp_path``; 4 spawned ranks meet through a
``FileStore`` there (no port, so parallel test workers never collide), each
with one torch thread, run the cases in turn and write their results; the
parent joins them with a 240-s timeout, so a hang fails the tests instead of
eating the suite's limit.  Each test reads its case's result.

* **Train step.**  ``launch.specs.build_step(cfg, "train_4k", mesh)`` under
  ``TRAIN_RULES`` (batch over "data", sequence parallelism and heads / FFN
  width / experts / vocabulary over "model", FSDP: the weights' d_model dim
  over "data"), 2 steps on the smoke configs of tinyllama (dense, GQA),
  qwen3-moe (experts over "model", Adafactor), zamba2 (SSD heads over
  "model", the shared attention block, the tied head), gemma2 (windows,
  softcaps, sandwich norms), deepseek-v2-lite (MLA over heads, shared
  experts), musicgen (audio codebooks) and llava (the image embeddings, the
  masked loss; these four from the port's own seeded init), and tinyllama
  with 2 microbatches (each the batch's contiguous rows, as in the
  one-process step, laid over the data shards by ``train_loop._rows``; a
  MoE model's microbatches are ``tests/test_torch_moe_sharded.py``'s), in
  float32 compute: the loss and every gathered
  parameter within atol 1e-5 / rtol 1e-4 of the one-process port step from
  the same weights and batches (the tolerance of ``test_torch_train.py``:
  float32 sums in another order — partial sums over heads, the
  vocab-parallel logsumexp).  AdamW runs with eps 1e-4, as in
  ``test_torch_train_step.py``, whose docstring says why.
* **Serving.**  tinyllama's prefill and decode cells under ``SERVE_RULES``:
  the first logits with a float32 cache within atol 1e-5 / rtol 1e-4 of the
  unsharded prefill step's (a bf16 cache turns float32 differences into
  bf16 roundings of k / v), and with the ``Engine``'s bf16 cache the 8
  greedy tokens of each of 4 prompts equal to the ``Engine``'s.  smollm's
  (3 heads, 3 kv heads: neither divides "model", so the KV cache is split
  along ``head_dim``): a prefill and 4 decode steps on the (2, 2) mesh and
  on the (1, 2) halves of a (2, 1, 2) mesh, float32 with a float32 cache,
  every logit within 1e-5 of the one-process ``Engine``'s.
* **Sharded init.**  ``make_sharded_init`` gathered is bit for bit
  ``init_model_params`` with the same seed; the optimizer state is zeros
  in its placements.
* **Compression.**  ``compressed_psum`` equals, bit for bit, an integer
  emulation of the shared-scale sum computed from all 4 ranks' inputs; the
  error-feedback residual of ``wrap_grad_fn`` over 3 steps follows the
  reference's formula ``new_r = g + r - red / world``.
* **Pipeline.**  ``pipelined_apply`` at 4 stages, M = 8: outputs and the
  gradients of x and of the stacked parameters within 1e-5 of the
  sequential composition (the reference only asks for nonzero gradients);
  ``make_pp_train_step``'s SGD step equals the sequential one.
* **Scheduler.**  ``slice_mesh`` splits the mesh along "data" into 2 slices
  of 2 devices that feed ``TrialSliceScheduler``, as in the reference's
  ``test_trial_slice_scheduler_backfills``.
"""

import dataclasses
import json
import logging
import os
import time
import traceback

import numpy as np
import pytest
import torch

#: trained from the reference's weights
REF_ARCHS = ["tinyllama-1.1b", "qwen3-moe-235b-a22b", "zamba2-1.2b"]
#: trained from the port's own seeded init (the comparison is port against port)
TRAIN_ARCHS = REF_ARCHS + ["gemma2-9b", "deepseek-v2-lite-16b", "musicgen-medium",
                           "llava-next-34b"]
WORLD = 4
JOIN_TIMEOUT = 240
B, S = 4, 32
TCFG = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1)
ATOL, RTOL = 1e-5, 1e-4


def _cfg(arch):
    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="float32",
                               serve_param_dtype="float32")


def _close(got, want):
    """``(ok, worst excess over atol + rtol |want|)``."""
    excess = (got - want).abs() - (ATOL + RTOL * want.abs())
    worst = float(excess.max()) if excess.numel() else -1.0
    return worst <= 0.0, worst


# -- the ranks' cases --------------------------------------------------------------------------


def _case_train(ctx, arch, microbatch=0):
    import copy

    from repro_torch.launch.specs import build_step
    from repro_torch.models import Transformer, init_model_params
    from repro_torch.train import SyntheticLM, TrainConfig, adamw, make_train_step, warmup_cosine
    from repro_torch.train.train_loop import make_optimizer_for

    cfg = dataclasses.replace(_cfg(arch), train_microbatch=microbatch)
    mesh = ctx["mesh"]
    if arch in REF_ARCHS:
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(torch.load(os.path.join(ctx["dir"], f"{arch}.pt")))
    else:
        model = init_model_params(cfg, torch.Generator().manual_seed(6), "cpu")
    plain = copy.deepcopy(model)
    tcfg = TrainConfig(**TCFG)
    opt = make_optimizer_for(cfg, tcfg)
    if cfg.optimizer == "adamw":
        opt = adamw(warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps), eps=1e-4,
                    weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)
    cell = build_step(cfg, "train_4k", mesh, tcfg, opt=opt)
    step = cell.step
    plain_step = make_train_step(cfg, opt, microbatch)
    plain_state = opt.init(dict(plain.named_parameters()))
    smodel, sstate = cell.shard(model, opt.init(dict(model.named_parameters())))[:2]
    data = SyntheticLM(cfg, batch=B, seq=S, seed=3)
    losses = []
    for i in range(2):
        batch = data.next_batch()
        plain, plain_state, pm = plain_step(plain, plain_state, i, batch)
        sbatch = cell.shard(None, None, None, batch)[3]
        smodel, sstate, sm = step(smodel, sstate, i, sbatch)
        losses.append((float(sm["loss"]), float(pm["loss"])))
    want = dict(plain.named_parameters())
    bad, worst = [], -1.0
    sharded = 0
    for name, p in smodel.named_parameters():
        sharded += any(pl.is_shard() for pl in p.placements)
        ok, w = _close(p.full_tensor().detach(), want[name].detach())
        worst = max(worst, w)
        if not ok:
            bad.append(name)
    return {"losses": losses, "bad": bad, "worst": worst, "sharded": sharded,
            "n_params": len(want)}


def _case_serve(ctx):
    import copy

    from repro_torch.launch.specs import build_step
    from repro_torch.models import Transformer, init_cache
    from repro_torch.serve import Engine

    cfg = _cfg("tinyllama-1.1b")
    mesh = ctx["mesh"]
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(ctx["dir"], "tinyllama-1.1b.pt")))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=16) for _ in range(4)]
    engine = Engine(cfg, copy.deepcopy(model), capacity=64, slots=4, device="cpu")
    want = engine.generate(prompts, max_new=8)
    tokens = torch.from_numpy(np.stack(prompts)).long()
    want_logits = engine._prefill(engine.model, {"tokens": tokens},
                                  init_cache(cfg, 4, 64, torch.float32, device="cpu"))[0]
    prefill = build_step(cfg, "prefill_32k", mesh)
    decode = build_step(cfg, "decode_32k", mesh)
    smodel, sbatch, cache = prefill.shard(model, {"tokens": tokens},
                                          init_cache(cfg, 4, 64, torch.float32, device="cpu"))
    logits, _ = prefill.step(smodel, sbatch, cache)
    ok, worst = _close(logits.full_tensor(), want_logits)
    # the greedy tokens with the Engine's bf16 cache
    cache = prefill.shard(None, None, init_cache(cfg, 4, 64, device="cpu"))[2]
    logits, cache = prefill.step(smodel, sbatch, cache)
    got = [[] for _ in prompts]
    index = tokens.shape[1]
    for i in range(8):
        tok = torch.argmax(logits.full_tensor(), dim=-1)
        for j in range(len(prompts)):
            got[j].append(int(tok[j, 0]))
        if i + 1 < 8:
            logits, cache = decode.step(smodel, decode.shard(None, tok[:, :1])[1], cache, index)
            index += 1
    cache_sharded = [str(t.placements) for t in cache["stack"]["0"].values()]
    return {"logits_ok": ok, "worst": worst, "got": got, "want": want,
            "cache": cache_sharded}


def _case_head_dim_cache(ctx):
    """smollm's smoke config (3 heads, 3 kv heads of 16) under ``SERVE_RULES``:
    neither head count divides "model", so the KV cache is split along
    ``head_dim``; a prefill and 4 decode steps (teacher-forced with the
    ``Engine``'s greedy tokens), float32 with a float32 cache, on the (2, 2)
    mesh and on the (1, 2) halves of a (2, 1, 2) mesh (two processes each)."""
    import copy

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache, init_model_params
    from repro_torch.serve import Engine

    cfg = _cfg("smollm-135m")
    model = init_model_params(cfg, torch.Generator().manual_seed(11), "cpu")
    rng = np.random.RandomState(11)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, size=(4, 16))).long()
    capacity, steps = 32, 4
    f32_cache = lambda: init_cache(cfg, 4, capacity, torch.float32, device="cpu")  # noqa: E731
    engine = Engine(cfg, copy.deepcopy(model), capacity=capacity, slots=4, device="cpu")
    logits, cache = engine._prefill(engine.model, {"tokens": tokens}, f32_cache())
    want, fed = [logits], []
    for i in range(steps):
        fed.append(torch.argmax(logits, dim=-1)[:, :1])
        logits, cache = engine._decode(engine.model, fed[-1], cache, tokens.shape[1] + i)
        want.append(logits)
    halves = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("replica", "data", "model"))
    out = {}
    for name, mesh in (("(2, 2)", ctx["mesh"]), ("(1, 2)", halves["data", "model"])):
        prefill = build_step(cfg, "prefill_32k", mesh)
        decode = build_step(cfg, "decode_32k", mesh)
        smodel, sbatch, scache = prefill.shard(copy.deepcopy(model), {"tokens": tokens},
                                               f32_cache())
        logits, scache = prefill.step(smodel, sbatch, scache)
        got = [logits.full_tensor()]
        for i in range(steps):
            logits, scache = decode.step(smodel, decode.shard(None, fed[i])[1], scache,
                                         tokens.shape[1] + i)
            got.append(logits.full_tensor())
        out[name] = {"worst": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                     "cache": [str(t.placements) for t in scache["stack"]["0"].values()]}
    return out


def _case_init(ctx):
    from repro_torch.models import init_model_params
    from repro_torch.models.sharding import TRAIN_RULES
    from repro_torch.train import TrainConfig
    from repro_torch.train.train_loop import make_optimizer_for, make_sharded_init

    out = {}
    for arch in ("tinyllama-1.1b", "qwen3-moe-235b-a22b"):
        cfg = _cfg(arch)
        opt = make_optimizer_for(cfg, TrainConfig())
        init, p_sh, o_sh = make_sharded_init(cfg, opt, ctx["mesh"], TRAIN_RULES)
        model, state = init(torch.Generator().manual_seed(11))
        plain = dict(init_model_params(cfg, torch.Generator().manual_seed(11), "cpu")
                     .named_parameters())
        equal = all(torch.equal(p.full_tensor(), plain[n]) for n, p in model.named_parameters())
        local = sum(p.to_local().numel() for p in model.parameters())
        leaves = list(_leaves(state))
        zeros = all(float(t.full_tensor().abs().max()) == 0.0 for t in leaves)
        out[arch] = {"equal": equal, "local": local, "total": sum(t.numel() for t in plain.values()),
                     "zeros": zeros, "state_sharded": sum(any(pl.is_shard() for pl in t.placements)
                                                          for t in leaves)}
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _case_compression(ctx):
    import torch.distributed as dist

    from repro_torch.train.compression import compressed_psum, wrap_grad_fn

    rank = dist.get_rank()
    xs = [torch.from_numpy(np.random.RandomState(r).standard_normal((33, 7)).astype(np.float32)
                           * (r + 1)) for r in range(WORLD)]
    got = compressed_psum(xs[rank])
    gmax = max(float(x.abs().max()) for x in xs)
    scale = torch.tensor(gmax, dtype=torch.float32) / 127.0 + 1e-12
    total = sum(torch.clamp(torch.round(x / scale), -127, 127).to(torch.int64) for x in xs)
    want = total.to(torch.int32).to(torch.float32) * scale
    exact = torch.equal(got, want)
    rel = float((got - sum(xs)).abs().max() / sum(xs).abs().max())

    def grads(r, step):
        g = np.random.RandomState(100 * step + r).standard_normal((16,)).astype(np.float32)
        return {"w": torch.from_numpy(g)}

    calls = {"step": 0}
    reduced = wrap_grad_fn(lambda params, batch: grads(rank, calls["step"]))
    residual = {"w": torch.zeros(16)}
    follows = True
    for step in range(3):
        calls["step"] = step
        red, new_r = reduced(None, None, residual)
        gl = grads(rank, step)["w"] + residual["w"]
        follows &= torch.equal(red["w"], compressed_psum(gl))
        follows &= torch.equal(new_r["w"], gl - red["w"] / WORLD)
        residual = new_r
    return {"exact": exact, "rel": rel, "follows": bool(follows)}


def _case_pipeline(ctx):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train.pipeline_parallel import make_pp_train_step, pipelined_apply

    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
    g = torch.Generator().manual_seed(0)
    M, mb, d = 8, 2, 16
    params = torch.randn(WORLD, d, d, generator=g) * 0.3
    x = torch.randn(M, mb, d, generator=g)

    def stage_fn(w, h):
        return torch.tanh(h @ w)

    def sequential(p, xx):
        for i in range(WORLD):
            xx = stage_fn(p[i], xx)
        return xx

    p1, x1 = params.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = pipelined_apply(stage_fn, p1, x1, mesh)
    gp, gx = torch.autograd.grad((out ** 2).sum(), [p1, x1])
    import torch.distributed as dist

    dist.all_reduce(gp)  # each rank holds its stage's rows
    p2, x2 = params.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ref = sequential(p2, x2)
    gp2, gx2 = torch.autograd.grad((ref ** 2).sum(), [p2, x2])
    step = make_pp_train_step(stage_fn, lambda o, y: ((o - y) ** 2).mean(), mesh)
    y = torch.zeros_like(x)
    new, loss = step(params, x, y, 0.1)
    p3 = params.clone().requires_grad_(True)
    ref_loss = ((sequential(p3, x) - y) ** 2).mean()
    (g3,) = torch.autograd.grad(ref_loss, [p3])
    return {"out": float((out - ref).abs().max()), "gp": float((gp - gp2).abs().max()),
            "gx": float((gx - gx2).abs().max()), "gnorm": float(gp.abs().sum()),
            "loss": abs(float(loss) - float(ref_loss)),
            "step": float((new - (params - 0.1 * g3)).abs().max())}


def _case_scheduler(ctx):
    import torch.distributed as dist

    import repro_torch.core as hpo
    from repro_torch.launch.mesh import slice_mesh
    from repro_torch.tune.scheduler import TrialSliceScheduler

    slices = slice_mesh(ctx["mesh"], 2, axis="data")
    out = {"slices": [[str(d) for d in s] for s in slices]}
    if dist.get_rank() == 0:
        study = hpo.create_study(sampler=hpo.RandomSampler(seed=0),
                                 pruner=hpo.SuccessiveHalvingPruner(1, 2, 0))

        def run_trial(trial, devices):
            x = trial.suggest_float("x", 0, 1)
            for step in (1, 2, 4):
                time.sleep(0.02)  # simulated train epochs so slices overlap
                trial.report(x + step * 0.001, step)
                if trial.should_prune():
                    raise hpo.TrialPruned()
            return x

        sched = TrialSliceScheduler(study, slices, run_trial)
        sched.run(n_trials=16)
        out["n"] = len(study.trials)
        out["done"] = sum(t.state.name == "COMPLETE" for t in study.trials)
        out["pruned"] = sum(t.state.name == "PRUNED" for t in study.trials)
        out["used"] = sorted({e[1] for e in sched.events})
    dist.barrier()
    return out


CASES = ([(f"train:{a}", _case_train, (a,)) for a in TRAIN_ARCHS]
         + [("train:tinyllama-1.1b:microbatch", _case_train, ("tinyllama-1.1b", 2)),
            ("serve", _case_serve, ()), ("head_dim_cache", _case_head_dim_cache, ()),
            ("init", _case_init, ()),
            ("compression", _case_compression, ()), ("pipeline", _case_pipeline, ()),
            ("scheduler", _case_scheduler, ())])


def _rank(rank, world, store_path, data_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    # DTensor warns at each (Partial, Partial) -> Replicate of the scalar loss
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    ctx = {"mesh": make_host_mesh((2, 2), ("data", "model")), "dir": data_dir}
    results = {}
    for name, fn, args in CASES:
        t0 = time.perf_counter()
        try:
            results[name] = {"ok": True, "value": fn(ctx, *args)}
        except Exception:  # recorded for the parent, then the rank stops
            results[name] = {"ok": False, "error": traceback.format_exc()}
            with open(os.path.join(data_dir, f"results{rank}.json"), "w") as f:
                json.dump(results, f)
            raise
        results[name]["seconds"] = time.perf_counter() - t0
        with open(os.path.join(data_dir, f"results{rank}.json"), "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


# -- the parent --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    import torch.multiprocessing as mp
    from repro import configs as ref_configs
    from repro import models as ref_models
    from repro_torch.models import params_from_jax

    data_dir = str(tmp_path_factory.mktemp("parallel"))
    for arch in REF_ARCHS:
        ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), compute_dtype="float32")
        params = ref_models.init_model_params(ref_cfg, jax.random.PRNGKey(6))
        torch.save(params_from_jax(_cfg(arch), jax.tree.map(np.asarray, params)),
                   os.path.join(data_dir, f"{arch}.pt"))
    store = os.path.join(data_dir, "store")
    t0 = time.perf_counter()
    procs = mp.start_processes(_rank, args=(WORLD, store, data_dir), nprocs=WORLD,
                               start_method="spawn", join=False)
    failure = None
    try:
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
    out["_failure"] = failure
    out["_seconds"] = time.perf_counter() - t0
    return out


def _value(results, name):
    got = results.get(name)
    if got is None:
        pytest.fail(f"case {name} did not run: {results['_failure']}")
    assert got["ok"], got["error"]
    return got["value"]


@pytest.mark.parametrize("case", [f"train:{a}" for a in TRAIN_ARCHS]
                         + ["train:tinyllama-1.1b:microbatch"])
def test_sharded_train_step_matches_the_one_process_step(results, case):
    v = _value(results, case)
    for got, want in v["losses"]:
        assert abs(got - want) <= ATOL + RTOL * abs(want), v["losses"]
    assert v["bad"] == [], (v["bad"], v["worst"])
    assert v["sharded"] > 0  # the step really ran on shards


def test_sharded_serving_matches_the_engine(results):
    v = _value(results, "serve")
    assert v["logits_ok"], v["worst"]
    assert v["got"] == v["want"]
    # the stacked [L, B, T, KV, Dh] cache: batch over "data", kv heads over "model"
    assert v["cache"] == ["(Shard(dim=1), Shard(dim=3))"] * 2, v["cache"]


@pytest.mark.parametrize("mesh", ["(2, 2)", "(1, 2)"])
def test_head_dim_cache_matches_the_engine(results, mesh):
    """The attention block's partial scores over ``head_dim``, summed over
    "model", give the one-process ``Engine``'s logits within 1e-5 (float32
    sums in another order)."""
    v = _value(results, "head_dim_cache")[mesh]
    assert v["worst"] <= 1e-5, v["worst"]
    # the stacked [L, B, T, KV, Dh] cache: batch over "data", head_dim over "model"
    assert v["cache"] == ["(Shard(dim=1), Shard(dim=4))"] * 2, v["cache"]


def test_sharded_init_is_the_plain_init(results):
    v = _value(results, "init")
    for arch, r in v.items():
        assert r["equal"], arch
        assert r["zeros"], arch
        assert r["local"] < r["total"], arch  # no rank holds the whole model
        assert r["state_sharded"] > 0, arch


def test_compressed_psum_and_error_feedback(results):
    v = _value(results, "compression")
    assert v["exact"]
    assert v["rel"] < 0.05  # the reference test's int8 bound
    assert v["follows"]


def test_pipeline_matches_the_sequential_composition(results):
    v = _value(results, "pipeline")
    assert v["out"] <= 1e-5 and v["gx"] <= 1e-5 and v["gp"] <= 1e-5, v
    assert v["gnorm"] > 0
    assert v["loss"] <= 1e-6 and v["step"] <= 1e-5, v


def test_slice_mesh_feeds_the_trial_slice_scheduler(results):
    v = _value(results, "scheduler")
    assert v["slices"] == [["cpu", "cpu"], ["cpu", "cpu"]]
    assert v["n"] == 16 and v["done"] >= 1 and v["pruned"] >= 1
    assert len(v["used"]) >= 2  # concurrent slices got work (backfill)


def test_the_spawn_stays_inside_its_budget(results):
    assert results["_failure"] is None, results["_failure"]
    assert results["_seconds"] < JOIN_TIMEOUT
