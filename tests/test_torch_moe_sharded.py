"""The port's MoE training under a mesh on 4 CPU processes (gloo):
microbatches laid out as the reference's, thin microbatches side by side,
the sort dispatch with the batch split and with experts over "model", and
the born-sharded init.

qwen3-moe-235b-a22b's smoke config (8 experts, top-2, 2 layers), float32
compute.  Every train case runs 2 steps of ``launch.specs.build_step``'s
train cell from the same weights and batches as the one-process port step
(``make_train_step``, the config's Adafactor) and holds each step's loss and
every gathered parameter within atol 1e-5 / rtol 1e-4 (float32 sums in
another order):

* **Microbatches** (``train_microbatch`` 2, 4 x 32 tokens, a (2, 2)
  ("data", "model") mesh): microbatch ``i`` is the batch's rows ``[2i, 2i +
  2)`` in the sharded step too, as in the one-process step and the
  reference.  The loss is ``ce + 0.01 aux``, and the Switch aux term is a
  product of two means over a microbatch's tokens, so it sees which rows
  share a microbatch.  The losses are also held to the reference's jitted
  one-device step (``repro.train.make_train_step(cfg, opt, 2)``) on the
  port's weights carried into its tree (``params_tree``), within the same
  tolerance; the parent computes them while the ranks run.  So are the
  thin cases' losses (``make_train_step(cfg, opt, 4)``) and the sort
  dispatch's train losses (no microbatches).
* **Thin microbatches** (8 x 32 tokens, 4 microbatches of 2 rows on a (2,
  2, 1) ("pod", "data", "model") mesh, both dispatches): a microbatch's 2
  rows lie over "data", the two pods run one each side by side, so 2
  iterations hold the 4 microbatches; the einsum dispatch's 64-token group
  spans the microbatch's two shards.  llava's smoke config takes the same
  layout: its loss masks the image positions, and each microbatch's mean
  counts its own rows' tokens.  ``_rows`` raises where no layout
  exists: 2 rows a microbatch over a 4-way "data" axis with 2 microbatches.
  A thin iteration's gradients taken after its contexts are left (on the
  card the autograd engine's thread takes them, and runs each
  superblock's remat recomputation there) still see 2 microbatches side by
  side.
* **The sort dispatch** (``moe_dispatch="sort"``) on (2, 2) (the batch over
  "data", the experts over "model") and (1, 4) (the batch whole, 2 experts a
  rank): 2 train steps; the loss and its gradients on a batch of one
  repeated token, each gathered gradient within the same atol / rtol (on
  this batch the first layer's q / k gradients are zero but for float32
  noise: attention over equal values ignores them); and, served, a
  prefill of 2 prompts of 14 tokens and 4 teacher-forced decode steps with
  float32 caches against the one-process ``Engine``, each logit within atol
  1e-5 / rtol 1e-4, for a prompt of one repeated token and a random one.
  One repeated token gives every position of the first layer the same MoE
  input, so all of a batch's tokens choose the same 2 experts: in the
  prefill 28 tokens against a capacity of 9, and on (2, 2) the second
  shard's pairs rank 0 to 13 there but 14 to 27 in the batch, so that those
  below 9 are dropped only because of the first shard's counts; the test
  counts them over the ranks.  Two sharded prefills give the same bits.
  The repeated batch takes no optimizer step: Adafactor normalizes the
  float32 noise of the gradients near zero that its many dropped pairs
  leave (the einsum dispatch's sharded step drifted 0.05 from the
  one-process one on it after one step).
* **Born-sharded init** on (2, 2) and (1, 4): ``make_sharded_init``'s
  largest single draw (recorded by a ``TorchDispatchMode`` at each
  ``randn``) is one layer slice of the largest stacked leaf, and gathered
  the parameters equal ``init_model_params`` bit for bit.

One spawn of 4 ranks serves every case, as in
``tests/test_torch_xlstm_sharded.py``: a ``FileStore`` in ``tmp_path``, one
torch thread a rank, a join timeout; a rank that raises in a case writes its
traceback to its results file and goes on with the next case.
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

ARCH = "qwen3-moe-235b-a22b"
#: a thin case of a masked loss
VLM = "llava-next-34b"
MESHES = {"(2, 2)": ((2, 2), ("data", "model")),
          "(1, 4)": ((1, 4), ("data", "model")),
          "(2, 2, 1)": ((2, 2, 1), ("pod", "data", "model")),
          "(4, 1)": ((4, 1), ("data", "model"))}
SORT_MESHES = ("(2, 2)", "(1, 4)")
INIT_MESHES = ("(2, 2)", "(1, 4)")
WORLD = 4
JOIN_TIMEOUT = 240
SEED = 27
B, S = 4, 32
THIN_B, THIN_M = 8, 4
TCFG = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1)
ATOL, RTOL = 1e-5, 1e-4
CAPACITY, PROMPT, STEPS = 32, 14, 4
#: served: the prompts' batch, each prompt one repeated token or random tokens
SERVE_B = 2
PROMPTS = ("repeated", "random")


def _cfg(**over):
    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke_config(ARCH), compute_dtype="float32",
                               serve_param_dtype="float32", **over)


def _model(cfg):
    """The port's seeded init (its weights cross to the reference by
    ``params_tree``)."""
    from repro_torch.models import init_model_params

    return init_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")


def _excess(got, want) -> float:
    """The largest ``|got - want| - (atol + rtol |want|)``."""
    return float(((got - want).abs() - (ATOL + RTOL * want.abs())).max())


def _batches(cfg, batch: int, repeated: bool = False) -> list:
    """2 train batches of ``batch`` x ``S``: ``SyntheticLM``'s, the first
    one repeated token with ``repeated``."""
    from repro_torch.train import SyntheticLM

    data = SyntheticLM(cfg, batch=batch, seq=S, seed=3)
    out = [data.batch_at(i) for i in range(2)]
    if repeated:
        out[0] = {"tokens": torch.full_like(out[0]["tokens"], 7), "labels": out[0]["labels"]}
    return out


class _SortCalls:
    """Counts, in each sharded ``_moe_sort`` call, the pairs whose rank
    among this shard's pairs of their expert is below the capacity while
    their rank in the microbatch is not: the pairs the earlier shards'
    counts drop."""

    def __init__(self):
        from repro_torch.models import tensor_parallel

        self.module, self.fn, self.dropped = tensor_parallel, tensor_parallel._moe_sort, []

    def __enter__(self):
        from repro_torch.models.moe import _capacity

        def recorded(p, xt, w, idx, cfg, experts=None, before=None, tokens=None):
            if before is not None:
                C = _capacity(tokens, cfg)
                seen = np.zeros(cfg.moe_experts, dtype=np.int64)
                n = 0
                for e in idx.reshape(-1).tolist():  # token-major
                    n += int(seen[e] < C <= seen[e] + int(before[e]))
                    seen[e] += 1
                self.dropped.append(n)
            return self.fn(p, xt, w, idx, cfg, experts=experts, before=before, tokens=tokens)

        self.module._moe_sort = recorded
        return self

    def __exit__(self, *exc):
        self.module._moe_sort = self.fn
        return False


class _LossCalls:
    """Counts the sharded cross-entropy's calls (one a step's iteration)."""

    def __enter__(self):
        from repro_torch.models import tensor_parallel

        self.module, self.fn, self.n = tensor_parallel, tensor_parallel.cross_entropy, 0

        def counted(*args, **kwargs):
            self.n += 1
            return self.fn(*args, **kwargs)

        self.module.cross_entropy = counted
        return self

    def __exit__(self, *exc):
        self.module.cross_entropy = self.fn
        return False


# -- the ranks ----------------------------------------------------------------------------------


def _dropped_everywhere(n: int) -> int:
    """``n`` summed over the ranks."""
    import torch.distributed as dist

    t = torch.tensor([n], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t[0])


def _train(ctx, mesh_name: str, cfg, batches: list, microbatch: int) -> dict:
    """2 steps of the sharded train cell and of the one-process step from
    the same weights: losses and each parameter's excess."""
    from repro_torch.launch.specs import build_step
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.train_loop import make_optimizer_for

    cfg = dataclasses.replace(cfg, train_microbatch=microbatch)
    model = _model(cfg)
    plain = copy.deepcopy(model)
    opt = make_optimizer_for(cfg, TrainConfig(**TCFG))
    cell = build_step(cfg, "train_4k", ctx["meshes"][mesh_name], opt=opt)
    plain_step = make_train_step(cfg, opt, microbatch)
    plain_state = opt.init(dict(plain.named_parameters()))
    smodel, sstate = cell.shard(model, opt.init(dict(model.named_parameters())))[:2]
    losses, iterations = [], []
    for i, batch in enumerate(batches):
        plain, plain_state, pm = plain_step(plain, plain_state, i, batch)
        with _LossCalls() as calls:
            smodel, sstate, sm = cell.step(smodel, sstate, i,
                                           cell.shard(None, None, None, batch)[3])
        losses.append((float(sm["loss"]), float(pm["loss"])))
        iterations.append(calls.n)
    want = dict(plain.named_parameters())
    gaps = {n: _excess(p.full_tensor().detach(), want[n].detach())
            for n, p in smodel.named_parameters()}
    return {"losses": losses, "gaps": gaps, "iterations": iterations}


def _grads(ctx, mesh_name: str, cfg, batch) -> dict:
    """The loss and its gradients on ``batch``, sharded and one-process from
    the same weights: the two losses, each gradient's excess, and the pairs
    the earlier shards' counts drop."""
    from repro_torch.launch.specs import build_step
    from repro_torch.models import loss_fn
    from repro_torch.models.sharding import wrap_with_sharding_ctx

    model = _model(cfg)
    cell = build_step(cfg, "train_4k", ctx["meshes"][mesh_name])
    smodel = cell.shard(copy.deepcopy(model))[0]
    names = [n for n, _ in model.named_parameters()]
    for p in (*model.parameters(), *smodel.parameters()):
        p.requires_grad_(True)
    loss = loss_fn(model, batch)[0]
    want = torch.autograd.grad(loss, list(model.parameters()))
    sharded_loss = wrap_with_sharding_ctx(lambda m, b: loss_fn(m, b)[0].full_tensor(), cell.mesh,
                                          cell.rules)
    with _SortCalls() as calls:
        got_loss = sharded_loss(smodel, cell.shard(None, None, None, batch)[3])
    got = torch.autograd.grad(got_loss, list(smodel.parameters()))
    gaps = {n: _excess(g.full_tensor(), w) for n, g, w in zip(names, got, want)}
    return {"losses": (float(got_loss), float(loss)), "grads": gaps,
            "dropped": _dropped_everywhere(sum(calls.dropped))}


def _case_microbatch(ctx) -> dict:
    cfg = _cfg()
    return _train(ctx, "(2, 2)", cfg, _batches(cfg, B), 2)


def _case_thin(ctx, dispatch: str) -> dict:
    cfg = _cfg(moe_dispatch=dispatch)
    return _train(ctx, "(2, 2, 1)", cfg, _batches(cfg, THIN_B), THIN_M)


def _case_thin_vlm(ctx) -> dict:
    """llava's smoke config, thin: its loss masks the image positions, and
    each microbatch's mean counts its own rows' unmasked tokens."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_smoke_config(VLM), compute_dtype="float32",
                              serve_param_dtype="float32")
    return _train(ctx, "(2, 2, 1)", cfg, _batches(cfg, THIN_B), THIN_M)


def _case_remat_context(ctx, dispatch: str) -> dict:
    """A thin iteration's loss under ``side_by_side`` and the mesh, its
    gradients taken inside both contexts and again after they are left, as
    the card's autograd engine takes them on its own thread: each
    superblock's remat recomputation must run with the forward's count.
    The count and the largest gap between the two gradients."""
    from repro_torch.launch.specs import build_step
    from repro_torch.models import loss_fn
    from repro_torch.models.sharding import activation_sharding
    from repro_torch.train.train_loop import _rows

    cfg = _cfg(moe_dispatch=dispatch, train_microbatch=THIN_M)
    cell = build_step(cfg, "train_4k", ctx["meshes"]["(2, 2, 1)"])
    smodel = cell.shard(_model(cfg))[0]
    params = list(smodel.parameters())
    for p in params:
        p.requires_grad_(True)
    parts, layout = _rows(cell.shard(None, None, None, _batches(cfg, THIN_B)[0])[3], THIN_M)
    grads = []
    for inside in (True, False):
        with activation_sharding(cell.mesh, cell.rules), layout:
            loss = loss_fn(smodel, parts[0])[0].full_tensor()
            if inside:
                grads.append(torch.autograd.grad(loss, params))
        if not inside:
            grads.append(torch.autograd.grad(loss, params))
    gap = max(float((a.full_tensor() - b.full_tensor()).abs().max()) for a, b in zip(*grads))
    return {"k": layout.k, "gap": gap}


def _case_no_layout(ctx) -> str:
    """2 microbatches of 2 rows on a 4-way "data" axis: the message."""
    from repro_torch.launch.specs import build_step
    from repro_torch.train import TrainConfig
    from repro_torch.train.train_loop import make_optimizer_for

    cfg = _cfg(train_microbatch=2)
    model = _model(cfg)
    opt = make_optimizer_for(cfg, TrainConfig(**TCFG))
    cell = build_step(cfg, "train_4k", ctx["meshes"]["(4, 1)"], opt=opt)
    smodel, sstate = cell.shard(model, opt.init(dict(model.named_parameters())))[:2]
    try:
        cell.step(smodel, sstate, 0, cell.shard(None, None, None, _batches(cfg, B)[0])[3])
    except NotImplementedError as e:
        return str(e)
    return "no error"


def _case_sort_train(ctx, mesh_name: str) -> dict:
    cfg = _cfg(moe_dispatch="sort")
    out = _train(ctx, mesh_name, cfg, _batches(cfg, B), 0)
    out["repeated"] = _grads(ctx, mesh_name, cfg, _batches(cfg, B, repeated=True)[0])
    return out


def _prompts(cfg, kind: str) -> tuple:
    """``(prompt [SERVE_B, PROMPT], [decode tokens [SERVE_B, 1] of each step])``."""
    rng = np.random.RandomState(SEED)
    prompt = (np.full((SERVE_B, PROMPT), 7) if kind == "repeated"
              else rng.randint(0, cfg.vocab, (SERVE_B, PROMPT)))
    return torch.from_numpy(prompt), [torch.from_numpy(rng.randint(0, cfg.vocab, (SERVE_B, 1)))
                                      for _ in range(STEPS)]


def _case_sort_serve(ctx, mesh_name: str) -> dict:
    """A prefill and the teacher-forced decode steps of each prompt kind,
    sharded and on the one-process ``Engine``: the largest excess, the
    drops by the earlier shards' counts, and whether two sharded prefills
    give the same bits."""
    from repro_torch.launch.specs import build_step
    from repro_torch.models import init_cache
    from repro_torch.serve import Engine

    cfg = _cfg(moe_dispatch="sort")
    mesh = ctx["meshes"][mesh_name]
    model = _model(cfg)
    prefill = build_step(cfg, "prefill_32k", mesh)
    decode = build_step(cfg, "decode_32k", mesh)
    cache = lambda: init_cache(cfg, SERVE_B, CAPACITY, torch.float32, device="cpu")  # noqa: E731
    smodel = prefill.shard(copy.deepcopy(model))[0]
    out = {}
    for kind in PROMPTS:
        prompt, fed = _prompts(cfg, kind)
        engine = Engine(cfg, copy.deepcopy(model), capacity=CAPACITY, slots=SERVE_B, device="cpu")
        logits, c = engine._prefill(engine.model, {"tokens": prompt}, cache())
        want = [logits]
        for i, tok in enumerate(fed):
            logits, c = engine._decode(engine.model, tok, c, PROMPT + i)
            want.append(logits)
        sbatch, scache = prefill.shard(None, {"tokens": prompt}, cache())[1:]
        with _SortCalls() as calls:
            logits, scache = prefill.step(smodel, sbatch, scache)
        again = prefill.step(smodel, sbatch, prefill.shard(None, None, cache())[2])[0]
        same_bits = torch.equal(logits.full_tensor(), again.full_tensor())
        got = [logits.full_tensor()]
        for i, tok in enumerate(fed):
            logits, scache = decode.step(smodel, decode.shard(None, tok)[1], scache, PROMPT + i)
            got.append(logits.full_tensor())
        out[kind] = {"excess": max(_excess(g, w) for g, w in zip(got, want)),
                     "dropped": _dropped_everywhere(sum(calls.dropped)),
                     "same_bits": same_bits}
    return out


class _Draws:
    """Records the element count of every ``randn`` while active."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        draws = self.draws = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func.overloadpacket is torch.ops.aten.randn:
                    draws.append(out.numel())
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _case_init(ctx, mesh_name: str) -> dict:
    from repro_torch.models import init_model_params
    from repro_torch.models.sharding import TRAIN_RULES
    from repro_torch.train import TrainConfig
    from repro_torch.train.train_loop import make_optimizer_for, make_sharded_init

    cfg = _cfg()
    opt = make_optimizer_for(cfg, TrainConfig())
    init, _, _ = make_sharded_init(cfg, opt, ctx["meshes"][mesh_name], TRAIN_RULES)
    with _Draws() as rec:
        model, _ = init(torch.Generator().manual_seed(SEED))
    with _Draws() as plain_rec:
        plain = dict(init_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
                     .named_parameters())
    equal = all([torch.equal(p.full_tensor(), plain[n]) for n, p in model.named_parameters()])
    return {"draws": rec.draws, "plain_draws": plain_rec.draws, "equal": equal}


def _rank(rank, world, store_path, data_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    ctx = {"meshes": {name: init_device_mesh("cpu", shape, mesh_dim_names=names)
                      for name, (shape, names) in MESHES.items()}}
    results = {}
    path = os.path.join(data_dir, f"results{rank}.json")
    cases = ([("microbatch", _case_microbatch, ()), ("no layout", _case_no_layout, ())]
             + [(f"thin {d}", _case_thin, (d,)) for d in ("einsum", "sort")]
             + [("thin vlm", _case_thin_vlm, ())]
             + [(f"remat {d}", _case_remat_context, (d,)) for d in ("einsum", "sort")]
             + [(f"sort train {m}", _case_sort_train, (m,)) for m in SORT_MESHES]
             + [(f"sort serve {m}", _case_sort_serve, (m,)) for m in SORT_MESHES]
             + [(f"init {m}", _case_init, (m,)) for m in INIT_MESHES])
    for name, fn, args in cases:
        t0 = time.perf_counter()
        try:
            results[name] = {"ok": True, "value": fn(ctx, *args),
                             "seconds": time.perf_counter() - t0}
        except Exception:  # recorded for the parent; every rank fails alike, so go on
            results[name] = {"ok": False, "error": traceback.format_exc()}
        with open(path, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


# -- the parent ----------------------------------------------------------------------------------


#: the reference's runs, by the case whose losses each holds: (arch, batch, microbatches, config)
REFERENCE = {"microbatch": (ARCH, B, 2, {}),
             "thin einsum": (ARCH, THIN_B, THIN_M, {"moe_dispatch": "einsum"}),
             "thin sort": (ARCH, THIN_B, THIN_M, {"moe_dispatch": "sort"}),
             "thin vlm": (VLM, THIN_B, THIN_M, {}),
             "sort train": (ARCH, B, 0, {"moe_dispatch": "sort"})}


def _reference_losses(arch: str, batch: int, microbatch: int, over: dict) -> list:
    """The reference's jitted one-device step with ``microbatch``
    microbatches on the port's weights and batches: each step's loss."""
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro import train as ref_train
    from repro.train.train_loop import make_optimizer_for as ref_make_optimizer_for
    from repro_torch import configs
    from repro_torch.models.transfer import params_tree

    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), compute_dtype="float32",
                                  **over)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="float32",
                              serve_param_dtype="float32", **over)
    params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params_tree(_model(cfg)))
    opt = ref_make_optimizer_for(ref_cfg, ref_train.TrainConfig(microbatch=microbatch, **TCFG))
    state = opt.init(params)
    step = jax.jit(ref_train.make_train_step(ref_cfg, opt, microbatch))
    data = ref_train.SyntheticLM(ref_cfg, batch=batch, seq=S, seed=3)
    losses = []
    for i in range(2):
        params, state, metrics = step(params, state, jnp.int32(i), data.batch_at(i))
        losses.append(float(metrics["loss"]))
    return losses


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import torch.multiprocessing as mp

    data_dir = str(tmp_path_factory.mktemp("moe_sharded"))
    store = os.path.join(data_dir, "store")
    t0 = time.perf_counter()
    procs = mp.start_processes(_rank, args=(WORLD, store, data_dir), nprocs=WORLD,
                               start_method="spawn", join=False)
    failure, reference = None, {}
    try:
        reference = {name: _reference_losses(*args)  # while the ranks run
                     for name, args in REFERENCE.items()}
        while not procs.join(timeout=max(1.0, JOIN_TIMEOUT - (time.perf_counter() - t0))):
            if time.perf_counter() - t0 > JOIN_TIMEOUT:
                failure = f"the ranks did not finish within {JOIN_TIMEOUT} s"
                break
    except Exception as e:  # a rank died: its results say how far it got
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


def _check_train(v) -> None:
    for got, want in v["losses"]:
        assert abs(got - want) <= ATOL + RTOL * abs(want), v["losses"]
    bad = {n: g for n, g in v["gaps"].items() if g > 0.0}
    assert not bad, bad


def test_microbatches_match_the_one_process_step(results):
    v = _value(results, "microbatch")
    _check_train(v)
    assert v["iterations"] == [2, 2], v["iterations"]


def _check_reference(got_losses, want) -> None:
    got = [s for s, _ in got_losses]
    assert len(want) == len(got) == 2, (got, want)
    for g, w in zip(got, want):
        assert abs(g - w) <= ATOL + RTOL * abs(w), (got, want)


def test_microbatch_losses_match_the_reference(results):
    _check_reference(_value(results, "microbatch")["losses"], results["_reference"]["microbatch"])


@pytest.mark.parametrize("case", ["einsum", "sort", "vlm"])
def test_thin_microbatches_match_the_one_process_step(results, case):
    v = _value(results, f"thin {case}")
    _check_train(v)
    assert v["iterations"] == [THIN_M // 2] * 2, v["iterations"]  # 2 microbatches an iteration


@pytest.mark.parametrize("case", ["einsum", "sort", "vlm"])
def test_thin_microbatch_losses_match_the_reference(results, case):
    _check_reference(_value(results, f"thin {case}")["losses"],
                     results["_reference"][f"thin {case}"])


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_remat_recomputes_under_the_forwards_context(results, dispatch):
    v = _value(results, f"remat {dispatch}")
    assert v["k"] == 2 and v["gap"] == 0.0, v


def test_no_layout_raises(results):
    message = _value(results, "no layout")
    assert "2 microbatches of 2 rows" in message, message


@pytest.mark.parametrize("mesh", SORT_MESHES)
def test_sort_dispatch_trains_as_one_process(results, mesh):
    v = _value(results, f"sort train {mesh}")
    _check_train(v)
    rep = v["repeated"]
    got, want = rep["losses"]
    assert abs(got - want) <= ATOL + RTOL * abs(want), rep["losses"]
    bad = {n: g for n, g in rep["grads"].items() if g > 0.0}
    assert not bad, bad
    if mesh == "(2, 2)":  # the repeated batch's second shard
        assert rep["dropped"] > 0, rep


@pytest.mark.parametrize("mesh", SORT_MESHES)
def test_sort_dispatch_losses_match_the_reference(results, mesh):
    _check_reference(_value(results, f"sort train {mesh}")["losses"],
                     results["_reference"]["sort train"])


@pytest.mark.parametrize("mesh", SORT_MESHES)
@pytest.mark.parametrize("kind", PROMPTS)
def test_sort_dispatch_serves_as_the_engine(results, mesh, kind):
    v = _value(results, f"sort serve {mesh}")[kind]
    assert v["excess"] <= 0.0, v
    assert v["same_bits"], v
    if mesh == "(2, 2)" and kind == "repeated":
        assert v["dropped"] > 0, v


@pytest.mark.parametrize("mesh", INIT_MESHES)
def test_sharded_init_draws_one_layer_slice_at_a_time(results, mesh):
    from repro_torch.models.layers import spec_leaves
    from repro_torch.models.transformer import param_specs

    v = _value(results, f"init {mesh}")
    slices = [int(np.prod(s.shape[1:] if path[0] == "stack" else s.shape))
              for path, s in spec_leaves(param_specs(_cfg())) if s.init not in ("zeros", "ones")]
    assert max(v["draws"]) == max(slices), (v["draws"], slices)
    assert v["draws"] == v["plain_draws"]


@pytest.mark.parametrize("mesh", INIT_MESHES)
def test_sharded_init_gathers_to_the_plain_init(results, mesh):
    assert _value(results, f"init {mesh}")["equal"]


def test_the_spawn_stays_inside_its_budget(results):
    assert results["_failure"] is None, results["_failure"]
    assert results["_seconds"] < JOIN_TIMEOUT
