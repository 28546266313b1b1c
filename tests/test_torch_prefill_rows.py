"""A prefill cell's rows run in chunks where the memory rule asks for it
(``launch.specs.prefill_row_chunks``, ``build_step(memory_budget=...)``).

* **The rule across all cells.**  Every cell of ``configs.cells`` on both
  production meshes, read on meta shapes (the mesh a ``{name: size}`` map,
  no process): ``build_step`` builds it, and a prefill cell's rows at its
  own shape take one chunk a rank everywhere but in llava-next-34b's
  ``prefill_32k`` on (2, 32, 8), whose 16 rows a rank (the batch of 32
  divides "pod" but not "pod" x "data") need at least two.  At the
  chunks it takes, the estimate is at least each prefill cell's peak in
  the fake-world dry-run on the card (``MEASURED_PEAK``), and a block kind
  it does not count raises.
* **The chunked step** in a gloo world of 4 ranks on a (1, 2, 2) ("pod",
  "data", "model") mesh: llava's smoke config with image embeddings at
  batch 4 (2 rows a rank), float32 compute with a float32 cache, a
  ``memory_budget`` that forces 2 chunks.  Its last-token logits and every
  cache leaf are held to the same cell at one chunk (atol 1e-6) and to the
  reference's jitted one-device prefill on the same weights
  (``models/transfer.py``; atol 1e-5 / rtol 1e-4, as
  ``tests/test_torch_serve_sharded.py``).  The parent runs the reference
  while the ranks work.  The step keeps its decision in ``Cell.plans``,
  and rows that do not split into the chunks are refused.
* **The refusal.**  A MoE cell whose rows are not independent (the sort
  dispatch's capacity over all tokens, or einsum groups longer than a row)
  raises ``ValueError`` where the budget asks for chunks: the rule on meta
  shapes, and the cell's step on the gloo ranks.
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

from repro_torch import configs
from repro_torch.launch.mesh import PRODUCTION_MESHES

ARCH = "llava-next-34b"
MESH = ((1, 2, 2), ("pod", "data", "model"))
B, TOKENS, CAPACITY = 4, 24, 48
WORLD = 4
JOIN_TIMEOUT = 240
SEED = 28
CHUNK_TOL = 1e-6
REF_ATOL, REF_RTOL = 1e-5, 1e-4
CELLS = [(arch, shape, multi) for arch in configs.ARCH_IDS for shape in configs.cells(arch)
         for multi in (False, True)]
IDS = [f"{a}-{s}-{'x'.join(map(str, PRODUCTION_MESHES[m][0]))}" for a, s, m in CELLS]


def _sizes(multi: bool) -> dict:
    dims, names = PRODUCTION_MESHES[multi]
    return dict(zip(names, dims))


@pytest.mark.parametrize("arch,shape,multi", CELLS, ids=IDS)
def test_the_rule_chunks_only_llavas_512_card_prefill(arch, shape, multi):
    from repro_torch.launch.roofline import HBM_BYTES
    from repro_torch.launch.specs import build_step, prefill_peak_bytes, prefill_row_chunks

    cfg = configs.get_config(arch)
    cell = build_step(cfg, shape, _sizes(multi))
    chunks = 1
    if cell.kind == "prefill":
        chunks = prefill_row_chunks(cfg, shape, _sizes(multi), cell.rules)
        assert prefill_peak_bytes(cfg, shape, _sizes(multi), cell.rules, chunks) <= HBM_BYTES
    if (arch, shape, multi) == (ARCH, "prefill_32k", True):
        assert chunks >= 2, chunks
        assert prefill_peak_bytes(cfg, shape, _sizes(multi), cell.rules) > HBM_BYTES
    else:
        assert chunks == 1, chunks


def test_the_rule_counts_rows_a_rank():
    """The per-row terms scale with a rank's rows over the chunks: 16 rows
    on 512 cards, one on 256; halving them halves that part."""
    from repro_torch.launch.specs import _rank_rows, _serve_rules, prefill_peak_bytes

    cfg = configs.get_config(ARCH)
    rules = _serve_rules(cfg)
    assert _rank_rows(32, _sizes(True), rules) == 16
    assert _rank_rows(32, _sizes(False), rules) == 1
    one, two, four = (prefill_peak_bytes(cfg, "prefill_32k", _sizes(True), rules, r)
                      for r in (1, 2, 4))
    assert one - two == 2 * (two - four) > 0
    resident = two - (one - two)
    assert 0 < resident < two


#: each prefill cell's peak bytes a card in the fake-world dry-run on an H100 80GB HBM3
#: (``python -m repro_torch.launch.dryrun --all --mesh both``, ``per_device_total``; llava's
#: 512-card cell at its 2 row chunks)
MEASURED_PEAK = {
    ("deepseek-v2-lite-16b", True): 75460165120,
    ("deepseek-v2-lite-16b", False): 14705539584,
    ("gemma2-9b", True): 44053462016,
    ("gemma2-9b", False): 5688556544,
    ("internlm2-1.8b", True): 22155169792,
    ("internlm2-1.8b", False): 2217938944,
    ("llava-next-34b", True): 46952955904,
    ("llava-next-34b", False): 14320166400,
    ("musicgen-medium", True): 17075571712,
    ("musicgen-medium", False): 2562362368,
    ("qwen3-moe-235b-a22b", True): 54508534784,
    ("qwen3-moe-235b-a22b", False): 14625731584,
    ("smollm-135m", True): 6127250944,
    ("smollm-135m", False): 506228224,
    ("tinyllama-1.1b", True): 21802700800,
    ("tinyllama-1.1b", False): 1710280704,
    ("xlstm-1.3b", True): 57814722048,
    ("xlstm-1.3b", False): 4116800000,
    ("zamba2-1.2b", True): 21942068224,
    ("zamba2-1.2b", False): 1825854464,
}


@pytest.mark.parametrize("arch,multi", sorted(MEASURED_PEAK),
                         ids=[f"{a}-{'2x32x8' if m else '32x8'}" for a, m in sorted(MEASURED_PEAK)])
def test_the_rule_is_no_lower_than_the_measured_peak(arch, multi):
    """The estimate at the chunks the rule takes is at least the dry-run's
    peak: every block kind's temporaries are counted (MLA's score chunks,
    the MoE dispatch block, the mLSTM fold, attention over every head)."""
    from repro_torch.launch.specs import _serve_rules, prefill_peak_bytes, prefill_row_chunks

    cfg = configs.get_config(arch)
    rules = _serve_rules(cfg)
    chunks = prefill_row_chunks(cfg, "prefill_32k", _sizes(multi), rules)
    assert prefill_peak_bytes(cfg, "prefill_32k", _sizes(multi), rules, chunks) >= \
        MEASURED_PEAK[arch, multi]


@pytest.mark.parametrize("change", [{"kind": "hyena"}, {"ffn": "relu"}], ids=["kind", "ffn"])
def test_a_block_the_rule_does_not_count_raises(change):
    from repro_torch.launch.specs import _serve_rules, prefill_peak_bytes

    cfg = configs.get_smoke_config("tinyllama-1.1b")
    cfg = dataclasses.replace(cfg, superblock=(dataclasses.replace(cfg.superblock[0], **change),))
    with pytest.raises(ValueError, match="does not count"):
        prefill_peak_bytes(cfg, "prefill_32k", _sizes(False), _serve_rules(cfg))


def _moe_cell(arch: str, **change):
    return dataclasses.replace(configs.get_smoke_config(arch), **change)


@pytest.mark.parametrize("arch,change", [
    ("qwen3-moe-235b-a22b", {"moe_dispatch": "sort"}),
    ("deepseek-v2-lite-16b", {"moe_group": 2 * 32768}),
], ids=["sort-capacity-over-all-tokens", "einsum-groups-of-two-rows"])
def test_a_moe_cell_whose_rows_share_groups_is_refused(arch, change):
    from repro_torch.launch.specs import _serve_rules, prefill_peak_bytes, prefill_row_chunks

    cfg = _moe_cell(arch, **change)
    mesh, rules = dict(zip(*reversed(MESH))), _serve_rules(cfg)
    whole, budget = (prefill_peak_bytes(cfg, "prefill_32k", mesh, rules, r) for r in (1, 2))
    assert prefill_row_chunks(cfg, "prefill_32k", mesh, rules, whole) == 1
    with pytest.raises(ValueError, match="spans rows"):
        prefill_row_chunks(cfg, "prefill_32k", mesh, rules, budget)
    # groups within a row: a budget that asks for 2 chunks chunks the rows
    independent = _moe_cell(arch, moe_dispatch="einsum", moe_group=64)
    budget = prefill_peak_bytes(independent, "prefill_32k", mesh, rules, 2)
    assert prefill_row_chunks(independent, "prefill_32k", mesh, rules, budget) == 2


# -- the chunked step on 4 gloo ranks -----------------------------------------------------


def _cfg():
    return dataclasses.replace(configs.get_smoke_config(ARCH), compute_dtype="float32",
                               serve_param_dtype="float32")


def _model(cfg):
    from repro_torch.models import init_model_params

    return init_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")


def _inputs(cfg) -> dict:
    rng = np.random.RandomState(SEED)
    return {"tokens": rng.randint(0, cfg.vocab, (B, TOKENS)),
            "image_embeds": rng.standard_normal((B, cfg.img_tokens, cfg.d_model)).astype(np.float32)}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield ".".join(path), tree


def _positions(cfg) -> int:
    return TOKENS + cfg.img_tokens


def _prefill(cfg, mesh, model, chunks: int) -> dict:
    """The cell's prefill with a budget that asks for ``chunks`` row chunks
    a rank: its logits and cache gathered and each prefill call's local
    rows."""
    from repro_torch.launch import specs
    from repro_torch.models import init_cache

    calls = []
    made = specs.make_prefill_step

    def recorded(c):
        step = made(c)

        def prefill(m, batch, cache):
            calls.append(batch["tokens"].to_local().shape[0])
            return step(m, batch, cache)

        return prefill

    rules = specs.build_step(cfg, "prefill_32k", mesh).rules
    budget = specs.prefill_peak_bytes(cfg, (B, _positions(cfg)), mesh, rules, chunks)
    specs.make_prefill_step = recorded
    try:
        cell = specs.build_step(cfg, "prefill_32k", mesh, memory_budget=budget)
    finally:
        specs.make_prefill_step = made
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    smodel, sbatch, scache = cell.shard(copy.deepcopy(model), inputs,
                                        init_cache(cfg, B, CAPACITY, torch.float32, device="cpu"))
    logits, scache = cell.step(smodel, sbatch, scache)
    return {"calls": calls, "budget": budget, "plans": {str(k): v for k, v in cell.plans.items()},
            "logits": logits.full_tensor(),
            "cache": {k: t.full_tensor() for k, t in _leaves(scache)}}


def _refused(mesh) -> str:
    """The error of a MoE smoke cell's step (the sort dispatch: its
    capacity is over all the batch's tokens) under a budget that asks for
    2 chunks."""
    from repro_torch.launch import specs
    from repro_torch.models import init_cache, init_model_params

    cfg = _moe_cell("qwen3-moe-235b-a22b", moe_dispatch="sort")
    rules = specs.build_step(cfg, "prefill_32k", mesh).rules
    budget = specs.prefill_peak_bytes(cfg, (B, TOKENS), mesh, rules, 2)
    cell = specs.build_step(cfg, "prefill_32k", mesh, memory_budget=budget)
    tokens = torch.from_numpy(np.random.RandomState(SEED).randint(0, cfg.vocab, (B, TOKENS)))
    args = cell.shard(init_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu"),
                      {"tokens": tokens}, init_cache(cfg, B, CAPACITY, torch.float32, device="cpu"))
    try:
        cell.step(*args)
    except ValueError as e:
        return str(e)
    return "no error"


def _uneven(mesh) -> str:
    """The error of a row chunk of a rank's 2 rows in 3 chunks."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.specs import _row_chunk

    rows = distribute_tensor(torch.zeros(B, 3), mesh, [Replicate(), Shard(0), Replicate()])
    try:
        _row_chunk(rows, 0, 0, 3)
    except ValueError as e:
        return str(e)
    return "no error"


def _rank(rank, world, store_path, data_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    path = os.path.join(data_dir, f"results{rank}.json")
    try:
        mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
        cfg = _cfg()
        model = _model(cfg)
        out = {r: _prefill(cfg, mesh, model, r) for r in (1, 2)}
        summary = {"ok": True, "calls": {r: o["calls"] for r, o in out.items()},
                   "plans": {r: [o["budget"], o["plans"]] for r, o in out.items()},
                   "refused": _refused(mesh), "uneven": _uneven(mesh)}
        if rank == 0:
            torch.save({r: {"logits": o["logits"], "cache": o["cache"]} for r, o in out.items()},
                       os.path.join(data_dir, "prefill.pt"))
    except Exception:  # recorded for the parent, then the rank stops
        summary = {"ok": False, "error": traceback.format_exc()}
        with open(path, "w") as f:
            json.dump(summary, f)
        raise
    with open(path, "w") as f:
        json.dump(summary, f)
    dist.destroy_process_group()


def _reference() -> dict:
    """The reference's jitted one-device prefill with a float32 cache on the
    port's weights: ``{"logits", "cache": {leaf path: array}}``."""
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro import models as ref_models
    from repro.serve import make_prefill_step
    from repro_torch.models.transfer import params_tree

    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), compute_dtype="float32")
    cfg = _cfg()
    params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params_tree(_model(cfg)))
    cache = ref_models.init_cache(ref_cfg, B, CAPACITY, dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
    logits, cache = jax.jit(make_prefill_step(ref_cfg))(params, batch, cache)
    return {"logits": np.asarray(logits),
            "cache": {k: np.asarray(v) for k, v in _leaves(jax.tree.map(np.asarray, cache))}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import torch.multiprocessing as mp

    data_dir = str(tmp_path_factory.mktemp("prefill_rows"))
    store = os.path.join(data_dir, "store")
    t0 = time.perf_counter()
    procs = mp.start_processes(_rank, args=(WORLD, store, data_dir), nprocs=WORLD,
                               start_method="spawn", join=False)
    failure, reference = None, {}
    try:
        reference = _reference()  # while the ranks run
        while not procs.join(timeout=max(1.0, JOIN_TIMEOUT - (time.perf_counter() - t0))):
            if time.perf_counter() - t0 > JOIN_TIMEOUT:
                failure = f"the ranks did not finish within {JOIN_TIMEOUT} s"
                break
    except Exception as e:  # a rank raised: its traceback is in its results
        failure = f"{type(e).__name__}: {e}"
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
    ranks = []
    for r in range(WORLD):
        path = os.path.join(data_dir, f"results{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else None)
    saved = os.path.join(data_dir, "prefill.pt")
    return {"ranks": ranks, "prefill": torch.load(saved) if os.path.exists(saved) else None,
            "reference": reference, "failure": failure, "seconds": time.perf_counter() - t0}


def _ranks(results) -> list:
    for r in results["ranks"]:
        if r is None:
            pytest.fail(f"a rank wrote no result: {results['failure']}")
        assert r["ok"], r["error"]
    return results["ranks"]


def test_each_rank_runs_its_rows_in_two_chunks(results):
    for r in _ranks(results):
        # 2 rows a rank: one prefill call of both, then two of one row each
        assert r["calls"] == {"1": [2], "2": [1, 1]}, r


def test_the_step_records_its_plan(results):
    """``Cell.plans``: the batch shape the step ran, its chunks and the
    rule's estimate at them (the budget that asked for them)."""
    key = str((B, _positions(_cfg())))
    for r in _ranks(results):
        for chunks, (budget, plans) in r["plans"].items():
            assert plans == {key: [int(chunks), budget]}, r["plans"]


def test_rows_that_do_not_split_into_the_chunks_are_refused(results):
    for r in _ranks(results):
        assert "do not split into 3 chunks" in r["uneven"], r["uneven"]


def test_a_moe_step_whose_rows_share_a_capacity_is_refused(results):
    for r in _ranks(results):
        assert "spans rows" in r["refused"], r["refused"]


def test_chunked_logits_equal_one_chunk(results):
    _ranks(results)
    got = results["prefill"]
    assert got[2]["logits"].shape == got[1]["logits"].shape == (B, 1, _cfg().vocab)
    assert float((got[2]["logits"] - got[1]["logits"]).abs().max()) <= CHUNK_TOL


def test_chunked_cache_equals_one_chunk(results):
    _ranks(results)
    got = results["prefill"]
    assert set(got[2]["cache"]) == set(got[1]["cache"])
    for name, t in got[2]["cache"].items():
        assert float(t.abs().max()) > 0, name  # the chunks wrote into the cell's cache
        assert float((t - got[1]["cache"][name]).abs().max()) <= CHUNK_TOL, name


@pytest.mark.parametrize("chunks", [1, 2])
def test_prefill_matches_the_reference(results, chunks):
    _ranks(results)
    got, want = results["prefill"][chunks], results["reference"]
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], atol=REF_ATOL,
                               rtol=REF_RTOL)
    assert set(got["cache"]) == set(want["cache"])
    for name, t in got["cache"].items():
        np.testing.assert_allclose(t.numpy(), want["cache"][name], atol=REF_ATOL, rtol=REF_RTOL,
                                   err_msg=name)


def test_the_spawn_stays_inside_its_budget(results):
    assert results["failure"] is None, results["failure"]
    assert results["seconds"] < JOIN_TIMEOUT
