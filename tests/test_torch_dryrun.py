"""The launch analysis tooling on the CPU: ``launch/dryrun.py``,
``launch/op_analysis.py``, ``launch/roofline.py``, ``launch/perf_compare.py``
and the kernels' custom ops.

* **Dry-run.**  The twin of the reference's
  ``tests/test_parallel.py::test_dryrun_single_cell_multi_pod``:
  smollm-135m's ``decode_32k`` cell on the multi-pod mesh, 512 fake ranks,
  ``--device cpu`` (this build's fake CUDA tensors stop at indexing): 512
  chips, under the H100's 80 GB a card, FLOPs counted.  Its KV cache is
  split along ``head_dim`` (9 heads, 3 kv heads, an 8-card "model" axis).
  ``perf_compare`` runs the same cell under an override.
* **Hand counts.**  ``analyze_step`` on a fake 512-rank world: a ``[1024,
  4096] @ [4096, 4096]`` product, the left operand split over "pod" x
  "data" and the right over "model", is 2 x 16 x 4096 x 512 = 67,108,864
  FLOPs a rank (``FlopCounterMode`` reports the global product there); a
  redistribution to ``Replicate`` is an all-gather of the whole tensor over
  each mesh dim it was split over; ``dist.all_reduce`` over a mesh dim's
  group is an all-reduce on that dim.  The same sharded step (smollm's
  smoke config, a train step on a (1, 1) mesh) counted on real CPU tensors
  in a gloo world of one and on fake ones in a fake world of one gives
  equal FLOPs, bytes, per-op counts and peak memory.
* **xlstm's cells.**  xlstm-1.3b's 8 cells (4 shapes on 256 and 512 fake
  ranks) at one superblock, the 4 heads not dividing the 8-way "model"
  axis: each runs under 80 GB a card, every mLSTM block takes its ``C``
  split along ``head_dim``, the ``repro_torch::slstm`` op counts one a
  serving step and two a train step, and a decode step all-reduces its
  partial ``q . C`` over "model".
* **Thin microbatches.**  qwen3-moe-235b's ``train_4k`` cell on 512 fake
  ranks at one layer: its 8 microbatches of 32 rows run 2 side by side, 4
  iterations a step, under 80 GB a card.
* **Custom ops.**  Each kernel's op called directly on fake CPU tensors:
  its outputs' shapes, dtypes and strides, and its FLOP formula against a
  hand count; a real CPU tensor never reaches it (the op has a CUDA kernel
  only; the wrappers take the plain versions).
* **Roofline.**  ``_model_flops`` equals the reference's exactly for every
  arch x shape of ``configs.cells``; the collective term adds each mesh
  dim's bytes over its own link rate.

Every fake world runs in a subprocess, so no process group leaks into the
test worker.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.kernels import crossentropy, flash_attention, hypervolume, parzen, slstm, ssd
from repro_torch.launch import roofline
from repro_torch.launch.op_analysis import analyze_step, kernel_ops

ROOT = Path(__file__).resolve().parents[1]
OPS = torch.ops.repro_torch


def _run(args, timeout=120, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=str(ROOT), **kw)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


# -- the dry-run cell ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smollm_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    stdout = _run(["-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m", "--shape",
                   "decode_32k", "--mesh", "multi", "--device", "cpu", "--out", str(out)])
    assert "[dryrun] OK" in stdout, stdout
    with open(out / "smollm-135m__decode_32k__2x32x8.json") as f:
        return json.load(f)


def test_dryrun_single_cell_multi_pod(smollm_record):
    rec = smollm_record
    assert rec["n_chips"] == 512
    assert rec["memory"]["per_device_total"] < roofline.HBM_BYTES
    assert rec["op_stats"]["flops"] > 0
    assert rec["kernels"] == "plain" and rec["device"] == "cpu"
    assert set(rec) >= {"arch", "shape", "mesh", "params", "active_params", "build_s", "run_s"}


def test_dryrun_head_dim_cache_contracts_over_model(smollm_record):
    """The cache split along ``head_dim``: one all-reduce of the partial
    scores a layer over "model", ``[B_local = 2, 3, 3, 32768]`` float32
    (2.4 MB), and nothing over the batch axes in decode."""
    by_dim = smollm_record["op_stats"]["collectives_by_dim"]
    assert set(by_dim) == {"model"}, by_dim
    cfg = configs.get_config("smollm-135m")
    scores = 2 * cfg.n_heads * 32768 * 4
    assert by_dim["model"]["all-reduce"] >= cfg.n_layers * scores


def test_roofline_reads_the_record(smollm_record, tmp_path):
    with open(tmp_path / "smollm-135m__decode_32k__2x32x8.json", "w") as f:
        json.dump(smollm_record, f)
    rows = roofline.load_all(str(tmp_path))
    assert len(rows) == 1 and rows[0]["fits"]
    r = rows[0]
    assert r["t_compute_s"] == smollm_record["op_stats"]["flops"] / roofline.PEAK_FLOPS
    assert "smollm-135m" in roofline.format_table(rows)


def test_perf_compare_measures_an_override(smollm_record):
    """The same cell cut to 2 of its 30 layers: fewer FLOPs, the same
    collectives a layer."""
    out = _run(["-m", "repro_torch.launch.perf_compare", "--arch", "smollm-135m", "--shape",
                "decode_32k", "--multi-pod", "--set", "n_layers=2", "--set", "n_superblocks=2",
                "--device", "cpu", "--json"])
    r = json.loads(out)
    assert r["overrides"] == {"n_layers": "2", "n_superblocks": "2"}
    full = smollm_record["op_stats"]
    assert 0 < r["flops"] < full["flops"] / 5
    assert r["collectives_by_dim"].keys() == full["collectives_by_dim"].keys()
    assert r["t_collective_s"] > 0 and r["mem_per_dev_gib"] < 80


# -- the sharded serving caches' cells -----------------------------------------------------------

#: one cell for each mechanism of the sharded serving caches, depth cut to one superblock
SERVE_CELLS = [("gemma2-9b", "long_500k", True), ("deepseek-v2-lite-16b", "decode_32k", False),
               ("zamba2-1.2b", "decode_32k", False), ("musicgen-medium", "prefill_32k", False),
               ("musicgen-medium", "decode_32k", False)]

#: qwen3-moe's train cell on 512 cards (8 microbatches of 32 rows over "pod" x "data" = 2 x
#: 32), depth cut to one superblock, in the same subprocess
THIN_CELL = ("qwen3-moe-235b-a22b", "train_4k", True)

SERVE_SCRIPT = textwrap.dedent("""
    import dataclasses, json, logging, sys
    from repro_torch import configs
    from repro_torch.launch.dryrun import run_cell
    import repro_torch.models.mamba2 as m2
    from repro_torch.models import tensor_parallel

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    calls, losses = [], []
    ssd = m2.ssd_chunked
    m2.ssd_chunked = lambda *a, **k: (calls.append(1), ssd(*a, **k))[1]
    ce = tensor_parallel.cross_entropy
    tensor_parallel.cross_entropy = lambda *a, **k: (losses.append(1), ce(*a, **k))[1]
    out = {}
    for arch, shape, multi in json.loads(sys.argv[1]):
        full = configs.get_config(arch)
        layers = len(full.head_blocks) + len(full.superblock) + len(full.tail_blocks)
        cfg = dataclasses.replace(full, n_superblocks=1, n_layers=layers)
        calls.clear()
        losses.clear()
        rec = run_cell(arch, shape, multi, out_dir=sys.argv[2], verbose=False, device="cpu",
                       cfg=cfg)
        out[f"{arch}:{shape}"] = {"n_chips": rec["n_chips"], "ssd_calls": len(calls),
                                  "loss_calls": len(losses),
                                  "memory": rec["memory"]["per_device_total"],
                                  "by_dim": rec["op_stats"]["collectives_by_dim"]}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def serve_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_serve")
    return json.loads(_run(["-c", SERVE_SCRIPT, json.dumps(SERVE_CELLS + [THIN_CELL]), str(out)],
                           timeout=240).splitlines()[-1])


@pytest.mark.parametrize("arch,shape,multi", SERVE_CELLS)
def test_serving_cache_cells_run(serve_cells, arch, shape, multi):
    r = serve_cells[f"{arch}:{shape}"]
    assert r["n_chips"] == (512 if multi else 256)
    assert r["memory"] < roofline.HBM_BYTES


def test_thin_microbatches_run_side_by_side_on_512_cards(serve_cells):
    """qwen3-moe's ``train_4k`` on (2, 32, 8): 256 rows in 8 microbatches of
    32, fewer rows than the 64 batch shards.  Each microbatch lies over
    "data", the two pods run one each, so the step takes 4 iterations of
    one row a rank (one loss call each) and runs under 80 GB a card."""
    r = serve_cells["qwen3-moe-235b-a22b:train_4k"]
    assert r["n_chips"] == 512
    assert 0 < r["memory"] < roofline.HBM_BYTES
    assert r["loss_calls"] == 4, r


def test_sequence_split_combines_over_pod_and_data(serve_cells):
    """gemma2's ``long_500k`` on 512 cards: batch 1 leaves "pod" x "data" to
    every KV cache's rows.  Each decode layer all-reduces over each of them
    the max and the sum of exponentials of its ``[1, 1, 2, 1]`` local
    scores (8 kv heads over "model", 2 query heads each) and the shards'
    ``P v`` ``[1, 1, 2, 256]``, in float32: 4 x 2 x (1 + 1 + 256) bytes a
    layer, 2 layers."""
    by_dim = serve_cells["gemma2-9b:long_500k"]["by_dim"]
    for ax in ("pod", "data"):
        assert by_dim[ax] == {"all-reduce": 2 * 4 * 2 * (1 + 1 + 256)}, by_dim


def test_latent_contraction_all_reduces_over_model(serve_cells):
    """deepseek's ``decode_32k`` on 256 cards: the partial scores over the
    latent's and the rope key's "model" slices, ``[4, 16, 1, 32768]``
    float32 a layer (128 rows over 32 "data" shards), summed over "model"
    in each of the 2 MLA layers."""
    by_dim = serve_cells["deepseek-v2-lite-16b:decode_32k"]["by_dim"]
    assert by_dim["model"]["all-reduce"] >= 2 * 4 * 16 * 32768 * 4, by_dim


def test_mamba2_decode_gathers_the_conv_cache_over_model(serve_cells):
    """zamba2's ``decode_32k``: the recurrent step, no SSD scan; the conv
    cache ``[4, 3, 4224]`` float32 gathered over "model" in each of the 8
    mamba2 blocks (their in-projections are gathered there too)."""
    r = serve_cells["zamba2-1.2b:decode_32k"]
    assert r["ssd_calls"] == 0
    assert r["by_dim"]["model"]["all-gather"] >= 8 * 4 * 3 * 4224 * 4, r


def test_audio_head_takes_the_local_vocabulary_shard(serve_cells):
    """musicgen's ``prefill_32k`` on 256 cards: the audio head's logits are
    a local product of the batch rows and the vocabulary shard, so nothing
    moves over the batch axis (DTensor's own einsum over the sharded head
    cannot run it)."""
    by_dim = serve_cells["musicgen-medium:prefill_32k"]["by_dim"]
    assert "data" not in by_dim, by_dim


# -- xlstm's cells ------------------------------------------------------------------------------

XLSTM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
XLSTM_CELLS = [(shape, multi) for multi in (False, True) for shape in XLSTM_SHAPES]

XLSTM_SCRIPT = textwrap.dedent("""
    import dataclasses, json, logging, sys
    import torch
    from repro_torch import configs
    from repro_torch.kernels import slstm
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.op_analysis import kernel_ops
    from repro_torch.models import tensor_parallel

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    def op_scan(u, R, c0, n0, h0, m0, states=False):
        seqs, final = torch.ops.repro_torch.slstm(u, R, c0, n0, h0, m0, states)
        final = tuple(final.unbind(0))
        return (seqs[0], final, tuple(seqs[1:].unbind(0))) if states else (seqs[0], final)

    slstm.slstm_scan_ref = op_scan  # the sLSTM forward as the op, as on the card
    seen = []
    mlstm = tensor_parallel._mlstm

    def recorded(p, x, cfg, cache, mode):
        if cache is not None:
            C = cache["C"]
            seen.append(str(C.placements[C.device_mesh.mesh_dim_names.index("model")]))
        return mlstm(p, x, cfg, cache, mode)

    tensor_parallel._mlstm = recorded
    full = configs.get_config("xlstm-1.3b")
    cfg = dataclasses.replace(full, n_superblocks=1, n_layers=len(full.superblock))
    multi = json.loads(sys.argv[1])
    out = {}
    for shape in json.loads(sys.argv[2]):
        seen.clear()
        rec = run_cell("xlstm-1.3b", shape, multi, out_dir=sys.argv[3], verbose=False,
                       device="cpu", cfg=cfg)
        out[shape] = {"n_chips": rec["n_chips"], "memory": rec["memory"]["per_device_total"],
                      "slstm": kernel_ops(rec["op_stats"]).get("slstm", {}).get("count", 0),
                      "C": sorted(set(seen)), "by_dim": rec["op_stats"]["collectives_by_dim"]}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def xlstm_cells(tmp_path_factory):
    """xlstm-1.3b's cells at one superblock (7 mLSTM + 1 sLSTM blocks), on
    CPU ranks: one subprocess a production mesh, the two at once.  The CPU
    ranks take the sLSTM scan's plain version, a Python loop of up to 32768
    steps on fake tensors; the script routes its forward through the
    kernel's custom op (its fake implementation, counted as the card's step
    counts it), while the written-out backward runs as it does on the card."""
    out_dir = tmp_path_factory.mktemp("dryrun_xlstm")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {multi: subprocess.Popen([sys.executable, "-c", XLSTM_SCRIPT, json.dumps(multi),
                                      json.dumps(XLSTM_SHAPES), str(out_dir)],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                     env=env, cwd=str(ROOT))
             for multi in (False, True)}
    out = {}
    try:
        for multi, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            out[multi] = json.loads(stdout.splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("shape,multi", XLSTM_CELLS)
def test_xlstm_cells_run_under_the_production_meshes(xlstm_cells, shape, multi):
    r = xlstm_cells[multi][shape]
    assert r["n_chips"] == (512 if multi else 256)
    assert 0 < r["memory"] < roofline.HBM_BYTES
    # one sLSTM block: its kernel's op once a prefill or decode step, twice a train step (the
    # backward recomputes the superblock's forward)
    assert r["slstm"] == (2 if shape == "train_4k" else 1), r


@pytest.mark.parametrize("shape,multi", [c for c in XLSTM_CELLS if c[0] != "train_4k"])
def test_xlstm_serving_cells_keep_c_along_head_dim(xlstm_cells, shape, multi):
    """4 heads do not divide the 8-way "model" axis: ``SERVE_RULES`` split
    each mLSTM block's ``C [B, 4, 1024, 1024]`` along ``head_dim`` (its dim
    2, the key rows), and the blocks take it so."""
    assert xlstm_cells[multi][shape]["C"] == ["S(2)"], xlstm_cells[multi][shape]


def test_xlstm_decode_contracts_c_over_model(xlstm_cells):
    """``decode_32k`` on 256 cards: each of the 7 mLSTM blocks all-reduces
    its partial ``q . C`` and ``q . n`` over "model", ``[4, 4, 1024 + 1]``
    float32 (128 rows over 32 "data" shards), and never gathers ``C``."""
    by_dim = xlstm_cells[False]["decode_32k"]["by_dim"]
    assert by_dim["model"]["all-reduce"] >= 7 * 4 * 4 * 1025 * 4, by_dim
    assert "data" not in by_dim, by_dim


# -- hand counts on fake worlds -----------------------------------------------------------------

HAND_COUNTS = textwrap.dedent("""
    import dataclasses, json, logging
    import torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.op_analysis import analyze_step

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        with FakeTensorMode():
            a = DTensor.from_local(torch.empty(16, 4096), mesh,
                                   (Shard(0), Shard(0), Replicate()), run_check=False)
            b = DTensor.from_local(torch.empty(4096, 512), mesh,
                                   (Replicate(), Replicate(), Shard(1)), run_check=False)
            st = analyze_step(lambda x, y: x @ y, a, b)
            out["mm"] = {"flops": st.flops, "ops": st.ops}
            full = (Replicate(),) * 3
            out["gather_b"] = analyze_step(lambda y: y.redistribute(mesh, full), b).asdict()
            out["gather_a"] = analyze_step(lambda x: x.redistribute(mesh, full), a).asdict()
            t = torch.ones(1024)
            out["all_reduce"] = analyze_step(
                lambda: dist.all_reduce(t, group=mesh.get_group(2)), mesh=mesh).asdict()

    # one sharded train step, counted on real and on fake CPU tensors
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_step
    from repro_torch.models import Transformer, init_model_params
    from repro_torch.train import SyntheticLM

    cfg = dataclasses.replace(configs.get_smoke_config("smollm-135m"), compute_dtype="float32")

    real_batch = SyntheticLM(cfg, 4, 32, seed=0).batch_at(0)

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=tree.dtype) if isinstance(tree, torch.Tensor) else tree

    def step_stats(world):
        mesh = make_host_mesh((1, 1), ("data", "model"))
        cell = build_step(cfg, "train_4k", mesh)
        if world == "fake":
            with FakeTensorMode():
                batch = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in real_batch.items()}
                model, state, _, batch = cell.shard(Transformer(cfg, device="cpu"),
                                                    zeros(cell.args[1]), 0, batch)
                return analyze_step(cell.step, model, state, 0, batch).asdict()
        model = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
        model, state, _, batch = cell.shard(model, zeros(cell.args[1]), 0, real_batch)
        return analyze_step(cell.step, model, state, 0, batch).asdict()

    with fake_world(1):
        out["step_fake"] = step_stats("fake")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        out["step_real"] = step_stats("real")
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def hand_counts():
    return json.loads(_run(["-c", HAND_COUNTS]).splitlines()[-1])


def test_sharded_product_counts_the_local_flops(hand_counts):
    mm = hand_counts["mm"]
    assert mm["flops"] == 2 * 16 * 4096 * 512 == 67_108_864
    assert mm["ops"]["aten.mm"]["count"] == 1


def test_redistribution_counts_an_all_gather_per_mesh_dim(hand_counts):
    whole = 1024 * 4096 * 4  # float32
    b = hand_counts["gather_b"]
    assert b["collectives_by_dim"] == {"model": {"all-gather": 4096 * 4096 * 4}}
    a = hand_counts["gather_a"]
    # "data" gathers the pod's half (32 x 16 rows), then "pod" the whole
    assert a["collectives_by_dim"] == {"data": {"all-gather": whole // 2},
                                       "pod": {"all-gather": whole}}
    assert a["collective_bytes"] == whole // 2 + whole and a["n_collective_ops"] == 2


def test_in_place_all_reduce_is_counted_on_its_mesh_dim(hand_counts):
    ar = hand_counts["all_reduce"]
    assert ar["collectives_by_dim"] == {"model": {"all-reduce": 4096}}
    assert ar["collectives"] == {"all-reduce": 4096}


def test_fake_and_real_steps_count_alike(hand_counts):
    fake, real = hand_counts["step_fake"], hand_counts["step_real"]
    assert real["flops"] > 0
    assert fake["flops"] == real["flops"]
    assert fake["bytes_accessed"] == real["bytes_accessed"]
    assert {k: v["count"] for k, v in fake["ops"].items()} == \
        {k: v["count"] for k, v in real["ops"].items()}
    assert fake["memory"]["per_device_total"] == real["memory"]["per_device_total"]


# -- the kernels' custom ops --------------------------------------------------------------------


def _fake(*shapes_dtypes):
    return [torch.empty(s, dtype=d) for s, d in shapes_dtypes]


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("causal,window,q_offset,kv_len,pairs", [
    (True, -1, 0, 8, 8 * 9 // 2),   # causal: row r sees r + 1 keys
    (True, 3, 0, 8, 1 + 2 + 3 * 6),  # window 3
    (False, -1, 0, 6, 8 * 6),        # non-causal below kv_len
    (True, -1, 4, 12, sum(range(5, 13))),  # rows at positions 4..11 of a 12-key cache
])
def test_flash_attention_op(causal, window, q_offset, kv_len, pairs):
    with FakeTensorMode():
        # [B, H, S, D] views of [B, S, H, D] tensors, as the model passes them
        q = torch.empty(2, 8, 4, 16, dtype=BF16).transpose(1, 2)
        k = torch.empty(2, 12, 2, 16, dtype=BF16).transpose(1, 2)
        out = OPS.flash_attention(q, k, k, causal, window, 0.0, q_offset, kv_len)
        st = analyze_step(OPS.flash_attention, q, k, k, causal, window, 0.0, q_offset, kv_len)
    assert out.shape == q.shape and out.dtype == BF16 and out.stride() == q.stride()
    assert flash_attention.attention_pairs(8, 12, causal, window, q_offset, kv_len) == pairs
    assert st.flops == 4 * 16 * 2 * 4 * pairs
    # q, k and v read once (k is passed as v too), the output written once
    q_bytes, k_bytes = 2 * 4 * 8 * 16 * 2, 2 * 2 * 12 * 16 * 2
    assert kernel_ops(st) == {"flash_attention": {"count": 1, "flops": st.flops,
                                                  "bytes": 2 * q_bytes + 2 * k_bytes}}


def test_crossentropy_op():
    with FakeTensorMode():
        x, w, lab = _fake(((5, 8), BF16), ((8, 11), F32), ((5,), torch.int64))
        nll, lse = OPS.crossentropy(x, w, lab, 30.0)
        st = analyze_step(OPS.crossentropy, x, w, lab, 30.0)
    assert nll.shape == lse.shape == (5,) and nll.dtype == lse.dtype == F32
    assert st.flops == 2 * 5 * 8 * 11
    # x, W and the labels read once, the NLL and lse written once
    assert st.bytes_accessed == 5 * 8 * 2 + 8 * 11 * 4 + 5 * 8 + 2 * 5 * 4


def test_ssd_op():
    with FakeTensorMode():
        xh, dt, A, Bm, init = _fake(((2, 10, 4, 8), BF16), ((2, 10, 4), F32), ((4,), F32),
                                    ((2, 10, 2, 4), BF16), ((2, 4, 8, 4), F32))
        y, final = OPS.ssd(xh, dt, A, Bm, Bm, 4, init)
        st = analyze_step(OPS.ssd, xh, dt, A, Bm, Bm, 4, None)
    assert y.shape == (2, 10, 4, 8) and final.shape == (2, 4, 8, 4)
    assert y.dtype == final.dtype == F32
    # chunks of 4, 4 and 2 steps, per (batch, head): pairs x (2 N + 2 P) + 4 l P N
    per_head = sum(n * (n + 1) // 2 * (2 * 4 + 2 * 8) + 4 * n * 8 * 4 for n in (4, 4, 2))
    assert st.flops == 2 * 4 * per_head == 14656


@pytest.mark.parametrize("save_states", [False, True])
def test_slstm_op(save_states):
    B, S, H, D = 2, 3, 2, 4
    with FakeTensorMode():
        u, R, c = _fake(((B, S, 4 * H * D), BF16), ((4, H, D, D), F32), ((B, H, D), F32))
        seqs, final = OPS.slstm(u, R, c, c, c, c, save_states)
        st = analyze_step(OPS.slstm, u, R, c, c, c, c, save_states)
    assert seqs.shape == (4 if save_states else 1, B, S, H * D) and final.shape == (4, B, H, D)
    assert seqs.dtype == final.dtype == F32
    assert st.flops == 2 * S * B * 4 * H * D * D == 1536


def test_parzen_op():
    with FakeTensorMode():
        c, l, g = _fake(((7,), F32), ((3,), F32), ((5,), F32))
        out = OPS.parzen_score(c, l, l, l, g, g, g)
        st = analyze_step(OPS.parzen_score, c, l, l, l, g, g, g)
    assert out.shape == (7,) and out.dtype == F32
    assert st.flops == 7 * (3 + 5) * (parzen.OPS_PER_PAIR + 1) == 504


def test_hypervolume_ops():
    with FakeTensorMode():
        pts, smp = _fake(((5, 3), F32), ((16, 3), F32))
        counts = OPS.mc_hv_counts(pts, smp)
        st = analyze_step(OPS.mc_hv_counts, pts, smp)
        P, off, lo, u = _fake(((6, 3), F32), ((3,), torch.int32), ((2, 3), torch.float64),
                              ((16, 3), torch.float64))
        sets = OPS.mc_hv_counts_sets(P, off, lo, lo, u)
        st_sets = analyze_step(OPS.mc_hv_counts_sets, P, off, lo, lo, u)
    assert counts.shape == (6,) and counts.dtype == torch.int32
    assert st.flops == 5 * 16 * 3
    assert sets.shape == (8,) and sets.dtype == torch.int32
    assert st_sets.flops == 6 * 16 * 3 + 2 * 2 * 16 * 3


@pytest.mark.parametrize("name,args", [
    ("flash_attention", lambda: (torch.zeros(1, 1, 2, 8),) * 3 + (True, -1, 0.0, 0, 2)),
    ("crossentropy", lambda: (torch.zeros(2, 4), torch.zeros(4, 3),
                              torch.zeros(2, dtype=torch.int64), 0.0)),
    ("parzen_score", lambda: (torch.zeros(3),) * 7),
])
def test_a_cpu_tensor_never_reaches_a_kernel_op(name, args):
    """The ops have a CUDA kernel only: the wrappers give CPU tensors the
    plain versions, and the op itself raises on them."""
    with pytest.raises((NotImplementedError, RuntimeError)):
        getattr(OPS, name)(*args())


def test_every_kernel_module_registers_its_ops():
    assert {m.__name__.rsplit(".", 1)[1] for m in (crossentropy, flash_attention, hypervolume,
                                                  parzen, slstm, ssd)} == {
        "crossentropy", "flash_attention", "hypervolume", "parzen", "slstm", "ssd"}
    from torch.utils.flop_counter import flop_registry

    for name in ("flash_attention", "crossentropy", "ssd", "slstm", "parzen_score",
                 "mc_hv_counts", "mc_hv_counts_sets"):
        assert getattr(OPS, name) in flop_registry, name


# -- roofline -----------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_model_flops_equal_the_references(arch):
    from repro.launch import roofline as ref_roofline

    for shape in configs.cells(arch):
        rec = {"arch": arch, "shape": shape}
        assert roofline._model_flops(rec) == ref_roofline._model_flops(rec), shape


def test_collective_term_takes_each_dims_link():
    t = roofline.collective_seconds({"model": {"all-gather": 450e9, "all-reduce": 450e9},
                                     "data": {"all-reduce": 50e9}, "pod": {"all-gather": 25e9}})
    assert math.isclose(t, 2.0 + 1.0 + 0.5)
