"""Multi-node dry-run: run every (arch x shape x mesh) cell's step once in a
world of fake ranks and record its per-card memory, FLOPs, bytes and
collectives, proof that the distribution config is coherent without the
cards.  The port's counterpart of the reference's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu   # without CUDA

One process stands for every rank: ``torch.distributed`` runs a fake
process group of 256 or 512 ranks (collectives return at once and move
nothing), the production mesh of ``launch/mesh.py`` is laid over it, and
this process is rank 0.  ``build_step``'s meta arguments become fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage) at their full
size, ``Cell.shard`` distributes them, and ``launch/op_analysis.py`` counts
rank 0's step.  Nothing runs on a device.

``--device cuda`` (the default) takes the H100 step: fake CUDA tensors, the
kernels' custom ops (``kernels/ops.py``) with their FLOP formulas.  It needs
a PyTorch built with CUDA (no card): on a CPU-only build fake CUDA tensors
stop at advanced indexing and scatters.  ``--device cpu`` lays the mesh over
CPU ranks; the kernels' plain PyTorch versions run and are counted instead,
and the record says so (``"kernels": "plain"``).

Writes one JSON a cell, ``<arch>__<shape>__<mesh>.json``, under ``--out``
(default ``build/dryrun``, git-ignored), with the reference's keys:
``hlo_stats`` is ``op_stats``, and ``build_s`` (fake arguments made and
sharded) and ``run_s`` (the step counted) replace ``lower_s`` and
``compile_s``; ``row_chunks`` and ``memory_rule`` are the row chunks a rank
that a prefill cell's step chose and the memory rule's estimate at them
(``specs.prefill_peak_bytes``), and a prefill cell on CUDA ranks whose
estimate is below its measured peak fails.  ``--all`` also writes ``summary.json``: every
cell's OK or FAIL and, for a failure, its exception.  Each cell runs in a worker process
(``--jobs`` of them at once; a world of fake ranks is one per process).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")
#: mesh names, single pod and multi-pod (``launch/mesh.py::PRODUCTION_MESHES``)
MESH_NAMES = {False: "32x8", True: "2x32x8"}

__all__ = ["run_cell", "analyze_cell", "fake_world", "main", "MESH_NAMES"]


@contextlib.contextmanager
def fake_world(n_ranks: int, rank: int = 0):
    """A world of ``n_ranks`` fake ranks in this process, this one ``rank``;
    torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_like(tree, device):
    """``tree``'s meta tensors as empty fake tensors on ``device`` (inside a
    ``FakeTensorMode``); other leaves pass through."""
    if isinstance(tree, dict):
        return {k: _fake_like(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    return tree


def _fake_args(cell, device) -> tuple:
    """The cell's arguments at their full size as fake tensors on
    ``device``, distributed by ``Cell.shard``."""
    from ..models import Transformer

    full = []
    for a in cell.args:
        full.append(Transformer(a.cfg, device=device) if isinstance(a, Transformer)
                    else _fake_like(a, device))
    return cell.shard(*full)


def analyze_cell(cfg, shape: str, multi_pod: bool, device: str = "cuda") -> dict:
    """``cfg``'s cell on the production mesh in a world of fake ranks:
    ``{"n_chips", "build_s", "run_s", "stats": OpStats, "plan"}``, ``plan``
    a prefill step's ``(row chunks a rank, the memory rule's estimate)``
    (``Cell.plans``), else ``(1, None)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import SHAPES
    from .mesh import PRODUCTION_MESHES, make_production_mesh
    from .op_analysis import analyze_step
    from .specs import build_step

    n = math.prod(PRODUCTION_MESHES[multi_pod][0])
    t0 = time.perf_counter()
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        cell = build_step(cfg, shape, mesh)  # meta arguments
        with FakeTensorMode():
            args = _fake_args(cell, device)
            build_s = time.perf_counter() - t0
            stats = analyze_step(cell.step, *args, mesh=mesh)
    shp = SHAPES[shape]
    return {"n_chips": n, "build_s": build_s, "run_s": time.perf_counter() - t0 - build_s,
            "stats": stats, "plan": cell.plans.get((shp.global_batch, shp.seq_len), (1, None))}


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str = RESULTS_DIR,
             verbose: bool = True, device: str = "cuda", cfg=None) -> dict:
    """One cell's record, also written to ``out_dir``.  ``cfg`` defaults to
    the arch's production config."""
    from .. import configs
    from ..models import count_active_params, count_params

    cfg = cfg or configs.get_config(arch)
    mesh_name = MESH_NAMES[multi_pod]
    res = analyze_cell(cfg, shape, multi_pod, device)
    stats = res["stats"]
    op_stats = stats.asdict()
    memory = op_stats.pop("memory")
    chunks, rule = res["plan"]
    # the rule counts the card's path (the kernels); the plain versions on CPU ranks hold more
    if device == "cuda" and rule is not None and rule < memory["per_device_total"]:
        raise AssertionError(f"the memory rule's estimate {rule} B is below the measured peak "
                             f"{memory['per_device_total']} B")
    record = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "n_chips": res["n_chips"],
        "device": device,
        "kernels": "custom ops" if device == "cuda" else "plain",
        "params": count_params(cfg),
        "active_params": count_active_params(cfg),
        "build_s": round(res["build_s"], 2),
        "run_s": round(res["run_s"], 2),
        "memory": memory,
        "row_chunks": chunks,
        "memory_rule": rule,
        "op_stats": op_stats,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json"), "w") as f:
        json.dump(record, f, indent=1)
    if verbose:
        print(f"[dryrun] OK {arch:24s} {shape:12s} {mesh_name:7s} run={res['run_s']:6.1f}s "
              f"mem/dev={memory['per_device_total'] / 2**30:7.2f}GiB R={chunks} "
              f"flops={stats.flops:.3e} "
              f"coll={stats.collective_bytes:.3e}B", flush=True)
    return record


def _run_one(arch: str, shape: str, multi: bool, out_dir: str, device: str) -> dict:
    """One cell of ``--all`` in a worker process: its summary entry, OK or
    FAIL with the exception."""
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    entry = {"arch": arch, "shape": shape, "mesh": MESH_NAMES[multi]}
    t0 = time.perf_counter()
    try:
        run_cell(arch, shape, multi, out_dir, device=device)
        entry["ok"] = True
    except Exception as e:  # the table records every cell; the run goes on
        entry.update(ok=False, error=f"{type(e).__name__}: {e}")
        print(f"[dryrun] FAIL {arch} {shape} {entry['mesh']}: {entry['error']}", flush=True)
        traceback.print_exc()
    entry["seconds"] = round(time.perf_counter() - t0, 2)
    return entry


def main(argv: "list[str] | None" = None) -> int:
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing as mp

    from .. import configs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the H100 step with the kernels' ops (a CUDA build of "
                         "PyTorch); cpu: the plain versions on CPU ranks")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a worker process of its own")
    args = ap.parse_args(argv)

    if args.all:
        archs = list(configs.ARCH_IDS)
    elif args.arch:
        archs = [args.arch]
    else:
        ap.error("--arch or --all required")

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    todo = []
    for arch in archs:
        for shape in [args.shape] if args.shape else configs.cells(arch):
            for multi in meshes:
                path = os.path.join(args.out, f"{arch}__{shape}__{MESH_NAMES[multi]}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] skip {arch} {shape} {MESH_NAMES[multi]} (exists)", flush=True)
                    continue
                todo.append((arch, shape, multi))
    # the training cells, the longest, start first
    order = sorted(range(len(todo)), key=lambda i: (todo[i][1] != "train_4k", i))
    with ProcessPoolExecutor(max_workers=args.jobs, mp_context=mp.get_context("spawn")) as pool:
        futures = {i: pool.submit(_run_one, *todo[i], args.out, args.device) for i in order}
        cells = [futures[i].result() for i in range(len(todo))]
    failures = [c for c in cells if not c["ok"]]
    if args.all:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump({"device": args.device, "cells": cells}, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f["arch"], f["shape"], f["mesh"], f["error"])
        return 1
    print("\nall dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
