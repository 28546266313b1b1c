"""Roofline analysis over the dry-run records (``launch/dryrun.py``): the
port's counterpart of the reference's ``launch/roofline.py``, on H100 terms.

Hardware model: one NVIDIA H100 SXM a rank (NVIDIA's data sheet, dense
rates): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, 80 GB a
card; NVLink at 450 GB/s each way between the 8 cards of a node, which is
the ``"model"`` dim of ``launch/mesh.py``'s meshes; 400 Gb/s InfiniBand, 50
GB/s a card, over ``"data"`` and ``"pod"``, which cross nodes.

Terms (seconds per step, per card; ``op_analysis.py``'s counts are
rank-local):

  compute    = op FLOPs / peak FLOP/s
  memory     = op bytes accessed / HBM rate
  collective = sum over mesh dims of that dim's collective bytes / its link rate

The reference sums all collective bytes over one link rate; here each mesh
dim has its own.  The bottleneck is the largest term; the *roofline
fraction* is the useful model FLOPs' share of the card at the modeled step
time, ``MODEL_FLOPS / chips / peak / max(terms)``.  ``MODEL_FLOPS`` is the
reference's: 6 N D for training and 2 N D for prefill and decode (N the
active parameters, embedding table excluded unless tied; D the tokens).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--results build/dryrun] [--mesh 2x32x8]
"""

from __future__ import annotations

import glob
import json
import math
import os

#: H100 SXM, NVIDIA's data sheet: bf16 dense FLOP/s, HBM3 bytes/s, bytes a card
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
#: bytes/s a card each way: NVLink inside a node, 400 Gb/s InfiniBand across nodes
NVLINK_BW = 450e9
IB_BW = 50e9
#: mesh dim -> the link its collectives cross; any other dim (a world group,
#: pipeline stages) crosses nodes
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

__all__ = ["roofline_row", "load_all", "format_table", "collective_seconds", "PEAK_FLOPS",
           "HBM_BW", "HBM_BYTES", "NVLINK_BW", "IB_BW", "LINK_BW"]


def _model_flops(record: dict) -> float:
    from .. import configs
    from ..models import SHAPES, count_active_params, param_specs

    cfg = configs.get_config(record["arch"])
    shp = SHAPES[record["shape"]]
    # matmul-active params: exclude the embedding lookup table (gather), keep
    # the LM head (tied embeds are used as a matmul there: count once)
    n_active = count_active_params(cfg)
    specs = param_specs(cfg)
    if "embed" in specs and not cfg.tie_embeddings:
        n_active -= math.prod(specs["embed"].shape)
    if shp.kind == "train":
        tokens = shp.global_batch * shp.seq_len
        return 6.0 * n_active * tokens
    if shp.kind == "prefill":
        tokens = shp.global_batch * shp.seq_len
        return 2.0 * n_active * tokens
    tokens = shp.global_batch  # one token per sequence
    return 2.0 * n_active * tokens


def collective_seconds(collectives_by_dim: dict) -> float:
    """Each mesh dim's collective bytes over its own link rate, summed."""
    return sum(sum(kinds.values()) / LINK_BW.get(dim, IB_BW)
               for dim, kinds in collectives_by_dim.items())


def roofline_row(record: dict) -> dict:
    chips = record["n_chips"]
    st = record["op_stats"]
    t_compute = st["flops"] / PEAK_FLOPS
    t_memory = st["bytes_accessed"] / HBM_BW
    t_coll = collective_seconds(st["collectives_by_dim"])
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values()) or 1e-12

    mf = _model_flops(record)
    useful_mfu_at_roofline = (mf / chips / PEAK_FLOPS) / step_time
    flops_ratio = mf / max(st["flops"] * chips, 1e-9)

    return {
        "arch": record["arch"],
        "shape": record["shape"],
        "mesh": record["mesh"],
        "chips": chips,
        "device": record.get("device", "cuda"),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": bottleneck,
        "model_flops": mf,
        "useful_flops_ratio": flops_ratio,  # MODEL_FLOPS / (op FLOPs * chips)
        "roofline_fraction": useful_mfu_at_roofline,
        "mem_per_dev_gib": record["memory"]["per_device_total"] / 2**30,
        "fits": record["memory"]["per_device_total"] <= HBM_BYTES,
        "collectives": st.get("collectives", {}),
        "collectives_by_dim": st.get("collectives_by_dim", {}),
    }


def load_all(results_dir: str) -> list:
    """A row for each cell record (``<arch>__<shape>__<mesh>.json``)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*__*__*.json"))):
        with open(path) as f:
            rows.append(roofline_row(json.load(f)))
    return rows


def format_table(rows: list, mesh: str | None = None) -> str:
    sel = [r for r in rows if mesh is None or r["mesh"] == mesh]
    hdr = (
        f"{'arch':24s} {'shape':12s} {'mesh':7s} {'compute_s':>10s} {'memory_s':>10s} "
        f"{'collect_s':>10s} {'bound':>10s} {'useful':>7s} {'roofline':>9s} {'GiB/dev':>8s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in sel:
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:7s} "
            f"{r['t_compute_s']:10.4f} {r['t_memory_s']:10.4f} {r['t_collective_s']:10.4f} "
            f"{r['bottleneck']:>10s} {r['useful_flops_ratio']:7.2f} "
            f"{r['roofline_fraction']:9.3f} {r['mem_per_dev_gib']:8.2f}"
        )
    return "\n".join(lines)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                                      "build", "dryrun"))
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    rows = load_all(os.path.abspath(args.results))
    print(format_table(rows, args.mesh))


if __name__ == "__main__":
    main()
