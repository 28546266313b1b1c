"""The benchmark's driver: finds a cell by its name in ``BENCHMARK.json``,
runs it on the card, checks it against the plain reference and prints the
result line.

A cell's configuration, traffic mix and per-layer metrics are found by
name, as files: ``configs/<config>.json`` (its ``reference`` names the model
family's module ``reference/<family>.py``), ``traffic/<traffic>.json`` (its
``kind`` picks the driver: ``cell_train.py`` or ``cell_serve.py``),
``metrics/<metric>.py`` (a ``read(ctx)`` that returns a number or None) and
``limits/<workload>.json`` (the limit of each number the check compares).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, each compared number beside its limit;
the same numbers close standard error.  A run whose process has loaded
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` (top-level module
names compared whole) prints no result and exits 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["Cell", "load_cell", "run_cell", "main", "forbidden_modules", "port_config",
           "check_port_matches"]


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def _listed(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = root / manifest["paths"][0]
    return Cell(
        workload=w,
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _listed(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _listed(m, name)],
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
    )


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def reference_family(config: dict):
    """The module ``reference/<config's reference>.py`` of the model family:
    the plain reference (``param_table``, ``hidden``, ``head``,
    ``loss_sum``), and what the harness needs of the family beside it:
    ``expected(cfg, c)``, the program's sizes against the file's;
    ``forward_flops(c, S)``, the model FLOPs of the ``mfu`` metrics;
    ``smoke_sizes(cfg)``, the file's sizes at a smoke configuration."""
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def port_config(config: dict):
    """The program's configuration: its config module's, with the file's
    overrides."""
    from repro_torch import configs

    cfg = configs.get_config(config["port"]["arch"])
    return dataclasses.replace(cfg, **config["port"]["overrides"])


def _expected(cfg, c: dict) -> dict:
    """``{name: (program's value, file's value)}`` of the sizes both state:
    those every family states, then the family module's ``expected``."""
    pairs = {
        "d_model": (cfg.d_model, c["hidden_size"]),
        "n_heads": (cfg.n_heads, c["num_attention_heads"]),
        "n_kv_heads": (cfg.n_kv_heads, c["num_key_value_heads"]),
        "vocab": (cfg.vocab, c["vocab_size"]),
        "n_layers": (cfg.n_layers, c["num_hidden_layers"]),
        "norm_eps": (cfg.norm_eps, c["rms_norm_eps"]),
        "rope_theta": (cfg.rope_theta, c["rope_theta"]),
        "tie_embeddings": (cfg.tie_embeddings, c["tie_word_embeddings"]),
        "compute_dtype": (cfg.compute_dtype, c["compute_dtype"]),
        "param_dtype": (cfg.param_dtype, c["param_dtype"]),
    }
    pairs.update(reference_family(c).expected(cfg, c))
    return pairs


def check_port_matches(cfg, c: dict) -> None:
    """Raises unless the program's configuration is the one the file states."""
    wrong = {k: v for k, v in _expected(cfg, c).items() if v[0] != v[1]}
    if wrong:
        raise ValueError(f"the program's {cfg.name} differs from {c['name']}: {wrong}")


def _process_start() -> float:
    """The ``time.time()`` at which this process started (Linux), or now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def _load_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``<root>/portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    metrics_dir = str(path.parent)
    if metrics_dir not in sys.path:
        sys.path.insert(0, metrics_dir)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             started: "float | None" = None, port_cfg=None, config_check: bool = True) -> dict:
    """Runs one cell and returns the result object (``checks`` last).
    ``port_cfg`` replaces the program's configuration (the CPU tests' small
    sizes), and then ``config_check`` may skip holding it to the file."""
    started = time.time() if started is None else started
    if port_cfg is None:
        port_cfg = port_config(cell.config)
    if config_check:
        check_port_matches(port_cfg, cell.config)
    kind = cell.traffic["kind"]
    driver = importlib.import_module(f"portbench.cell_{kind}")
    out = driver.run(cell, port_cfg, seed, seconds, trace, device, started)
    print(f"{cell.workload['name']}: set-up {out['end_to_end']['setup_s']:.3f} s, window "
          f"{out['ctx']['window_s']:.3f} s, check {out['check_s']:.3f} s", file=sys.stderr)
    for line in out["detail"]:
        print(line, file=sys.stderr)
    print(f"numbers {json.dumps(out['checks'])}", file=sys.stderr)
    e2e = {}
    for m in cell.end_to_end:
        if m["name"] not in out["end_to_end"]:
            raise RuntimeError(f"the {kind} driver gives no {m['name']}")
        e2e[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    metrics = e2e
    if trace:
        ctx = dict(out["ctx"], config=cell.config, traffic=cell.traffic,
                   family=reference_family(cell.config))
        metrics = {}
        for m in cell.per_layer:
            value = _load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {}
    correct = out["answered"]
    for name, spec in cell.limits.items():
        value, limit = out["checks"][name], spec["limit"]
        checks[name] = {"value": value, "limit": limit}
        correct = correct and math.isfinite(value) and value <= limit
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": out["device_kind"], "count": cell.workload["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        dev["busy_s"] = out["ctx"].get("busy_s")
        dev["window_s"] = out["ctx"]["window_s"]
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them: a card
    set below its 700 W runs slower under load, and every roofline share is
    read against the full-power peaks."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def main(argv=None) -> int:
    started = _process_start()
    ap = argparse.ArgumentParser(description="Run one cell of the repro_torch benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
        print(f"portbench: {args.workload} needs {cell.workload['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark may not load JAX or the JAX "
              f"package", file=sys.stderr)
        return 3
    print(f"card: {_card()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
