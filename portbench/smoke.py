"""Small cells for the CPU tests: a configuration file's sizes replaced by
those of the program's smoke configuration of the same family, and a
traffic mix cut to a few short rows or prompts."""

from __future__ import annotations

import copy

from .harness import Cell, load_cell, reference_family


def smoke_config(config: dict, cfg) -> dict:
    """``config`` with the sizes of the program's ``cfg`` (a smoke config)."""
    c = copy.deepcopy(config)
    c.update(hidden_size=cfg.d_model, num_attention_heads=cfg.n_heads,
             num_key_value_heads=cfg.n_kv_heads, vocab_size=cfg.vocab,
             num_hidden_layers=cfg.n_layers, rms_norm_eps=cfg.norm_eps,
             rope_theta=cfg.rope_theta)
    c.update(reference_family(c).smoke_sizes(cfg))
    return c


def smoke_cell(workload: str, **traffic) -> tuple[Cell, object]:
    """``(the cell at smoke sizes, the program's smoke config)``."""
    from repro_torch import configs

    cell = load_cell(workload)
    cfg = configs.get_smoke_config(cell.config["port"]["arch"])
    cell.config = smoke_config(cell.config, cfg)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell, cfg
