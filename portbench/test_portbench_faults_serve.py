"""The check that decides ``correct`` fails what it must in the serving
cell: runs of its driver at the program's smoke sizes on the CPU (the look
for a card skipped), judged by the cell's own limit: a served token
altered where it is produced, and the control, the float8 reference's
first tokens.  The sound run, in float32 compute, passes the same limit."""

from __future__ import annotations

import dataclasses

from portbench import cell_serve, control, harness
from portbench.smoke import smoke_cell

SERVE = "deepseek-serve-docs"
SEED = 3 * 2 ** 31 + 5


def _cell():
    cell, cfg = smoke_cell(SERVE, prompt_min=20, prompt_max=61, groups_per_cycle=8, capacity=70,
                           check_groups=8)
    return cell, dataclasses.replace(cfg, compute_dtype="float32")


def _run(cell, cfg):
    return harness.run_cell(cell, SEED, 0.2, False, "cpu", port_cfg=cfg, config_check=False)


def test_sound_serving_run_is_correct():
    r = _run(*_cell())
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_altered_token_is_not_correct():
    with control.token_altered():
        r = _run(*_cell())
    assert not r["correct"], r["checks"]


def test_serving_control_is_not_correct():
    cell, cfg = _cell()
    lows: list = []
    with control.control_gaps(lows):
        _run(cell, cfg)
    numbers = cell_serve.gap_numbers(lows)
    assert any(numbers[k] > v["limit"] for k, v in cell.limits.items()), numbers
