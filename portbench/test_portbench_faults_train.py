"""The check that decides ``correct`` fails what it must in the training
cell: runs of the cell's driver at the program's smoke sizes on the CPU
(the look for a card skipped), the timed path broken underneath, judged by
the cell's own limits; and the control, the float8 reference in the
program's place.  The sound run, in float32 compute, passes the same
limits."""

from __future__ import annotations

import dataclasses

import pytest

from portbench import check, control, harness
from portbench.smoke import smoke_cell

TRAIN = ["deepseek-train-8x2048"]
SEED = 3 * 2 ** 31 + 5


def _cell(workload):
    cell, cfg = smoke_cell(workload, batch=2, seq_len=16)
    return cell, dataclasses.replace(cfg, compute_dtype="float32")


def _run(cell, cfg):
    return harness.run_cell(cell, SEED, 0.05, False, "cpu", port_cfg=cfg, config_check=False)


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_training_run_is_correct(workload):
    r = _run(*_cell(workload))
    assert r["correct"], r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_broken_training_step_is_not_correct(workload, fault):
    with getattr(control, fault)():
        r = _run(*_cell(workload))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_training_control_is_not_correct(workload):
    cell, _ = _cell(workload)
    family = harness.reference_family(cell.config)
    low = check.reference_train(family, cell.config, cell.traffic, SEED, "cpu", "fp8",
                                keep_grad=True)
    ref = check.reference_train(family, cell.config, cell.traffic, SEED, "cpu",
                                other_grad=low.pop("first_grad"))
    numbers, _ = check.train_numbers(low, ref)
    assert any(numbers[k] > v["limit"] for k, v in cell.limits.items()), numbers
