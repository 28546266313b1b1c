"""The benchmark's frozen FLOP and byte counts held to what the program's
kernel ops register (``kernels/ops.py::flop_formula`` and the op analysis's
bytes), on fake tensors (nothing launches): the cross-entropy kernel's at
the training cells' shape, and the SSD and flash kernels' at the shape the
program's zamba2-1.2b trains at 8 x 2048, which no cell runs yet."""

from __future__ import annotations

import json
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from portbench.harness import ROOT

sys.path.insert(0, str(ROOT / "portbench" / "metrics"))
import _rooflines as R  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
DEEPSEEK = json.loads((ROOT / "portbench/configs/deepseek-v2-lite-5l.json").read_text())
TRAIN = json.loads((ROOT / "portbench/traffic/train-8x2048.json").read_text())


def _registered(make):
    from repro_torch.kernels import crossentropy, flash_attention, ssd  # noqa: F401
    from repro_torch.launch.op_analysis import analyze_step, kernel_ops

    with FakeTensorMode():
        op, args = make(torch.ops.repro_torch)
        stats = analyze_step(op, *args, memory=False)
    (k,) = kernel_ops(stats).values()
    return k["flops"], k["bytes"]


def _e(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype)


def _zamba2():
    from repro_torch import configs

    return configs.get_config("zamba2-1.2b")


def test_ssd_at_the_zamba2_training_shape():
    cfg = _zamba2()
    b, S = TRAIN["batch"], TRAIN["seq_len"]
    P, N, G, chunk = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_chunk
    H = cfg.ssm_expand * cfg.d_model // P

    def make(ops):
        bc = _e(b, S, G, N, dtype=BF16)
        x = _e(b, S, H, P, dtype=BF16)
        return ops.ssd, (x, _e(b, S, H), _e(H), bc, _e(b, S, G, N, dtype=BF16), chunk, None)

    flops, nbytes = _registered(make)
    assert R.ssd_flops(b, S, H, P, N, chunk) == flops
    assert R.ssd_bytes(b, S, H, P, G, N, "bfloat16") == nbytes
    bound, by = R.bound_s(flops, nbytes, "bfloat16")
    assert by == "bytes" and bound == pytest.approx(1.2510e-4, rel=1e-3)


def test_flash_at_the_zamba2_training_shape():
    cfg = _zamba2()
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def make(ops):
        q = _e(B, S, H, D, dtype=BF16).transpose(1, 2)
        k = _e(B, S, KV, D, dtype=BF16).transpose(1, 2)
        v = _e(B, S, KV, D, dtype=BF16).transpose(1, 2)
        return ops.flash_attention, (q, k, v, True, -1, 0.0, 0, S)

    flops, nbytes = _registered(make)
    assert R.flash_flops(B, H, S, S, D) == flops
    assert R.flash_bytes(B, H, KV, S, S, D, "bfloat16") == nbytes


def test_crossentropy_at_the_training_shape():
    T, D, V = TRAIN["batch"] * TRAIN["seq_len"], DEEPSEEK["hidden_size"], DEEPSEEK["vocab_size"]

    def make(ops):
        return ops.crossentropy, (_e(T, D, dtype=BF16), _e(D, V), _e(T, dtype=torch.int64), 0.0)

    flops, nbytes = _registered(make)
    assert R.ce_flops(T, D, V) == flops
    assert R.ce_bytes(T, D, V, "bfloat16", "float32") == nbytes


def test_peaks_are_the_data_sheet_s():
    assert R.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert R.PEAK_BYTES_S == 3.35e12 and R.HBM_BYTES == 80e9


def test_model_flops_count_what_a_token_touches():
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import count_active_params

    from portbench.reference import deepseek

    cfg = configs.get_config(DEEPSEEK["port"]["arch"])
    cfg = dataclasses.replace(cfg, **DEEPSEEK["port"]["overrides"])
    S = TRAIN["seq_len"]
    pairs = S * (S + 1) // 2
    attention = 5 * 2 * 16 * (128 + 64 + 128) * pairs
    per_token = (deepseek.forward_flops(DEEPSEEK, S) - attention) // (2 * S)
    # the port's count of the active parameters also holds the embedding and the norm gains
    vectors = count_active_params(cfg) - per_token - DEEPSEEK["vocab_size"] * DEEPSEEK["hidden_size"]
    assert vectors == 5 * (2 * 2048 + 512) + 2048
    assert 3 * TRAIN["batch"] * deepseek.forward_flops(DEEPSEEK, S) == 63833062244352
