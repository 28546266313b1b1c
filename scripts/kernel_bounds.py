"""Each kernel's bound at the main paths' shapes, from its registered FLOP
formula and its bytes (``launch/op_analysis.py``: inputs read once, outputs
written once), as ``PERF.md``'s kernel table states them.

    PYTHONPATH=src python scripts/kernel_bounds.py

Arithmetic on shapes only: every op is called on fake tensors
(``FakeTensorMode``), so this runs on the CPU and nothing launches.  The
rate is the one ``chip_smoke.py`` reads each kernel against (NVIDIA's H100
SXM data sheet): bf16 tensor cores for the bf16 flash attention and
cross-entropy, the float32 CUDA cores for the rest (the SSD and sLSTM
recurrences are float32 in the reference), and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

# importing the kernel modules registers their ops and formulas
from repro_torch.kernels import (crossentropy, flash_attention, hypervolume,  # noqa: F401
                                 parzen, slstm, ssd)
from repro_torch.launch.op_analysis import analyze_step, kernel_ops

BF16_TC, FP32, HBM = 989e12, 67e12, 3.35e12
OPS = torch.ops.repro_torch
F32, BF16 = torch.float32, torch.bfloat16


def _e(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype)


def _flash(B, Hq, Hkv, Sq, Skv, D, window=-1, causal=True, kv_len=None):
    q = _e(B, Sq, Hq, D, dtype=BF16).transpose(1, 2)
    k = _e(B, Skv, Hkv, D, dtype=BF16).transpose(1, 2)
    return OPS.flash_attention, (q, k, k, causal, window, 0.0, 0, kv_len or Skv)


def _ce(T, D, V):
    return OPS.crossentropy, (_e(T, D, dtype=BF16), _e(D, V), _e(T, dtype=torch.int64), 0.0)


def _ssd(B, S, H, P, G, N, chunk, init):
    x = _e(B, S, H, P, dtype=BF16)
    bc = _e(B, S, G, N, dtype=BF16)
    return OPS.ssd, (x, _e(B, S, H), _e(H), bc, bc, chunk, _e(B, H, P, N) if init else None)


def _slstm(B, S, H, D):
    c = _e(B, H, D)
    return OPS.slstm, (_e(B, S, 4 * H * D, dtype=BF16), _e(4, H, D, D), c, c, c, c, False)


#: (row, label, op and arguments, rate)
ROWS = [
    ("1", "Parzen, score table C 4096 vs 26 / 4072",
     lambda: (OPS.parzen_score, (_e(4096), *[_e(26)] * 3, *[_e(4072)] * 3)), FP32),
    ("1b", "Parzen, 24 cands vs 26 / 4072",
     lambda: (OPS.parzen_score, (_e(24), *[_e(26)] * 3, *[_e(4072)] * 3)), FP32),
    ("1b", "Parzen, 24 cands vs 2 / 10",
     lambda: (OPS.parzen_score, (_e(24), *[_e(2)] * 3, *[_e(10)] * 3)), FP32),
    ("2", "MC counts 25 x 8192 x 5", lambda: (OPS.mc_hv_counts, (_e(25, 5), _e(8192, 5))), FP32),
    ("2b", "MC counts, 143 sets / 3432 points x 8192 x 5",
     lambda: (OPS.mc_hv_counts_sets, (_e(3432, 5), _e(144, dtype=torch.int32),
                                      _e(143, 5, dtype=torch.float64),
                                      _e(143, 5, dtype=torch.float64),
                                      _e(8192, 5, dtype=torch.float64))), FP32),
    ("3", "CE tinyllama T 16384, D 2048, V 32000", lambda: _ce(16384, 2048, 32000), BF16_TC),
    ("3", "CE gemma2 T 8192, D 3584, V 256000", lambda: _ce(8192, 3584, 256000), BF16_TC),
    ("3", "CE qwen3-moe T 2048, D 4096, V 151936", lambda: _ce(2048, 4096, 151936), BF16_TC),
    ("4", "flash tinyllama B 8, S 2048, 32 / 4 heads, D 64",
     lambda: _flash(8, 32, 4, 2048, 2048, 64), BF16_TC),
    ("4", "flash gemma2 B 2, S 8192, 16 / 8 heads, D 256, window 4096",
     lambda: _flash(2, 16, 8, 8192, 8192, 256, window=4096), BF16_TC),
    ("4", "flash gemma2 global", lambda: _flash(2, 16, 8, 8192, 8192, 256), BF16_TC),
    ("5", "SSD zamba2 B 8, S 2048, 64 heads, P = N = 64, L 128",
     lambda: _ssd(8, 2048, 64, 64, 1, 64, 128, False), FP32),
    ("6", "sLSTM xlstm B 8, S 2048, 4 heads of 512", lambda: _slstm(8, 2048, 4, 512), FP32),
    ("6", "sLSTM decode B 8, 4 heads of 512", lambda: _slstm(8, 1, 4, 512), FP32),
]


def main() -> None:
    print(f"{'row':4s} {'shape':58s} {'FLOPs':>14s} {'bytes':>14s} {'bound ms':>10s} by")
    for row, label, make, rate in ROWS:
        with FakeTensorMode():
            op, args = make()
            st = analyze_step(op, *args, memory=False)
        (k,) = kernel_ops(st).values()
        ops_s, bytes_s = k["flops"] / rate, k["bytes"] / HBM
        by = "operations" if ops_s >= bytes_s else "bytes"
        print(f"{row:4s} {label:58s} {k['flops']:14.6e} {k['bytes']:14.6e} "
              f"{1e3 * max(ops_s, bytes_s):10.7f} {by}")


if __name__ == "__main__":
    main()
