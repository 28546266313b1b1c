"""The yardstick of the kernel metrics: the H100's peaks and a frozen copy
of each kernel's operation and byte counts.

The FLOP formulas are copies of the ones ``repro_torch`` registers on its
kernel ops (``kernels/ssd.py::ssd_flops``,
``kernels/flash_attention.py::flash_attention_flops``,
``kernels/crossentropy.py::crossentropy_flops``); the bytes follow the
port's op analysis: every input read once and every output written once.
``test_portbench_rooflines.py`` holds the copies to the registered formulas
at the cells' shapes.  A change to the program cannot move this yardstick.
"""

from __future__ import annotations

import math
import re

#: NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, float32 on
#: the CUDA cores, HBM3 bandwidth and size
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12
HBM_BYTES = 80e9

_SIZE = {"bfloat16": 2, "float32": 4, "int64": 8}


def bound_s(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """``(the least time the card could take, which term sets it)``."""
    ops_s, bytes_s = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def ssd_chunk_len(S: int, chunk: int) -> int:
    return min(chunk, S)


def ssd_flops(b: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Per batch row and head, each chunk of ``l`` steps: ``l (l + 1) / 2``
    causal pairs at ``2 N + 2 P`` FLOPs, and ``4 l P N`` for the state's
    read into ``y`` and its update."""
    L = ssd_chunk_len(S, chunk)
    lens = [L] * (S // L) + ([S % L] if S % L else [])
    return b * H * sum(n * (n + 1) // 2 * (2 * N + 2 * P) + 4 * n * P * N for n in lens)


def ssd_bytes(b: int, S: int, H: int, P: int, G: int, N: int, dtype: str,
              initial_state: bool = False) -> int:
    """Inputs ``xh``, ``Bm``, ``Cm`` in ``dtype``, ``dt`` and ``A`` float32
    (and the initial state); outputs ``y`` and the final state float32."""
    e = _SIZE[dtype]
    ins = b * S * H * P * e + 2 * b * S * G * N * e + b * S * H * 4 + H * 4
    ins += b * H * P * N * 4 if initial_state else 0
    return ins + b * S * H * P * 4 + b * H * P * N * 4


def attention_pairs(Sq: int, Skv: int, causal: bool = True) -> int:
    """(query, key) pairs of one row and head: the causal band, or all."""
    if not causal:
        return Sq * Skv
    return sum(min(Skv - 1, q) + 1 for q in range(Sq))


def flash_flops(B: int, Hq: int, Sq: int, Skv: int, D: int, causal: bool = True) -> int:
    """``QK^T`` and ``PV``: ``4 D`` FLOPs a computed pair and head."""
    return 4 * D * B * Hq * attention_pairs(Sq, Skv, causal)


def flash_bytes(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int, dtype: str) -> int:
    """``q`` and the output ``[B, Hq, Sq, D]``, ``k`` and ``v`` ``[B, Hkv,
    Skv, D]``, all in ``dtype``."""
    return _SIZE[dtype] * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D)


def ce_flops(T: int, D: int, V: int) -> int:
    """The logits' product inside the kernel: ``2 T D V``."""
    return 2 * T * D * V


def ce_bytes(T: int, D: int, V: int, x_dtype: str, w_dtype: str) -> int:
    """``x [T, D]``, the head ``w [D, V]``, int64 labels; ``nll`` and
    ``lse`` float32."""
    return T * D * _SIZE[x_dtype] + D * V * _SIZE[w_dtype] + T * 8 + 2 * T * 4


def kernel_seconds(kernels, names: tuple) -> tuple[int, float]:
    """``(launches, summed device seconds)`` of the trace's kernels whose
    function is one of ``names``: the trace shows the demangled signature,
    such as ``void (anonymous namespace)::ssd_tc_kernel<4>(...)``, so a
    name matches as a whole identifier followed by its template or
    argument list."""
    pattern = re.compile(r"(?<![A-Za-z0-9_])(%s)\s*[<(]" % "|".join(map(re.escape, names)))
    n, total = 0, 0.0
    for name, _, dur in kernels:
        if pattern.search(name):
            n += 1
            total += dur
    return n, total


def share(bound: float, launches: int, seconds: float) -> "float | None":
    """Percent of the roofline: ``launches`` x the bound over their time,
    or None where the trace holds no launch."""
    if launches == 0 or seconds <= 0 or not math.isfinite(seconds):
        return None
    return 100.0 * launches * bound / seconds
