"""Monte-Carlo hypervolume counting: exclusive and total domination counts.

Wrapper around the hand-written CUDA kernel in ``csrc/hypervolume.cu``,
which replaces the reference package's Pallas kernel
(``repro/kernels/hypervolume.py::mc_hv_kernel``).  For points ``[n, m]`` and
samples ``[s, m]`` it counts the samples dominated by at least one point
(``total``) and, per point, the samples that point alone dominates
(``excl``); the source states its design and its bound on the card.

CPU tensors take the plain PyTorch version (``kernels/ref.py``); CUDA
tensors launch the kernel or raise.  Every launch adds one to a
thread-safe counter (:func:`launches`), so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import threading

import torch

from .ref import mc_hv_counts_ref

__all__ = ["mc_hv_counts", "launches", "reset_launches"]

#: objectives one staged point tile of the kernel holds (``kTileFloats``)
MAX_OBJECTIVES = 4096

_count_lock = threading.Lock()
_launches = 0


def launches() -> int:
    """Kernel launches since the last :func:`reset_launches`."""
    with _count_lock:
        return _launches


def reset_launches() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _count_launch() -> None:
    global _launches
    with _count_lock:
        _launches += 1


def _check(points: torch.Tensor, samples: torch.Tensor) -> None:
    for name, t in (("points", points), ("samples", samples)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D [rows, objectives], got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if samples.device != points.device:
        raise ValueError(f"samples are on {samples.device}, points on {points.device}")
    if points.shape[1] != samples.shape[1]:
        raise ValueError(
            f"points have {points.shape[1]} objectives, samples {samples.shape[1]}"
        )
    if not 1 <= points.shape[1] <= MAX_OBJECTIVES:
        raise ValueError(f"objective count must be in [1, {MAX_OBJECTIVES}], got {points.shape[1]}")


def mc_hv_counts(
    points: torch.Tensor,  # [n, m]
    samples: torch.Tensor,  # [s, m]
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(excl [n] float32, total float32 0-d)`` on the inputs' device:
    ``total`` counts the samples that some point dominates (``<=`` in every
    objective; ties count, a NaN coordinate dominates nothing), ``excl[i]``
    the samples that point ``i`` alone dominates.  Both inputs are 2-D,
    contiguous, float32, on one device, with the same objective count."""
    _check(points, samples)
    if points.device.type == "cpu":
        return mc_hv_counts_ref(points, samples)
    if points.device.type != "cuda":
        raise ValueError(f"mc_hv_counts runs on CPU or CUDA tensors, got {points.device}")
    n, m = points.shape
    s = samples.shape[0]
    # one zeroed int32 buffer: excl in [0, n), total at [n]
    counts = torch.zeros(n + 1, dtype=torch.int32, device=points.device)
    if n and s:
        from ._build import load

        lib = load()
        with torch.cuda.device(points.device):
            stream = torch.cuda.current_stream(points.device).cuda_stream
            err = lib.mc_hv_counts_launch(
                points.data_ptr(), n, samples.data_ptr(), s, m,
                counts.data_ptr(), counts[n:].data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"mc_hv_counts kernel launch failed: cudaError {err}")
        _count_launch()
    out = counts.to(torch.float32)
    return out[:n], out[n]
