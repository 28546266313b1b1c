"""Fused Parzen scorer: the TPE acquisition ``log l(x) - log g(x)``.

Wrapper around the hand-written CUDA kernel in ``csrc/parzen.cu``, which
replaces the reference package's Pallas kernel
(``repro/kernels/parzen.py::parzen_score_kernel``).  The kernel streams both
mixtures' components through shared memory with an online ``(m, l)``
logsumexp per side, so the ``(C, K)`` exponent matrix never exists; the
source states its design and its bound on the card.

CPU tensors take the plain PyTorch version (``kernels/ref.py``); CUDA
tensors launch the kernel or raise.  Every launch adds one to a
thread-safe counter (:func:`launches`), so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import threading

import torch

from .ref import parzen_score_ref

__all__ = ["parzen_score", "launches", "reset_launches"]

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


def _check(cands: torch.Tensor, *comps: torch.Tensor) -> None:
    device = cands.device
    for name, t in zip(("cands", "l_mus", "l_sigmas", "l_log_norm",
                        "g_mus", "g_sigmas", "g_log_norm"), (cands, *comps)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, cands on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for side, (mus, sigmas, ln) in (("l", comps[:3]), ("g", comps[3:])):
        if not (len(mus) == len(sigmas) == len(ln)):
            raise ValueError(f"{side}-side component arrays differ in length")
        if len(mus) == 0:
            raise ValueError(f"{side}-side mixture has no components")


def parzen_score(
    cands: torch.Tensor,  # [C]
    l_mus: torch.Tensor, l_sigmas: torch.Tensor, l_log_norm: torch.Tensor,  # [Kl]
    g_mus: torch.Tensor, g_sigmas: torch.Tensor, g_log_norm: torch.Tensor,  # [Kg]
) -> torch.Tensor:
    """``log l(cands) - log g(cands)`` as a [C] float32 tensor on the inputs'
    device.  All inputs are 1-D, contiguous, float32 and on one device; the
    two sides may differ in length, and ``-inf`` ``log_norm`` entries are
    inert padding."""
    comps = (l_mus, l_sigmas, l_log_norm, g_mus, g_sigmas, g_log_norm)
    _check(cands, *comps)
    if cands.device.type == "cpu":
        return parzen_score_ref(cands, *comps)
    if cands.device.type != "cuda":
        raise ValueError(f"parzen_score runs on CPU or CUDA tensors, got {cands.device}")
    out = torch.empty_like(cands)
    if len(cands) == 0:
        return out
    from ._build import load

    lib = load()
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        err = lib.parzen_score_launch(
            cands.data_ptr(), len(cands),
            l_mus.data_ptr(), l_sigmas.data_ptr(), l_log_norm.data_ptr(), len(l_mus),
            g_mus.data_ptr(), g_sigmas.data_ptr(), g_log_norm.data_ptr(), len(g_mus),
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"parzen_score kernel launch failed: cudaError {err}")
    _count_launch()
    return out
