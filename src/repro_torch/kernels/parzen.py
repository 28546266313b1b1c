"""Fused Parzen scorer: the TPE acquisition ``log l(x) - log g(x)``.

Wrapper around the hand-written CUDA kernel in ``csrc/parzen.cu``, which
replaces the reference package's Pallas kernel
(``repro/kernels/parzen.py::parzen_score_kernel``).  The kernel splits both
mixtures' components across blocks and warps, each folding its share with
an online ``(m, l)`` logsumexp per side, so the ``(C, K)`` exponent matrix
never exists, and merges the partial states in the same launch in a fixed
order (bitwise repeatable scores); the source states its design and its
bound on the card.  The kernel's host code sizes the two workspaces, the
merge's tickets and the partials; the wrapper keeps one pair of buffers per
(device, stream), the tickets zeroed (every launch leaves them zero), grown
when a call needs more, so an eager call allocates nothing.  Under
CUDA-graph capture a call takes buffers of its own from the graph's pool.

CPU tensors take the plain PyTorch version (``kernels/ref.py``); CUDA
tensors launch the kernel or raise.  The launch is the custom op
``torch.ops.repro_torch.parzen_score`` (``kernels/ops.py``), with a fake
implementation and a FLOP formula (9 operations, the exp among them, per
(candidate, component) pair).  Every launch adds one to a
thread-safe counter (:func:`launches`), so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .ops import flop_formula, kernel_op
from .ref import parzen_score_ref

__all__ = ["parzen_score", "parzen_flops", "launches", "reset_launches", "OPS_PER_PAIR"]

#: float32 operations per (candidate, component) pair besides the exp
OPS_PER_PAIR = 8

_count_lock = threading.Lock()
_launches = 0
#: device index -> its SM count
_sms: dict = {}
#: (device index, stream) -> (tickets, partials): the kernel's workspaces, the
#: tickets zero between launches
_workspaces: dict = {}


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


def _sm_count(index: int) -> int:
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


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
    if len(cands) == 0:
        return torch.empty_like(cands)
    return _parzen_op(cands, *comps)


@kernel_op("parzen_score")
def _parzen_op(cands: torch.Tensor, l_mus: torch.Tensor, l_sigmas: torch.Tensor,
               l_log_norm: torch.Tensor, g_mus: torch.Tensor, g_sigmas: torch.Tensor,
               g_log_norm: torch.Tensor) -> torch.Tensor:
    """The kernel's launch on CUDA tensors that :func:`parzen_score` has
    checked: a new [C] tensor.  The workspaces it reuses are the wrapper's,
    never an input."""
    comps = (l_mus, l_sigmas, l_log_norm, g_mus, g_sigmas, g_log_norm)
    out = torch.empty_like(cands)
    if torch.cuda.current_device() == cands.device.index:
        _launch(cands, comps, out)
    else:
        with torch.cuda.device(cands.device):
            _launch(cands, comps, out)
    _count_launch()
    return out


@_parzen_op.register_fake
def _(cands, l_mus, l_sigmas, l_log_norm, g_mus, g_sigmas, g_log_norm):
    return torch.empty_like(cands)


@flop_formula("parzen_score")
def parzen_flops(cands_shape, l_mus_shape, l_sigmas_shape, l_log_norm_shape, g_mus_shape,
                 g_sigmas_shape, g_log_norm_shape, *, out_shape=None, **kwargs) -> int:
    """Per (candidate, component) pair of both mixtures: the standardized
    distance, its square, the log density and the online logsumexp's max and
    sum, :data:`OPS_PER_PAIR` float32 operations, and one exp."""
    return cands_shape[0] * (l_mus_shape[0] + g_mus_shape[0]) * (OPS_PER_PAIR + 1)


def _launch(cands: torch.Tensor, comps: tuple, out: torch.Tensor) -> None:
    """The kernel on the current device's current stream."""
    from ._build import load

    lib = load()
    l_mus, l_sigmas, l_ln, g_mus, g_sigmas, g_ln = comps
    C, Kl, Kg = len(cands), len(l_mus), len(g_mus)
    index = cands.device.index
    sms = _sm_count(index)
    stream = torch._C._cuda_getCurrentRawStream(index)  # no Stream object: host time a call
    capturing = torch.cuda.is_current_stream_capturing()
    key = (index, stream)

    def launch(ws):
        tickets, partial = ws
        return lib.parzen_score_launch(
            cands.data_ptr(), C, l_mus.data_ptr(), l_sigmas.data_ptr(), l_ln.data_ptr(), Kl,
            g_mus.data_ptr(), g_sigmas.data_ptr(), g_ln.data_ptr(), Kg, sms,
            tickets.data_ptr() if tickets is not None else None,
            tickets.numel() if tickets is not None else 0,
            partial.data_ptr() if partial is not None else None,
            partial.numel() if partial is not None else 0,
            out.data_ptr(), stream,
        )

    ws = (None, None) if capturing else _workspaces.get(key, (None, None))
    err = launch(ws)
    if err == -1:  # a workspace is missing or too small: grow both
        sizes = (ctypes.c_longlong * 2)()
        lib.parzen_score_workspace(C, Kl, Kg, sms, sizes)
        have = [0 if buf is None else buf.numel() for buf in ws]
        ws = (torch.zeros(max(sizes[0], have[0]), dtype=torch.uint8, device=cands.device),
              torch.empty(max(sizes[1], have[1]), dtype=torch.uint8, device=cands.device))
        if not capturing:  # a graph's tickets are zeroed only when the graph replays
            with _count_lock:
                _workspaces[key] = ws
        err = launch(ws)
    if err != 0:
        raise RuntimeError(f"parzen_score kernel launch failed: cudaError {err}")
