"""Monte-Carlo hypervolume counting: exclusive and total domination counts.

Wrappers around the hand-written CUDA kernels in ``csrc/hypervolume.cu``,
which replace the reference package's Pallas kernel
(``repro/kernels/hypervolume.py::mc_hv_kernel``).  For points ``[n, m]`` and
samples ``[s, m]`` they count the samples dominated by at least one point
(``total``) and, per point, the samples that point alone dominates
(``excl``); the source states the design and the bound on the card.

* :func:`mc_hv_counts`: one point set against float32 samples;
* :func:`mc_hv_counts_sets`: many point sets in one launch, each against
  samples made on the card from one shared float64 draw ``u`` and the set's
  own box (``float32(lo + span * u)``, the bits numpy's ``uniform`` and a
  float32 cast give on the host); :func:`mc_hv_samples` returns those
  samples, for checks.

CPU tensors take the plain PyTorch versions (``kernels/ref.py``); CUDA
tensors launch the kernels or raise.  Each counting launch is a custom op,
``torch.ops.repro_torch.mc_hv_counts`` and ``...mc_hv_counts_sets``
(``kernels/ops.py``), with a fake implementation and a FLOP formula (the
compares, and the batched kernel's sample arithmetic).  Every launch of the
two counting kernels adds one to its thread-safe counter (:func:`launches`,
:func:`set_launches`), so a run can show that its main path went through
them.
"""

from __future__ import annotations

import threading

import torch

from .ops import flop_formula, kernel_op
from .ref import mc_hv_counts_ref, mc_hv_counts_sets_ref, mc_hv_samples_ref

__all__ = ["mc_hv_counts", "mc_hv_counts_sets", "mc_hv_samples", "mc_hv_counts_flops",
           "mc_hv_counts_sets_flops", "launches", "set_launches", "reset_launches"]

#: objectives one staged point tile of the kernel holds (``kTileFloats``)
MAX_OBJECTIVES = 4096
#: point sets one batched launch takes (the grid's second dimension)
MAX_SETS = 65535

_count_lock = threading.Lock()
_launches = {"counts": 0, "sets": 0}


def launches() -> int:
    """:func:`mc_hv_counts` kernel launches since the last :func:`reset_launches`."""
    with _count_lock:
        return _launches["counts"]


def set_launches() -> int:
    """:func:`mc_hv_counts_sets` kernel launches since the last :func:`reset_launches`."""
    with _count_lock:
        return _launches["sets"]


def reset_launches() -> None:
    with _count_lock:
        for key in _launches:
            _launches[key] = 0


def _count_launch(key: str) -> None:
    with _count_lock:
        _launches[key] += 1


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
    n = points.shape[0]
    if n and samples.shape[0]:
        counts = _counts_op(points, samples)
    else:
        counts = torch.zeros(n + 1, dtype=torch.int32, device=points.device)
    out = counts.to(torch.float32)
    return out[:n], out[n]


@kernel_op("mc_hv_counts")
def _counts_op(points: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """The counting kernel's launch on CUDA tensors that :func:`mc_hv_counts`
    has checked: a new zeroed int32 buffer, ``excl`` in ``[0, n)`` and
    ``total`` at ``[n]``."""
    n, m = points.shape
    counts = torch.zeros(n + 1, dtype=torch.int32, device=points.device)
    from ._build import load

    lib = load()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.mc_hv_counts_launch(
            points.data_ptr(), n, samples.data_ptr(), samples.shape[0], m,
            counts.data_ptr(), counts[n:].data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"mc_hv_counts kernel launch failed: cudaError {err}")
    _count_launch("counts")
    return counts


@_counts_op.register_fake
def _(points, samples):
    return points.new_empty(points.shape[0] + 1, dtype=torch.int32)


@flop_formula("mc_hv_counts")
def mc_hv_counts_flops(points_shape, samples_shape, *, out_shape=None, **kwargs) -> int:
    """Every point against every sample in every objective: ``n s m``
    compares.  The kernel stops a sample's scan at its second dominator, so
    the count it needs on given data can be less (``chip_smoke.py`` counts
    that)."""
    return points_shape[0] * samples_shape[0] * points_shape[1]


def _check_boxes(lo: torch.Tensor, span: torch.Tensor, u: torch.Tensor) -> None:
    for name, t in (("lo", lo), ("span", span), ("u", u)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be 2-D and contiguous, got shape {tuple(t.shape)}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    m = u.shape[1]
    if lo.shape != span.shape or lo.shape[1] != m:
        raise ValueError(f"lo {tuple(lo.shape)} and span {tuple(span.shape)} must be [G, "
                         f"{m}] for u {tuple(u.shape)}")
    if not 1 <= m <= MAX_OBJECTIVES:
        raise ValueError(f"objective count must be in [1, {MAX_OBJECTIVES}], got {m}")
    if not 1 <= lo.shape[0] <= MAX_SETS:
        raise ValueError(f"set count must be in [1, {MAX_SETS}], got {lo.shape[0]}")
    if u.shape[0] < 1:
        raise ValueError("u holds no samples")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the counting kernels run on CPU or CUDA tensors, got {u.device}")


def mc_hv_counts_sets(
    points: torch.Tensor,  # [N, m] float32, set g's rows offsets[g] .. offsets[g + 1]
    offsets: torch.Tensor,  # [G + 1] int32, 0 .. N, non-decreasing
    lo: torch.Tensor,  # [G, m] float64
    span: torch.Tensor,  # [G, m] float64
    u: torch.Tensor,  # [s, m] float64 in [0, 1)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(excl [N] float32, total [G] float32)`` on the inputs' device: set
    ``g``'s counts (as :func:`mc_hv_counts`' for its rows) against its
    samples ``float32(lo[g] + span[g] * u)``, each operation in float64
    rounded once.  One launch for all sets.  The caller guarantees that
    ``offsets`` runs from 0 to N without decreasing."""
    _check_boxes(lo, span, u)
    if points.dim() != 2 or points.shape[1] != u.shape[1]:
        raise ValueError(f"points must be [N, {u.shape[1]}], got {tuple(points.shape)}")
    _check(points, points)
    if points.device != u.device or offsets.device != u.device:
        raise ValueError(f"points on {points.device}, offsets on {offsets.device}, u on {u.device}")
    G = lo.shape[0]
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (G + 1,):
        raise ValueError(f"offsets must be int32 [{G + 1}], got {offsets.dtype} "
                         f"{tuple(offsets.shape)}")
    if u.device.type == "cpu":
        return mc_hv_counts_sets_ref(points, offsets, lo, span, u)
    N = points.shape[0]
    if N:
        counts = _sets_op(points, offsets, lo, span, u)
    else:
        counts = torch.zeros(N + G, dtype=torch.int32, device=u.device)
    out = counts.to(torch.float32)
    return out[:N], out[N:]


@kernel_op("mc_hv_counts_sets")
def _sets_op(points: torch.Tensor, offsets: torch.Tensor, lo: torch.Tensor, span: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """The batched kernel's launch on CUDA tensors that
    :func:`mc_hv_counts_sets` has checked: a new zeroed int32 buffer,
    ``excl`` in ``[0, N)`` and the sets' ``total`` in ``[N, N + G)``."""
    N, m = points.shape
    G = lo.shape[0]
    counts = torch.zeros(N + G, dtype=torch.int32, device=u.device)
    from ._build import load

    lib = load()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.mc_hv_counts_sets_launch(
            points.data_ptr(), offsets.data_ptr(), lo.data_ptr(), span.data_ptr(),
            u.data_ptr(), G, u.shape[0], m, counts.data_ptr(), counts[N:].data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"mc_hv_counts_sets kernel launch failed: cudaError {err}")
    _count_launch("sets")
    return counts


@_sets_op.register_fake
def _(points, offsets, lo, span, u):
    return points.new_empty(points.shape[0] + lo.shape[0], dtype=torch.int32)


@flop_formula("mc_hv_counts_sets")
def mc_hv_counts_sets_flops(points_shape, offsets_shape, lo_shape, span_shape, u_shape,
                            *, out_shape=None, **kwargs) -> int:
    """Each set's points against its ``s`` samples in every objective, ``N s
    m`` compares, plus the samples' float64 multiply and add, ``2 G s m``
    (the compares a sample needs before its second dominator can be fewer,
    as for :func:`mc_hv_counts_flops`)."""
    N, m = points_shape
    s = u_shape[0]
    return N * s * m + 2 * lo_shape[0] * s * m


def mc_hv_samples(lo: torch.Tensor, span: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``[G, s, m]`` float32: the samples :func:`mc_hv_counts_sets` makes for
    each set, as its kernel makes them on a CUDA device (a check of the
    sample rule; not counted) and as its plain version makes them on the
    CPU."""
    _check_boxes(lo, span, u)
    if u.device.type == "cpu":
        return mc_hv_samples_ref(lo, span, u)
    G, m = lo.shape
    s = u.shape[0]
    out = torch.empty((G, s, m), dtype=torch.float32, device=u.device)
    from ._build import load

    lib = load()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.mc_hv_samples_launch(lo.data_ptr(), span.data_ptr(), u.data_ptr(), G, s, m,
                                       out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mc_hv_samples kernel launch failed: cudaError {err}")
    return out
