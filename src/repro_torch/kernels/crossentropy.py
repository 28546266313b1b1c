"""Fused cross-entropy: per-token ``logsumexp(x W) - (x W)[label]`` without
writing the ``[T, V]`` logits to device memory.

Wrapper around the hand-written CUDA kernels in ``csrc/crossentropy.cu``,
which replace the reference package's Pallas kernel
(``repro/kernels/crossentropy.py::crossentropy_kernel``): blocks of 128 token
rows loop over the vocabulary tiles with an online logsumexp, the product
computed inside the kernel; the source states the designs and their bound
on the card.

``x``'s dtype picks the kernel, a fixed rule and not a fallback:

* **bfloat16** ``x`` (the model's compute type in training and tuning)
  always launches the tensor-core kernel (``mma.sync`` on bf16 tiles staged
  by ``cp.async``, float32 accumulators).  Its ``W`` operand is bfloat16 and
  K-major: the wrapper casts ``W`` once a call, the reference's own
  ``w_out.astype(x.dtype)`` (:func:`tensor_core_weight`: the tied head's
  transposed view keeps its strides, an untied ``[D, V]`` head is
  transposed as it is cast; 125 MiB at tinyllama-1.1b's head, 1.75 GiB at
  gemma2-9b's).  ``x``'s rows must be 16-byte aligned (row stride a multiple
  of 8 elements), else the call raises;
* **float32** ``x`` launches the CUDA-core kernel, which reads a float32 or
  bfloat16 ``W`` in place through its strides, float32 products throughout,
  which the float32 parity checks rely on.

:func:`fused_crossentropy` is differentiable in ``x`` and ``W``
(:class:`CrossEntropyFunction`).  Its forward is the kernel; the reference's
Pallas kernel has no backward and the reference trains by autodiff through
plain ``jnp``, so the backward here is that gradient written out in torch
ops (:func:`crossentropy_backward`), over chunks of rows, with the large
products through ``torch.matmul``.

CPU tensors take the plain PyTorch version (``kernels/ref.py``); CUDA
tensors launch ``x``'s dtype's kernel or raise.  The launch is the custom op
``torch.ops.repro_torch.crossentropy`` (``kernels/ops.py``), with a fake
implementation and a FLOP formula (2 T D V).  Every launch adds one to a
thread-safe counter (:func:`launches`), so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import threading

import torch

from .ops import flop_formula, full_float32_matmul, kernel_op
from .ref import crossentropy_lse_ref

__all__ = [
    "fused_crossentropy",
    "crossentropy_forward",
    "crossentropy_backward",
    "tensor_core_weight",
    "CrossEntropyFunction",
    "crossentropy_flops",
    "launches",
    "reset_launches",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_DTYPES = (torch.int32, torch.int64)
#: float32 logits per row chunk of the backward (512 MiB)
_BWD_LOGIT_ELEMS = 1 << 27

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


def _check(x, w, labels) -> None:
    for name, t in (("x", x), ("w", w), ("labels", labels)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"x must be [T, D], w [D, V] and labels [T]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(labels.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if labels.dtype not in _LABEL_DTYPES:
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    T, D = x.shape
    if w.shape[0] != D or labels.shape[0] != T:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and labels "
                         f"{tuple(labels.shape)} do not fit")
    if T == 0 or D == 0 or w.shape[1] == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_crossentropy runs on CPU or CUDA tensors, got {x.device}")


def tensor_core_weight(w: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(wb, ld)``: ``w`` [D, V] as the tensor-core kernel reads it,
    bfloat16 and K-major (element ``(d, v)`` at ``v * ld + d``).

    The values are ``w.to(torch.bfloat16)``, the reference's
    ``w_out.astype(x.dtype)``.  The tied head, a transposed view of a
    ``[V, D]`` embedding, is already K-major: a cast keeps its strides, and a
    bfloat16 embedding is read in place.  An untied ``[D, V]`` head is
    transposed as it is cast, into ``[V, D]`` rows (the kernel has one
    operand layout; its N-major reads ran slower on the H100).  Rows that
    would not be 16 bytes apart (``ld`` not a multiple of 8) or unaligned
    storage are copied into rows padded to a multiple of 8 elements."""
    D, V = w.shape
    wb = w.to(torch.bfloat16)
    if (wb.stride(0) == 1 and wb.stride(1) % 8 == 0 and wb.stride(1) >= D
            and wb.data_ptr() % 16 == 0):
        return wb, wb.stride(1)
    buf = torch.empty(V, -(-D // 8) * 8, dtype=torch.bfloat16, device=w.device)
    buf[:, :D] = wb.T
    return buf[:, :D].T, buf.stride(0)


def crossentropy_forward(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                         softcap: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(nll [T], lse [T])`` in float32, no gradient: ``x``'s dtype's kernel
    on CUDA tensors, the plain version on CPU ones."""
    _check(x, w, labels)
    if x.device.type == "cpu":
        return crossentropy_lse_ref(x, w, labels, softcap)
    return _ce_op(x, w, labels, float(softcap))


@kernel_op("crossentropy")
def _ce_op(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
           softcap: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch on CUDA tensors that :func:`crossentropy_forward`
    has checked (the bfloat16 kernel's copy of ``W`` included): new ``(nll,
    lse)`` tensors."""
    T, D = x.shape
    V = w.shape[1]
    w_sd, w_sv = w.stride()
    if x.dtype == torch.bfloat16:
        if x.stride(1) != 1 or (T > 1 and x.stride(0) % 8) or x.data_ptr() % 16:
            raise ValueError(f"x's rows must be contiguous, 16-byte aligned and a multiple of "
                             f"8 elements apart for the bfloat16 kernel, got strides {x.stride()}")
        w, ld = tensor_core_weight(w)
        w_sd, w_sv = 1, ld
    from ._build import load

    lib = load()
    nsplit = lib.crossentropy_splits(T, V, _DTYPE_CODES[x.dtype])
    part = torch.empty(3 * nsplit * T, dtype=torch.float32, device=x.device)
    nll = torch.empty(T, dtype=torch.float32, device=x.device)
    lse = torch.empty(T, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.crossentropy_launch(
            x.data_ptr(), _DTYPE_CODES[x.dtype], x.stride(0), x.stride(1),
            w.data_ptr(), _DTYPE_CODES[w.dtype], w_sd, w_sv,
            labels.data_ptr(), int(labels.dtype == torch.int64), T, D, V, softcap,
            part.data_ptr(), nll.data_ptr(), lse.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"crossentropy kernel launch failed: cudaError {err}")
    _count_launch()
    return nll, lse


@_ce_op.register_fake
def _(x, w, labels, softcap):
    T = x.shape[0]
    return x.new_empty(T, dtype=torch.float32), x.new_empty(T, dtype=torch.float32)


@flop_formula("crossentropy")
def crossentropy_flops(x_shape, w_shape, labels_shape, softcap, *, out_shape=None,
                       **kwargs) -> int:
    """The logits' product, computed inside the kernel: 2 T D V FLOPs."""
    T, D = x_shape
    return 2 * T * D * w_shape[1]


@full_float32_matmul()
def crossentropy_backward(x, w, labels, lse, grad_nll, softcap: float = 0.0):
    """``(dx, dW)`` of ``sum(grad_nll * nll)``: the gradient XLA derives for
    the reference's plain ``cross_entropy_chunked``, written out over chunks
    of rows.  Per chunk: ``z = x_c W`` recomputed in float32 (``W`` rounded to
    ``x``'s dtype, as in the forward), ``p = exp(softcap(z) - lse)``, ``dz =
    g (p - onehot(label))`` times ``1 - tanh(z / cap)^2`` when softcapped,
    ``dx_c = dz W^T`` in ``x``'s dtype and ``dW += x_c^T dz`` in float32,
    returned in ``W``'s dtype.  The float32 products run with TF32 off, the
    caller's setting put back after."""
    T = x.shape[0]
    V = w.shape[1]
    w_x = w.to(x.dtype)  # no copy when the dtypes agree
    w32 = w_x.to(torch.float32)
    dx = torch.empty_like(x)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    g = grad_nll.to(torch.float32)
    lab = labels.long()
    chunk = max(1, _BWD_LOGIT_ELEMS // V)
    for start in range(0, T, chunk):
        stop = min(T, start + chunk)
        xc = x[start:stop]
        z = xc.to(torch.float32) @ w32  # [n, V]
        if softcap:
            t = torch.tanh(z / softcap)
            p = torch.mul(t, softcap, out=z)
        else:
            t, p = None, z
        p.sub_(lse[start:stop, None]).exp_()
        lc = lab[start:stop]
        valid = ((lc >= 0) & (lc < V)).to(torch.float32)
        p.scatter_add_(1, lc.clamp(0, V - 1)[:, None], -valid[:, None])
        dz = p.mul_(g[start:stop, None])
        if t is not None:
            dz.mul_(t.mul_(t).neg_().add_(1.0))
        dx[start:stop] = dz.to(x.dtype) @ w_x.T
        dw.addmm_(xc.to(torch.float32).T, dz)
    return dx, dw.to(w.dtype)


class CrossEntropyFunction(torch.autograd.Function):
    """Per-token NLL, differentiable in ``x`` and ``W``: the forward is the
    kernel (or its plain version on the CPU) and saves ``x``, ``W``, the
    labels and the per-row ``lse``; the backward is
    :func:`crossentropy_backward`."""

    @staticmethod
    def forward(ctx, x, w, labels, softcap):
        nll, lse = crossentropy_forward(x, w, labels, softcap)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.softcap = softcap
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        x, w, labels, lse = ctx.saved_tensors
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return None, None, None, None
        dx, dw = crossentropy_backward(x, w, labels, lse, grad_nll, ctx.softcap)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None, None)


def fused_crossentropy(
    x: torch.Tensor,  # [T, D], any strides
    w: torch.Tensor,  # [D, V], any strides (the tied head is a transposed view)
    labels: torch.Tensor,  # [T] int32 / int64
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Per-token negative log-likelihood [T] (float32), differentiable in
    ``x`` and ``w``.

    ``x`` and ``w`` are float32 or bfloat16 on one device; ``w`` is rounded
    to ``x``'s dtype, and the logits ``x . w`` are float32, then
    ``softcap * tanh(z / softcap)`` when ``softcap`` is nonzero.  A label
    outside ``[0, V)`` contributes no label logit."""
    _check(x, w, labels)
    return CrossEntropyFunction.apply(x, w, labels, float(softcap))
