"""Flash attention forward: online-softmax attention with GQA, a causal mask,
a sliding window and a logit softcap.

Wrapper around the hand-written CUDA kernels in ``csrc/flash_attention.cu``,
which replace the reference package's Pallas kernel
(``repro/kernels/flash_attention.py::flash_attention_kernel``).  One block of
a kernel owns one (batch, head, query block) and loops over the key/value
tiles itself with the running ``(m, l, acc)`` in registers, so the
``[Sq, Skv]`` score matrix never exists; the source states the designs and
their bound on the card.

The inputs' dtype picks the kernel, a fixed rule and not a fallback:

* **bfloat16** (the model's compute type in training, serving and tuning)
  always launches the tensor-core kernel: bf16 tiles staged by ``cp.async``,
  ``mma.sync`` products accumulated in float32, the probabilities split into
  two bf16 terms for ``P V`` so that they keep float32-grade precision, as
  the plain version's.
  Its copies need 16-byte aligned rows: every (batch, position, head) stride
  a multiple of 8 elements and 16-byte aligned storage, else the call raises
  (the model's ``[B, S, H, D]`` projections and caches meet it);
* **float32** launches the CUDA-core kernel, float32 products throughout,
  which the float32 parity checks rely on.

:class:`FlashAttentionFunction` makes it differentiable for training.  Its
forward is the kernel; the reference's Pallas kernel has no backward and the
reference trains by autodiff through plain ``jnp``, so the backward
(:func:`flash_attention_backward`) is that gradient written out in torch
ops over query chunks.

Beside the TPU kernel's ``causal`` / ``window`` / ``softcap`` it takes
``q_offset`` (a query row ``r`` sits at absolute position ``q_offset + r``)
and ``kv_len`` (keys at ``>= kv_len`` are masked), which the model's prefill
against a KV cache needs.  The tensors are logically the TPU kernel's
``[B, H, S, D]`` with any strides: the kernel reads them through their
element strides, so the model passes its ``[B, S, H, D]`` tensors as
transposed views and no copy is made.

CPU tensors take the plain PyTorch version (``kernels/ref.py``); CUDA
tensors launch their dtype's kernel or raise.  The launch is the custom op
``torch.ops.repro_torch.flash_attention`` (``kernels/ops.py``): its fake
implementation gives the output's shape, dtype and strides, and its FLOP
formula counts 4 D FLOPs per (query, key) pair the causal / window band and
``kv_len`` leave (:func:`attention_pairs`).  Every launch adds one to a
thread-safe counter (:func:`launches`), so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from .ops import flop_formula, full_float32_matmul, kernel_op
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_backward", "FlashAttentionFunction", "launches",
           "reset_launches", "attention_pairs", "flash_attention_flops", "HEAD_DIMS"]

#: head widths the kernel is built for (one template instance each)
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

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


def _check(q, k, v, causal, window, q_offset, kv_len) -> int:
    """Validate the inputs; return ``kv_len`` resolved against ``Skv``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D [B, H, S, D], got shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous (stride 1)")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (one of {HEAD_DIMS})")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} kv heads")
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"kv_len must lie in [1, {Skv}], got {kv_len}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    # every query row must see a key: the kernel skips the tiles outside the
    # causal / window band, which is exact only then
    last = q_offset + Sq - 1
    if causal and last >= kv_len:
        raise ValueError(f"causal query at position {last} has no key below kv_len={kv_len}")
    if window > 0 and not causal and last - window + 1 >= kv_len:
        raise ValueError(f"query at position {last} has no key in its window below kv_len={kv_len}")
    return kv_len


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D], any strides
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = -1,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: "int | None" = None,
) -> torch.Tensor:
    """Attention output in ``q``'s dtype, shape and strides.

    ``q``, ``k`` and ``v`` share one device and one dtype (float32 or
    bfloat16), their head dimension is contiguous and one of
    :data:`HEAD_DIMS`; ``Hq`` is a multiple of ``Hkv`` (query head ``h``
    reads kv head ``h // (Hq // Hkv)``).  Scores are ``q . k / sqrt(D)``,
    then ``softcap * tanh(s / softcap)`` when ``softcap`` is nonzero; keys at
    ``>= kv_len`` (default ``Skv``), above the query's position when
    ``causal``, or ``window`` or more positions below it are masked at
    ``-1e30``.  Every query row must have a key it may attend to.  On the
    card bfloat16 inputs run on the tensor cores and need 16-byte aligned
    rows (module docstring); float32 inputs run on the CUDA cores."""
    kv_len = _check(q, k, v, causal, window, q_offset, kv_len)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                   q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got {q.device}")
    return _flash_op(q, k, v, bool(causal), int(window), float(softcap), int(q_offset), kv_len)


@kernel_op("flash_attention")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
              softcap: float, q_offset: int, kv_len: int) -> torch.Tensor:
    """The kernel's launch on CUDA tensors that :func:`flash_attention` has
    checked: a new tensor in ``q``'s dtype, shape and strides."""
    out = torch.empty_like(q)  # q's strides: [B, S, H, D] memory for a transposed view
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
            if t.data_ptr() % 16 or any(s % 8 for s in strides):
                raise ValueError(f"{name}'s storage must be 16-byte aligned and its batch, head "
                                 f"and position strides multiples of 8 for the bfloat16 kernel, "
                                 f"got strides {t.stride()}")
    # (batch, position, head) element strides of each tensor
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in (t.stride(0), t.stride(2), t.stride(1))
    ))
    from ._build import load

    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            B, Hq, Hkv, Sq, Skv, D, ctypes.addressof(strides), int(causal), window,
            softcap, q_offset, kv_len, 1.0 / math.sqrt(D), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    _count_launch()
    return out


@_flash_op.register_fake
def _(q, k, v, causal, window, softcap, q_offset, kv_len):
    return torch.empty_like(q)


def attention_pairs(Sq: int, Skv: int, causal: bool = True, window: int = -1,
                    q_offset: int = 0, kv_len: "int | None" = None) -> int:
    """(query, key) pairs the kernel computes per (batch, head): each query
    row's keys inside the causal / window band and below ``kv_len``."""
    kv_len = Skv if kv_len is None else kv_len
    qp = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(kv_len - 1, qp) if causal else np.full(Sq, kv_len - 1)
    lo = np.maximum(0, qp - window + 1) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


@flop_formula("flash_attention")
def flash_attention_flops(q_shape, k_shape, v_shape, causal, window, softcap, q_offset, kv_len,
                          *, out_shape=None, **kwargs) -> int:
    """``QK^T`` and ``PV``: 4 D FLOPs per computed (query, key) pair and head."""
    B, Hq, Sq, D = q_shape
    return 4 * D * B * Hq * attention_pairs(Sq, k_shape[2], causal, window, q_offset, kv_len)


@full_float32_matmul()
def flash_attention_backward(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,
    do: torch.Tensor,  # [B, Hq, Sq, D], the output's gradient
    *,
    causal: bool = True,
    window: int = -1,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: "int | None" = None,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention`, in the inputs' dtypes and
    strides: the gradient XLA derives for the reference's plain attention,
    written out in float32 over query chunks of ``chunk`` rows.  Per chunk
    the scores ``s``, the softcap, the masks at ``-1e30`` and ``p =
    softmax(s)`` are recomputed; then ``dp = dO V^T``, ``ds = p (dp -
    rowsum(p dp))`` (not ``rowsum(dO O)``: the kernel's ``O`` is rounded to
    the inputs' dtype, the recomputed ``p`` is not), the softcap's ``1 -
    tanh^2`` and the scale; ``dq = ds K``, and ``dk = ds^T Q``, ``dv = p^T dO``
    summed over the query heads that share a kv head.  The float32 products
    run with TF32 off, the caller's setting put back after."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_len = Skv if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    k_pos = torch.arange(Skv, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, Hkv, Skv, D), dtype=f32, device=q.device)
    masked = torch.full((), -1e30, device=q.device)
    for start in range(0, Sq, chunk):
        n = min(chunk, Sq - start)
        qb = q[:, :, start:start + n].to(f32).reshape(B, Hkv, G, n, D)
        dob = do[:, :, start:start + n].to(f32).reshape(B, Hkv, G, n, D)
        s = torch.einsum("bkgqd,bktd->bkgqt", qb, kf).mul_(scale)
        t = None
        if softcap:
            t = torch.tanh(s / softcap)
            s = t * softcap
        q_pos = q_offset + start + torch.arange(n, device=q.device)
        mask = (k_pos < kv_len)[None, :].expand(n, Skv)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        p = torch.softmax(torch.where(mask, s, masked), dim=-1)
        del s
        dp = torch.einsum("bkgqd,bktd->bkgqt", dob, vf)
        ds = dp.sub_((p * dp).sum(dim=-1, keepdim=True)).mul_(p)
        if t is not None:
            ds.mul_(t.mul_(t).neg_().add_(1.0))
        ds.mul_(scale)
        dq[:, :, start:start + n] = torch.einsum("bkgqt,bktd->bkgqd", ds, kf).reshape(
            B, Hq, n, D).to(q.dtype)
        dk += torch.einsum("bkgqt,bkgqd->bktd", ds, qb)
        dv += torch.einsum("bkgqt,bkgqd->bktd", p, dob)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention`, differentiable in ``q``, ``k`` and ``v``.

    ``apply(q, k, v, causal, window, softcap, q_offset, kv_len, chunk)``: the
    forward is the kernel (its plain version on CPU tensors) and saves the
    inputs (views: no copy); the backward is :func:`flash_attention_backward`
    over query chunks of ``chunk`` rows."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, kv_len, chunk):
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                              q_offset=q_offset, kv_len=kv_len)
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                      kv_len=kv_len, chunk=chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None
