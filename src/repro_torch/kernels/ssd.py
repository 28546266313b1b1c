"""Mamba2's chunked SSD scan (state-space duality): per (batch, head), the
intra-chunk ``L x L`` contraction and the inter-chunk ``[P, N]`` state carry.

Wrapper around the hand-written CUDA kernels in ``csrc/ssd.cu``, which
replace the reference package's Pallas kernel
(``repro/kernels/ssd.py::ssd_kernel``): one block per (batch, head) loops
over the chunks in order with the state in shared memory.  The inputs' dtype
picks the kernel (a fixed rule, no fallback): bfloat16 ``x``, ``B``, ``C``
(the models' compute type) run on the tensor cores, with every float32
operand of a product split into two bfloat16 terms; float32 inputs run on
the CUDA cores.  The source states both designs and their bounds on the
card.

The kernel computes what the reference's model computes
(``repro/models/mamba2.py::ssd_chunked``), which is more than the TPU kernel
takes:

* B and C come per group (``[B, S, G, N]``); head ``h`` reads group ``h //
  (H // G)`` and no repeated copy is made;
* an optional float32 initial state ``[B, H, P, N]`` (prefill continues the
  cache's state);
* any ``S``: chunks of ``L = min(chunk, S)`` steps with a ragged last chunk.
  The reference halves ``L`` until it divides ``S`` (an odd prompt length
  gives ``L = 1``); the function is the same up to float32 rounding, and the
  plain version (``kernels/ref.py::ssd_chunked_ref``) keeps the halving rule;
* the model's layouts, read through their strides: ``x`` ``[B, S, H, P]``,
  ``dt`` ``[B, S, H]``, B / C ``[B, S, G, N]`` (slices of the conv output),
  so no transposed copy is made.  The bfloat16 kernel copies rows of 16
  bytes: ``x``, ``B`` and ``C`` need 16-byte aligned storage and strides
  that are multiples of 8 elements, and ``P``, ``N`` of at most 64, else the
  call raises (the model's slices, of row stride ``H P + 2 G N``, meet it).

:class:`SSDFunction` makes it differentiable for training.  Its forward is
the kernel; the reference's Pallas kernel has no backward and the reference
trains by autodiff through plain ``jnp``, so the backward
(:func:`ssd_backward`) is that gradient written out in torch ops, chunk by
chunk with batched products and a reverse loop over the chunks for the
state's gradient.

CPU tensors take the plain PyTorch version; CUDA tensors launch the kernel
or raise.  The launch is the custom op ``torch.ops.repro_torch.ssd``
(``kernels/ops.py``), with a fake implementation and a FLOP formula (the
causal pairs of each chunk plus the state carry).  Every launch adds one to a thread-safe counter
(:func:`launches`), so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .ops import flop_formula, full_float32_matmul, kernel_op
from .ref import ssd_chunked_ref

__all__ = ["ssd_forward", "ssd_backward", "SSDFunction", "kernel_chunk_len", "ssd_flops",
           "launches", "reset_launches"]

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


def kernel_chunk_len(S: int, chunk: int) -> int:
    """The chunk length the kernel (and :func:`ssd_backward`) uses for
    ``S`` steps: ``min(chunk, S)``, the last chunk ragged."""
    return min(chunk, S)


def _check(xh, dt, A, Bm, Cm, chunk, initial_state) -> None:
    named = (("xh", xh), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))
    if initial_state is not None:
        named += (("initial_state", initial_state),)
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
    if xh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SSD scan runs on CPU or CUDA tensors, got {xh.device}")
    if xh.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError(f"xh must be [B, S, H, P], dt [B, S, H], A [H], Bm / Cm [B, S, G, N]; "
                         f"got {tuple(xh.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not fit xh {tuple(xh.shape)}")
    if Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (b, S):
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} do not fit xh "
                         f"{tuple(xh.shape)}")
    if G == 0 or H % G != 0:
        raise ValueError(f"{H} heads are not a multiple of {G} groups")
    if min(b, S, H, P, N) == 0:
        raise ValueError(f"empty input: xh {tuple(xh.shape)}, Bm {tuple(Bm.shape)}")
    if initial_state is not None:
        if tuple(initial_state.shape) != (b, H, P, N):
            raise ValueError(f"initial_state must be {(b, H, P, N)}, got "
                             f"{tuple(initial_state.shape)}")
        if initial_state.dtype != torch.float32:
            raise TypeError(f"initial_state must be float32, got {initial_state.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype} and {A.dtype}")
    for name, t in (("xh", xh), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


@kernel_op("ssd")
def _ssd_op(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, chunk: int,
            initial_state: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch on CUDA tensors that :func:`ssd_forward` has
    checked: new ``(y, final)`` tensors in float32."""
    b, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = kernel_chunk_len(S, chunk)
    if xh.dtype != Bm.dtype or Cm.dtype != Bm.dtype:
        raise TypeError(f"the SSD kernel reads xh, Bm and Cm in one dtype; got {xh.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}")
    for name, t in (("xh", xh), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous (stride 1)")
        strides = [st for st, n in zip(t.stride()[:3], t.shape) if n > 1]
        if xh.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(st % 8 for st in strides)):
            raise ValueError(f"the bfloat16 SSD kernel copies 16-byte rows: {name}'s storage must "
                             f"be 16-byte aligned and its batch, step and head / group strides "
                             f"multiples of 8; got strides {t.stride()}")
    A = A.contiguous()
    init = initial_state.contiguous() if initial_state is not None else None
    from ._build import load

    lib = load()
    if lib.ssd_smem_bytes(L, P, N, _DTYPE_CODES[xh.dtype]) < 0:
        widest = 64 if xh.dtype == torch.bfloat16 else 128
        raise ValueError(f"the {xh.dtype} SSD kernel takes chunks of at most 128 steps and P, N "
                         f"of at most {widest} whose tiles fit a block's shared memory; got "
                         f"L={L}, P={P}, N={N}")
    y = torch.empty((b, S, H, P), dtype=torch.float32, device=xh.device)
    final = torch.empty((b, H, P, N), dtype=torch.float32, device=xh.device)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.ssd_launch(
            xh.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), _DTYPE_CODES[xh.dtype],
            dt.data_ptr(), A.data_ptr(), init.data_ptr() if init is not None else None,
            y.data_ptr(), final.data_ptr(), b, S, H, G, P, N, L,
            xh.stride(0), xh.stride(1), xh.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2), stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError {err}")
    _count_launch()
    return y, final


@_ssd_op.register_fake
def _(xh, dt, A, Bm, Cm, chunk, initial_state):
    b, S, H, P = xh.shape
    N = Bm.shape[3]
    return (xh.new_empty((b, S, H, P), dtype=torch.float32),
            xh.new_empty((b, H, P, N), dtype=torch.float32))


@flop_formula("ssd")
def ssd_flops(xh_shape, dt_shape, A_shape, Bm_shape, Cm_shape, chunk, initial_state_shape=None,
              *, out_shape=None, **kwargs) -> int:
    """Per batch and head, each chunk of ``l`` steps (the kernel's chunks):
    its ``l (l + 1) / 2`` causal pairs take ``2 N`` FLOPs for ``C_t . B_s``
    and ``2 P`` for ``M u``; the state's read into ``y`` and its update take
    ``4 l P N``."""
    b, S, H, P = xh_shape
    N = Bm_shape[3]
    L = kernel_chunk_len(S, chunk)
    lens = [L] * (S // L) + ([S % L] if S % L else [])
    return b * H * sum(n * (n + 1) // 2 * (2 * N + 2 * P) + 4 * n * P * N for n in lens)


def ssd_forward(
    xh: torch.Tensor,  # [B, S, H, P] float32 / bfloat16, last dim contiguous
    dt: torch.Tensor,  # [B, S, H] float32 (post-softplus), any strides
    A: torch.Tensor,  # [H] float32 (negative)
    Bm: torch.Tensor,  # [B, S, G, N], xh's dtype, last dim contiguous
    Cm: torch.Tensor,  # [B, S, G, N]
    chunk: int = 128,
    initial_state: "torch.Tensor | None" = None,  # [B, H, P, N] float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, S, H, P], final state [B, H, P, N])`` in float32, no
    gradient: the kernel on CUDA tensors (chunks of ``min(chunk, S)`` steps,
    the last ragged), the plain version on CPU ones (the reference's
    halving chunk rule)."""
    _check(xh, dt, A, Bm, Cm, chunk, initial_state)
    if xh.device.type == "cpu":
        with torch.no_grad():
            return ssd_chunked_ref(xh, dt, A, Bm, Cm, chunk, initial_state)
    return _ssd_op(xh, dt, A, Bm, Cm, int(chunk), initial_state)


def _heads(t: torch.Tensor, n: int, L: int) -> torch.Tensor:
    """``[b, n * L, K, F...]`` -> ``[b, K, n, L, F...]`` (a copy)."""
    b, _, K = t.shape[:3]
    rest = t.shape[3:]
    return t.reshape(b, n, L, K, *rest).movedim(3, 1).contiguous()


def _unheads(t: torch.Tensor, S: int) -> torch.Tensor:
    """Inverse of :func:`_heads`, cut to the first ``S`` steps."""
    b, K, n, L = t.shape[:4]
    return t.movedim(1, 3).reshape(b, n * L, K, *t.shape[4:])[:, :S]


@full_float32_matmul()
def ssd_backward(xh, dt, A, Bm, Cm, dy, dfinal=None, chunk: int = 128, initial_state=None):
    """``(dx, ddt, dA, dB, dC, d initial_state)`` of ``sum(dy * y) +
    sum(dfinal * final)``: the gradient XLA derives for the reference's plain
    ``ssd_chunked``, written out in float32 over chunks of
    :func:`kernel_chunk_len` steps (a ragged last chunk is padded with
    ``dt = 0`` steps, which leave the state as it is and add nothing).

    Per chunk, with ``cum`` the inclusive cumsum of ``a = dt A``, ``u = x
    dt``, ``W[t, s] = exp(cum_t - cum_s)`` for ``s <= t`` and ``M = (C B^T)
    o W``: the forward's pieces and the entering states ``h_in`` are
    recomputed; then ``dM = dY U^T``, ``dU = M^T dY``, ``dC = (dM o W) B``,
    ``dB = (dM o W)^T C`` (summed over the heads of a group), and ``d cum``
    gains the row sums less the column sums of ``dM o M``.  The entering
    state's term gives ``dC += e (dY h_in)``, ``d cum += dY . y_off`` and
    ``R = (e dY)^T C``; a reverse loop over the chunks carries ``dh_in =
    exp(total) dh_out + R``, and each chunk's ``dh_out`` gives ``dU += w (B
    dh_out^T)``, ``dB += w (U dh_out)`` and the decays' terms of ``d cum``.
    Then ``da`` is the reverse cumsum of ``d cum``, ``ddt = da A + dU . x``,
    ``dA = sum(da dt)`` and ``dx = dU dt``.  Gradients come back in their
    inputs' dtypes; the float32 products run with TF32 off, the caller's
    setting put back after."""
    b, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = kernel_chunk_len(S, chunk)
    n = -(-S // L)
    pad = n * L - S
    f32 = torch.float32

    def padded(t):
        t = t.to(f32)
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad, *t.shape[2:]))], dim=1)
        return t

    x = _heads(padded(xh), n, L)  # [b,H,n,L,P]
    d = _heads(padded(dt), n, L)  # [b,H,n,L]
    Bg = _heads(padded(Bm), n, L)  # [b,G,n,L,N]
    Cg = _heads(padded(Cm), n, L)
    dY = _heads(padded(dy), n, L)  # [b,H,n,L,P]
    A32 = A.to(f32)

    def by_group(t):  # [b,H,...] -> [b,G,rep,...]
        return t.reshape(b, G, rep, *t.shape[2:])

    def per_head(t):  # [b,G,...] -> [b,G,1,...], broadcasting over a group's heads
        return t.unsqueeze(2)

    u = x * d[..., None]
    cum = torch.cumsum(d * A32[None, :, None, None], dim=-1)  # [b,H,n,L]
    total = cum[..., -1]  # [b,H,n]
    causal = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    W = (cum[..., :, None] - cum[..., None, :]).masked_fill_(~causal, float("-inf")).exp_()
    cb = Cg @ Bg.transpose(-1, -2)  # [b,G,n,L,L]
    M = (by_group(W) * per_head(cb)).reshape(b, H, n, L, L)
    e = torch.exp(cum)  # [b,H,n,L]
    w = torch.exp(total[..., None] - cum)  # [b,H,n,L]
    # chunk states and the entering states h_in (the forward's scan)
    st = (by_group(u * w[..., None]).transpose(-1, -2) @ per_head(Bg)).reshape(b, H, n, P, N)
    decay = torch.exp(total)  # [b,H,n]
    carry = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((b, H, P, N), dtype=f32, device=xh.device))
    h_in = torch.empty((b, H, n, P, N), dtype=f32, device=xh.device)
    for c in range(n):
        h_in[:, :, c] = carry
        carry = carry * decay[:, :, c, None, None] + st[:, :, c]
    del st

    # intra-chunk term
    dM = dY @ u.transpose(-1, -2)  # [b,H,n,L,L]
    dU = M.transpose(-1, -2) @ dY
    Q = dM * M
    dcum = Q.sum(-1) - Q.sum(-2)
    del Q, M
    dGg = by_group(dM.mul_(W)).sum(2)  # [b,G,n,L,L]
    del dM, W
    dC = dGg @ Bg
    dB = dGg.transpose(-1, -2) @ Cg
    del dGg
    # the entering state's term y_off = e (C h_in^T)
    Ch = per_head(Cg)
    ch = (Ch @ by_group(h_in).transpose(-1, -2)).reshape(b, H, n, L, P)  # C h_in^T
    dcum += e * (dY * ch).sum(-1)
    del ch
    dYe = dY * e[..., None]
    dC += (by_group(dYe) @ by_group(h_in)).sum(2)
    R = (by_group(dYe).transpose(-1, -2) @ Ch).reshape(b, H, n, P, N)
    del dYe
    # reverse loop over the chunks: dh_out of each chunk, d initial_state
    dh_out = torch.empty_like(h_in)
    dh = (dfinal.to(f32) if dfinal is not None
          else torch.zeros((b, H, P, N), dtype=f32, device=xh.device))
    for c in range(n - 1, -1, -1):
        dh_out[:, :, c] = dh
        dh = dh * decay[:, :, c, None, None] + R[:, :, c]
    del R
    # the state's terms: h_out = exp(total) h_in + sum_s w_s u_s B_s^T
    dcum[..., -1] += decay * (dh_out * h_in).sum((-1, -2))
    del h_in
    Bh = per_head(Bg)
    dU += w[..., None] * (Bh @ by_group(dh_out).transpose(-1, -2)).reshape(b, H, n, L, P)
    u_dh = (by_group(u) @ by_group(dh_out)).reshape(b, H, n, L, N)  # U dh_out
    del dh_out
    dB += (by_group(u_dh * w[..., None])).sum(2)
    dw = (by_group(u_dh) * Bh).sum(-1).reshape(b, H, n, L) * w
    del u_dh
    dcum -= dw
    dcum[..., -1] += dw.sum(-1)
    da = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = da * A32[None, :, None, None] + (dU * x).sum(-1)
    dA = (da * d).sum((0, 2, 3))
    dx = dU * d[..., None]
    return (_unheads(dx, S).to(xh.dtype), _unheads(ddt, S).to(dt.dtype), dA.to(A.dtype),
            _unheads(dB, S).to(Bm.dtype), _unheads(dC, S).to(Cm.dtype),
            dh if initial_state is not None else None)


class SSDFunction(torch.autograd.Function):
    """The chunked SSD scan, differentiable in all its inputs.

    ``apply(xh, dt, A, Bm, Cm, chunk, initial_state)`` -> ``(y, final)``: the
    forward is :func:`ssd_forward` (the kernel, or its plain version on CPU
    tensors) and saves the inputs (views: no copy); the backward is
    :func:`ssd_backward`."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, chunk, initial_state):
        y, final = ssd_forward(xh, dt, A, Bm, Cm, chunk, initial_state)
        ctx.save_for_backward(xh, dt, A, Bm, Cm, initial_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        xh, dt, A, Bm, Cm, initial_state = ctx.saved_tensors
        dx, ddt, dA, dB, dC, dinit = ssd_backward(xh, dt, A, Bm, Cm, dy, dfinal, ctx.chunk,
                                                  initial_state)
        return dx, ddt, dA, dB, dC, None, dinit
