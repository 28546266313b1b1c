"""The sLSTM time recurrence (xLSTM's scalar-memory block).

Wrapper around the hand-written CUDA kernels in ``csrc/slstm.cu``, which
replace the reference package's Pallas kernel
(``repro/kernels/slstm.py::slstm_kernel``): one cooperative launch runs the
whole time loop, R [4, H, D, D] split by output dims across the blocks of
the grid and resident in their registers, each block exchanging h with the
blocks of its own head through step-tagged words; S = 1 (a decode step)
runs the same step as a kernel of its own, a plain launch.  The launch plan
is kept per shape and card.  The source states the design and the bound on
the card.

The kernel computes what the reference's model computes
(``repro/models/ssm_xlstm.py::_slstm_scan``), which is more than the TPU
kernel takes:

* the model's ``[B, S, 4 d]`` pre-activations (gate ``g``, head ``h``, dim
  ``e`` at column ``g d + h D + e``), float32 or bfloat16, read through
  their strides, where the TPU kernel takes a transposed ``[S, B, 4, H, D]``
  copy;
* an initial state ``(c, n, h, m)`` ``[B, H, D]`` in float32 (prefill and
  decode continue the cache's state), where the TPU kernel zero-fills;
* any ``S >= 1`` (decode is ``S = 1``).

It returns ``h_seq [B, S, d]`` and the final state in float32.

:class:`SLSTMFunction` makes it differentiable for training.  Its forward is
the kernel, which then also writes the per-step ``c``, ``n`` and ``m``; the
reference trains by autodiff through ``lax.scan`` (each step checkpointed),
so the backward (:func:`slstm_backward`) is that gradient written out in
torch ops: the gates recomputed for all steps at once from the saved states,
a reverse loop over time for the state's gradient, and ``dR`` as one
product at the end.

CPU tensors take the plain PyTorch version (``kernels/ref.py::
slstm_scan_ref``); CUDA tensors launch the kernel or raise.  The launch is
the custom op ``torch.ops.repro_torch.slstm`` (``kernels/ops.py``), with a
fake implementation and a FLOP formula (2 S B 4 H D^2).  Every launch
adds one to a thread-safe counter (:func:`launches`), so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ._build import load
from .ops import flop_formula, full_float32_matmul, kernel_op
from .ref import slstm_scan_ref

__all__ = ["slstm_forward", "slstm_backward", "slstm_plan", "SLSTMFunction", "slstm_flops",
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


_NAMES = ("u", "R", "c0", "n0", "h0", "m0")


def _check(u, R, state) -> None:
    """Raises on what the kernel does not take.  Past the type checks, the
    checks read only each input's shape, dtype and device, so they run once
    per such signature (:func:`_validate`); a decode step, which calls this
    once a token, then pays a lookup."""
    c0, n0, h0, m0 = state
    T = torch.Tensor
    if not (isinstance(u, T) and isinstance(R, T) and isinstance(c0, T) and isinstance(n0, T)
            and isinstance(h0, T) and isinstance(m0, T)):
        for name, t in zip(_NAMES, (u, R, *state)):
            if not isinstance(t, T):
                raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    _validate(((u.shape, u.dtype, u.device), (R.shape, R.dtype, R.device),
               (c0.shape, c0.dtype, c0.device), (n0.shape, n0.dtype, n0.device),
               (h0.shape, h0.dtype, h0.device), (m0.shape, m0.dtype, m0.device)))


@functools.lru_cache(maxsize=256)
def _validate(sig: tuple) -> None:
    """Raises on the first check that fails for ``(shape, dtype, device)``
    of u, R, c0, n0, h0 and m0, naming it; a signature that passes is kept
    (an exception is not)."""
    (u_shape, u_dtype, dev), (R_shape, R_dtype, _), *state = sig
    for name, (_, _, d) in zip(_NAMES[1:], sig[1:]):
        if d != dev:
            raise ValueError(f"{name} is on {d}, u on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the sLSTM scan runs on CPU or CUDA tensors, got {dev}")
    if len(u_shape) != 3 or len(R_shape) != 4 or R_shape[0] != 4 or R_shape[2] != R_shape[3]:
        raise ValueError(f"u must be [B, S, 4 d] and R [4, H, D, D]; got {tuple(u_shape)}, "
                         f"{tuple(R_shape)}")
    B, S, d4 = u_shape
    H, D = R_shape[1], R_shape[2]
    if d4 != 4 * H * D:
        raise ValueError(f"u's last dimension {d4} is not 4 x {H} heads x {D} dims")
    if min(B, S, H, D) == 0:
        raise ValueError(f"empty input: u {tuple(u_shape)}, R {tuple(R_shape)}")
    for name, (shape, dtype, _) in zip(_NAMES[2:], state):
        if tuple(shape) != (B, H, D):
            raise ValueError(f"{name} must be {(B, H, D)}, got {tuple(shape)}")
        if dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {dtype}")
    if R_dtype != torch.float32:
        raise TypeError(f"R must be float32 (the reference reads it in float32), got {R_dtype}")
    if u_dtype not in _DTYPE_CODES:
        raise TypeError(f"u must be float32 or bfloat16, got {u_dtype}")


#: (B, H, D, dtype, device index) -> the launch plan on that card
_plans: dict = {}


def slstm_plan(B: int, H: int, D: int, dtype: torch.dtype) -> dict:
    """The kernel's launch plan on the current card: ``E`` output dims a
    block, ``blocks`` (``H D / E``, one an SM), ``smem_bytes`` a block, the
    card's ``sms`` and the ``parts`` of the k sum.  Kept per shape, dtype
    and card after the first call.  Raises ``ValueError`` where no plan
    keeps R's slices resident."""
    return _plan(B, H, D, dtype, torch.cuda.current_device())


def _plan(B: int, H: int, D: int, dtype: torch.dtype, index: int) -> dict:
    key = (B, H, D, dtype, index)
    plan = _plans.get(key)
    if plan is not None:
        return plan
    out = (ctypes.c_int * 5)()
    rc = load().slstm_plan(B, H, D, _DTYPE_CODES[dtype], out)
    if rc == -1:
        raise ValueError(
            f"the sLSTM kernel keeps R [4, {H}, {D}, {D}] resident in the registers of one "
            f"block an SM; no split of the {D} output dims of {H} heads fits this card "
            f"(B = {B} rows of state)")
    if rc != 0:
        raise RuntimeError(f"slstm_plan failed: cudaError {rc}")
    plan = _plans[key] = {"E": out[0], "blocks": out[1], "smem_bytes": out[2], "sms": out[3],
                          "parts": out[4]}
    return plan


def _launch(u, R, state, save_states: bool):
    """The kernel on CUDA tensors, on the current device: the decode kernel
    at S = 1, else the cooperative scan; ``(seqs [n, B, S, d], final [4, B,
    H, D])`` in float32, ``n`` 4 with ``save_states`` (``h``, ``c``, ``n``,
    ``m``) else 1.  Lean: a decode step calls it once a token and sLSTM
    block."""
    B, S, d4 = u.shape
    H, D = R.shape[1], R.shape[2]
    u_sb, u_ss, u_sd = u.stride()
    if u_sd != 1:
        raise ValueError("u's last dimension must be contiguous (stride 1)")
    dev = u.device
    E = _plan(B, H, D, u.dtype, dev.index)["E"]
    R = R.contiguous()
    c0, n0, h0, m0 = (t.contiguous() for t in state)
    f32 = torch.float32
    seqs = torch.empty((4 if save_states else 1, B, S, H * D), dtype=f32, device=dev)
    final = torch.empty((4, B, H, D), dtype=f32, device=dev)
    hx = torch.zeros((2, B, H, D), dtype=torch.int64, device=dev) if S > 1 else None
    c_ptr, n_ptr, m_ptr = ((seqs[i].data_ptr() for i in (1, 2, 3)) if save_states
                           else (None, None, None))
    err = load().slstm_launch(
        u.data_ptr(), _DTYPE_CODES[u.dtype], u_sb, u_ss, R.data_ptr(),
        c0.data_ptr(), n0.data_ptr(), h0.data_ptr(), m0.data_ptr(), seqs[0].data_ptr(),
        c_ptr, n_ptr, m_ptr, final[0].data_ptr(), final[1].data_ptr(), final[2].data_ptr(),
        final[3].data_ptr(), hx.data_ptr() if hx is not None else None, B, S, H, D, E,
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if err != 0:
        raise RuntimeError(f"slstm kernel launch failed: cudaError {err}")
    _count_launch()
    return seqs, final


@kernel_op("slstm")
def _slstm_op(u: torch.Tensor, R: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
              h0: torch.Tensor, m0: torch.Tensor,
              save_states: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch on CUDA tensors that :func:`slstm_forward` has
    checked: new ``(seqs, final)`` tensors (:func:`_launch`).  The initial
    state is read, never written: the model copies ``final`` into its
    cache."""
    state = (c0, n0, h0, m0)
    if torch.cuda.current_device() == u.device.index:
        return _launch(u, R, state, save_states)
    with torch.cuda.device(u.device):
        return _launch(u, R, state, save_states)


@_slstm_op.register_fake
def _(u, R, c0, n0, h0, m0, save_states):
    B, S, _ = u.shape
    H, D = R.shape[1], R.shape[2]
    return (u.new_empty((4 if save_states else 1, B, S, H * D), dtype=torch.float32),
            u.new_empty((4, B, H, D), dtype=torch.float32))


@flop_formula("slstm")
def slstm_flops(u_shape, R_shape, c0_shape, n0_shape, h0_shape, m0_shape, save_states,
                *, out_shape=None, **kwargs) -> int:
    """The recurrent products ``h @ R``: 2 S B 4 H D^2 FLOPs."""
    B, S, _ = u_shape
    _, H, D, _ = R_shape
    return 2 * S * B * 4 * H * D * D


def slstm_forward(
    u: torch.Tensor,  # [B, S, 4 d] float32 / bfloat16, last dim contiguous
    R: torch.Tensor,  # [4, H, D, D] float32
    c0: torch.Tensor,  # [B, H, D] float32
    n0: torch.Tensor,
    h0: torch.Tensor,
    m0: torch.Tensor,
    save_states: bool = False,
) -> tuple:
    """``(h_seq [B, S, d], (c, n, h, m) [B, H, D])`` in float32, no gradient
    (with ``save_states`` a third item, the per-step ``(c, n, m)`` as ``[B,
    S, d]``): the kernel on CUDA tensors, the plain version on CPU ones."""
    state = (c0, n0, h0, m0)
    _check(u, R, state)
    if u.device.type == "cpu":
        with torch.no_grad():
            return slstm_scan_ref(u, R, *state, states=save_states)
    seqs, final = _slstm_op(u, R, c0, n0, h0, m0, save_states)
    final = tuple(final.unbind(0))
    if save_states:
        return seqs[0], final, tuple(seqs[1:].unbind(0))
    return seqs[0], final


def _by_head(t: torch.Tensor, B: int, S: int, H: int, D: int) -> torch.Tensor:
    """``[B, S, H D]`` -> ``[S, H, B, D]`` float32 (a copy)."""
    return t.reshape(B, S, H, D).permute(1, 2, 0, 3).to(torch.float32).contiguous()


def _tie_weight(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The share of ``max(a, b)``'s gradient that goes to ``a``: 1 where ``a >
    b``, 0 where ``a < b`` and 1/2 at a tie (XLA's and torch's rule)."""
    return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


@full_float32_matmul()
def slstm_backward(u, R, c0, n0, h0, m0, h_seq, c_seq, n_seq, m_seq, dh_seq, dfinal=None):
    """``(du, dR, dc0, dn0, dh0, dm0)`` of ``sum(dh_seq * h_seq) + sum(dfinal
    * final)`` (``dfinal`` the final ``(c, n, h, m)``'s gradients, ``None``
    entries zero): the gradient XLA derives for the reference's
    ``_slstm_scan``, written out in float32.

    The saved ``h_seq`` and per-step ``c``, ``n``, ``m`` give every step's
    entering state, so the gates of all steps are recomputed at once (``rec
    = h_prev @ R`` as one product a head) with the step's coefficients: the
    recurrence of the gradients is linear in ``(dh, dc, dn, dm)``.  The
    reverse loop over time then carries them back one step with a few
    elementwise operations on stacked carries (a 3 x 3 map a step, each
    step's slices made before the loop: about ten launches a step) and
    ``dgates @ R^T`` a head; ``max`` splits its
    gradient evenly at a tie, as ``jnp.maximum``'s does.  ``dR = sum_t
    h_{t-1}^T dgates_t`` is one product at the end.  ``du`` comes back in
    ``u``'s dtype; the float32 products run with TF32 off, the caller's
    setting put back after."""
    B, S, d4 = u.shape
    H, D = R.shape[1], R.shape[2]
    f32 = torch.float32
    seq = lambda t: _by_head(t, B, S, H, D)  # noqa: E731
    first = lambda t: t.to(f32).transpose(0, 1)[None]  # noqa: E731  [B,H,D] -> [1,H,B,D]
    h_all = seq(h_seq)
    h_prev = torch.cat([first(h0), h_all[:-1]])  # [S,H,B,D]
    del h_all
    c_new, n_new, m_all = seq(c_seq), seq(n_seq), seq(m_seq)
    c_prev = torch.cat([first(c0), c_new[:-1]])
    n_prev = torch.cat([first(n0), n_new[:-1]])
    m_prev = torch.cat([first(m0), m_all[:-1]])
    del c_new, n_new, m_all
    R32 = R.to(f32)
    # the gates of every step: a[s, h, b, g, e] = u + (h_prev @ R)
    rec = torch.bmm(h_prev.transpose(0, 1).reshape(H, S * B, D),
                    R32.permute(1, 2, 0, 3).reshape(H, D, 4 * D))
    a = rec.reshape(H, S, B, 4, D).transpose(0, 1)
    a = a + u.reshape(B, S, 4, H, D).permute(1, 3, 0, 2, 4).to(f32)
    del rec
    z = torch.tanh(a[:, :, :, 0])
    i, f = a[:, :, :, 1], a[:, :, :, 2]
    o = torch.sigmoid(a[:, :, :, 3])
    s1 = f + m_prev
    del m_prev
    m_new = torch.maximum(s1, i)
    w1 = _tie_weight(s1, i)  # m' = max(f + m, i)
    w2 = 1.0 - w1
    ig = torch.exp(i - m_new)
    fg = torch.exp(s1 - m_new)
    del a, i, f, s1
    c_new = fg * c_prev + ig * z
    q = fg * n_prev + ig
    r = torch.exp(-m_new)
    n_new = torch.maximum(q, r)
    wq = _tie_weight(q, r)  # n' = max(q, exp(-m'))
    del q, m_new
    k1 = o / n_new  # dh' -> dc'
    k2 = -(o * c_new) / (n_new * n_new)  # dh' -> dn'
    k4 = (c_new / n_new) * (o * (1.0 - o))  # dh' -> da_o
    del o, c_new, n_new
    # A step carries (dc, dn, dm, dh) back linearly.  With e = dh_out + dh,
    # dc~ = dc + k1 e and dn~ = dn + k2 e, the gates' gradients are
    #   g_z = ig (1 - z^2) dc~,  g_i = di + w2 dm~,  g_f = dlogf + w1 dm~,  g_o = k4 e,
    # where di = ig (z dc~ + wq dn~), dlogf = fg (c dc~ + n wq dn~) and
    # dm~ = dm - wqr dn~ - di - dlogf (wqr = (1 - wq) exp(-m'): n' = max(q,
    # exp(-m'))); and dc' = fg dc~, dn' = fg wq dn~, dm' = g_f.  So g_z, g_i,
    # g_f are one [3, 3] map of (dc~, dn~, dm) a step (``G``), which the loop
    # applies as one product and one sum.
    a_c = ig * z + fg * c_prev  # dm~'s -coefficients of dc~ and dn~
    a_n = (1.0 - wq) * r + wq * (ig + fg * n_prev)
    # [S, H, B, g, t, D]: the gates' rows of the map, of (dc~, dn~, dm)
    G = torch.zeros((S, H, B, 3, 3, D), dtype=f32, device=u.device)
    G[:, :, :, 0, 0] = ig * (1.0 - z * z)
    G[:, :, :, 1, 0] = ig * z - w2 * a_c
    G[:, :, :, 1, 1] = ig * wq - w2 * a_n
    G[:, :, :, 1, 2] = w2
    G[:, :, :, 2, 0] = fg * c_prev - w1 * a_c
    G[:, :, :, 2, 1] = fg * n_prev * wq - w1 * a_n
    G[:, :, :, 2, 2] = w1
    del a_c, a_n, z, ig, c_prev, n_prev, w1, w2, r
    zero = torch.zeros_like(k1)
    K = torch.stack([k1, k2, zero], dim=3)  # e's share of (dc~, dn~, dm): [S,H,B,3,D]
    F_ = torch.stack([fg, fg * wq, zero], dim=3)  # (dc', dn') of (dc~, dn~)
    del k1, k2, fg, wq, zero
    k4 = k4[:, :, :, None]  # [S,H,B,1,D]
    RT = R32.permute(1, 0, 3, 2).reshape(H, 4 * D, D)  # [h, (g, e), k]
    dgates = torch.empty((S, H, B, 4, D), dtype=f32, device=u.device)
    dh_out = seq(dh_seq)[:, :, :, None]  # [S,H,B,1,D]
    # the per-step slices made once: a step then creates only two views
    steps = [t.unbind(0) for t in (dh_out, K, G, k4, F_, dgates)]
    only_dm = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=u.device)[:, None]  # [3, 1]
    zeros = torch.zeros((H, B, D), dtype=f32, device=u.device)
    dc, dn, dh, dm = [zeros if g is None else g.to(f32).transpose(0, 1)
                      for g in (dfinal if dfinal is not None else (None,) * 4)]
    P = torch.stack([dc, dn, dm], dim=2)  # (dc, dn, dm): [H,B,3,D]
    dh = dh[:, :, None]
    for t in range(S - 1, -1, -1):
        dh_t, K_t, G_t, k4_t, F_t, g = (x[t] for x in steps)
        e = dh_t + dh
        T = torch.addcmul(P, K_t, e)  # (dc~, dn~, dm)
        G3 = (G_t * T[:, :, None]).sum(3)
        torch.cat([G3, k4_t * e], dim=2, out=g)
        dh = torch.bmm(g.view(H, B, 4 * D), RT)[:, :, None]
        P = torch.addcmul(F_t * T, G3, only_dm)  # dm' = g_f: f and m enter only as f + m
    dc, dn, dm = P.unbind(2)
    dh = dh[:, :, 0]
    del G, K, F_, k4, dh_out, steps
    dR = torch.bmm(h_prev.transpose(0, 1).reshape(H, S * B, D).transpose(1, 2),
                   dgates.transpose(0, 1).reshape(H, S * B, 4 * D))  # [h, k, (g, e)]
    dR = dR.reshape(H, D, 4, D).permute(2, 0, 1, 3).to(R.dtype)
    du = dgates.permute(2, 0, 3, 1, 4).reshape(B, S, d4).to(u.dtype)
    back = lambda t, like: t.transpose(0, 1).to(like.dtype)  # noqa: E731
    return du, dR, back(dc, c0), back(dn, n0), back(dh, h0), back(dm.contiguous(), m0)


class SLSTMFunction(torch.autograd.Function):
    """The sLSTM recurrence, differentiable in ``u``, ``R`` and the initial
    state.

    ``apply(u, R, c0, n0, h0, m0)`` -> ``(h_seq, c, n, h, m)``: the forward
    is :func:`slstm_forward` with the per-step states saved (the kernel, or
    its plain version on CPU tensors); the backward is
    :func:`slstm_backward`."""

    @staticmethod
    def forward(ctx, u, R, c0, n0, h0, m0):
        h_seq, final, seqs = slstm_forward(u, R, c0, n0, h0, m0, save_states=True)
        ctx.save_for_backward(u, R, c0, n0, h0, m0, h_seq, *seqs)
        return (h_seq, *final)

    @staticmethod
    def backward(ctx, dh_seq, dc, dn, dh, dm):
        return slstm_backward(*ctx.saved_tensors, dh_seq, (dc, dn, dh, dm))
