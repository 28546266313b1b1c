"""Mamba2 / SSD block (Dao & Gu, 2024), the zamba2 backbone.

Train and prefill run the chunked SSD scan (:func:`ssd_chunked`): on a CUDA
tensor the hand-written kernel (``kernels/ssd.py``, differentiable through
``SSDFunction``), on a CPU tensor its plain PyTorch version.  The reference
computes the same scan in plain ``jnp`` (its Pallas ``ssd`` kernel is reached
only from its tests); the port wires its kernel into this twin of the
reference's ``ssd_chunked``, as it does flash attention and cross-entropy.
Decode is the O(1) recurrent update on the state ``[B, H, P, N]`` in torch
ops (the reference has no kernel there).

The cache of a block is ``{"conv": [B, K-1, C], "state": [B, H, P, N]}``,
both float32 whatever the model's cache dtype (as in the reference), and is
updated in place: the model hands each block views of its stacked cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ref import ssd_chunked_ref
from ..kernels.ssd import SSDFunction
from .layers import Spec, check_engine, rms_norm

__all__ = [
    "mamba2_specs",
    "mamba2_block_full",
    "mamba2_block_decode",
    "empty_mamba2_state",
    "ssd_chunked",
    "ssd_step",
]


def mamba2_specs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = di // cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    conv_ch = di + 2 * G * N
    return {
        "norm": Spec((d,), ("embed",), init="zeros"),
        "w_in": Spec((d, 2 * di + 2 * G * N + H), ("fsdp_embed", "mlp"), std=1.0 / math.sqrt(d)),
        "conv_w": Spec((cfg.ssm_conv, conv_ch), (None, "mlp"), std=0.1),
        "conv_b": Spec((conv_ch,), ("mlp",), init="zeros"),
        "A_log": Spec((H,), ("heads",), init="ones"),  # A = -exp(A_log)
        "D": Spec((H,), ("heads",), init="ones"),
        "dt_bias": Spec((H,), ("heads",), init="zeros"),
        "out_norm": Spec((di,), ("mlp",), init="zeros"),
        "w_out": Spec((di, d), ("mlp", "fsdp_embed"), std=1.0 / math.sqrt(di)),
    }


def _dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    return di, di // cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state


def _split_in(p, x, cfg):
    """in_proj: ``(z, conv_in, dt_raw)``, views of one product."""
    di, H, G, N = _dims(cfg)
    proj = x @ p.w_in.to(x.dtype)
    return proj[..., :di], proj[..., di:2 * di + 2 * G * N], proj[..., 2 * di + 2 * G * N:]


def _causal_conv(conv_in, w, bias, state=None):
    """Depthwise causal conv along S.  ``conv_in`` [B, S, C]; ``w`` [K, C].
    ``state`` ([B, K-1, C], any dtype) is prepended when given, else zeros;
    returns ``(silu(conv + bias), the trailing K-1 inputs)``, both in
    ``conv_in``'s dtype."""
    K = w.shape[0]
    S = conv_in.shape[1]
    if state is None:
        pad = conv_in.new_zeros((conv_in.shape[0], K - 1, conv_in.shape[2]))
    else:
        pad = state.to(conv_in.dtype)
    xp = torch.cat([pad, conv_in], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out + bias), xp[:, S:]


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int = 128, initial_state=None, engine: str = "auto"):
    """Chunked SSD.  ``xh`` [B, S, H, P]; ``dt`` [B, S, H] (post-softplus,
    float32); ``A`` [H] (< 0, float32); ``Bm``, ``Cm`` [B, S, G, N] (G
    divides H).  Returns ``(y [B, S, H, P], final_state [B, H, P, N])`` in
    float32.  ``engine``: ``"cuda"`` the kernel (``SSDFunction``, CUDA
    tensors only), ``"torch"`` the plain version (autograd through its ops),
    ``"auto"`` ``SSDFunction`` on any device (the kernel on CUDA tensors, the
    plain forward on CPU ones)."""
    check_engine(engine, xh.device)
    if engine == "torch":
        return ssd_chunked_ref(xh, dt, A, Bm, Cm, chunk, initial_state)
    return SSDFunction.apply(xh, dt, A, Bm, Cm, chunk, initial_state)


def _mamba_out(p, y, z, xh, cfg, dtype):
    b, S, H, P = y.shape
    y = y + xh.to(torch.float32) * p.D.to(torch.float32)[:, None]
    yf = rms_norm(y.reshape(b, S, H * P).to(dtype), p.out_norm, cfg.norm_eps)
    return (yf * F.silu(z)) @ p.w_out.to(dtype)


def _conv_split(p, x, cfg, state):
    """norm, in_proj, the causal conv and the head split: ``(z, xh, Bm, Cm,
    dt, A, new_conv)``, ``dt`` and ``A`` float32."""
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    z, conv_in, dt_raw = _split_in(p, xn, cfg)
    conved, new_conv = _causal_conv(conv_in, p.conv_w.to(x.dtype), p.conv_b.to(x.dtype), state)
    di, H, G, N = _dims(cfg)
    b, S, _ = x.shape
    xh = conved[..., :di].reshape(b, S, H, cfg.ssm_head_dim)
    Bm = conved[..., di:di + G * N].reshape(b, S, G, N)
    Cm = conved[..., di + G * N:].reshape(b, S, G, N)
    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias.to(torch.float32))
    A = -torch.exp(p.A_log.to(torch.float32))
    return z, xh, Bm, Cm, dt, A, new_conv


def mamba2_block_full(p, x, cfg, bdef, positions, cache=None, cache_index=None, engine="auto"):
    """Train / prefill.  Returns ``(out, cache)``; a given cache (prefill)
    starts the conv and the scan from its ``conv`` / ``state`` and gets the
    new ones written into it in place."""
    z, xh, Bm, Cm, dt, A, new_conv = _conv_split(p, x, cfg,
                                                 cache["conv"] if cache is not None else None)
    init = cache["state"] if cache is not None else None
    y, final = ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk, initial_state=init,
                           engine=engine)
    out = _mamba_out(p, y, z, xh, cfg, x.dtype)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(final)
    return out, cache


def mamba2_block_decode(p, x, cfg, bdef, cache, index):
    """One token, ``x`` [B, 1, d]: the O(1) state update, the cache updated
    in place."""
    z, xh, Bm, Cm, dt, A, new_conv = _conv_split(p, x, cfg, cache["conv"])
    y, state = ssd_step(cache["state"], xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    out = _mamba_out(p, y, z, xh, cfg, x.dtype)
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(state)
    return out, cache


def ssd_step(state, xh, dt, A, Bm, Cm):
    """One token of the SSD recurrence in float32: ``state`` [B, H, P, N],
    ``xh`` [B, H, P], ``dt`` [B, H], ``A`` [H], ``Bm`` / ``Cm`` [B, G, N]
    (each group read by H / G consecutive heads).  Returns ``(y [B, 1, H,
    P], the new state)``."""
    f32 = torch.float32
    rep = xh.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).to(f32)  # [B, H, N]
    Ch = Cm.repeat_interleave(rep, dim=1).to(f32)
    dA = torch.exp(dt * A[None, :])
    x0 = xh.to(f32) * dt[..., None]  # [B, H, P]
    state = state * dA[:, :, None, None] + x0[..., :, None] * Bh[..., None, :]
    return torch.einsum("bhpn,bhn->bhp", state, Ch)[:, None], state


def empty_mamba2_state(cfg, batch: int, device=None) -> dict:
    di, H, G, N = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * G * N), dtype=torch.float32,
                            device=device),
        "state": torch.zeros((batch, H, cfg.ssm_head_dim, N), dtype=torch.float32, device=device),
    }
