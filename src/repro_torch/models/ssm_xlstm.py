"""xLSTM blocks (Beck et al., 2024): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, truly recurrent).

mLSTM is evaluated in its stabilized parallel form for train and prefill
(query chunks against all earlier keys, with an exponential-gating decay
matrix instead of a softmax) and in its recurrent form (O(1) state ``C``
``[B, H, D, D]``) for decode.  The reference has no kernel for it, so torch
ops serve both devices.  Two of the reference's behaviours are replaced by
the same function computed another way:

* its parallel form halves ``q_chunk`` until it divides ``S``
  (``ssm_xlstm.py:102-104``), which gives chunks of one query on an odd
  length; each query row is computed from all keys with its own max, so
  :func:`mlstm_parallel` takes chunks of ``min(q_chunk, S)`` queries with a
  ragged last chunk, each against the keys up to its last query;
* its prefill replays the recurrence step by step to fold the prompt into
  the cache; :func:`mlstm_fold` computes the state after the prompt in
  closed form from any initial state: ``m_S = max(m_0 + F_S, max_s(F_S -
  F_s + logi_s))`` (``F`` the inclusive cumsum of ``logf``), ``w_s =
  exp(F_S - F_s + logi_s - m_S)``, ``C_S = exp(m_0 + F_S - m_S) C_0 + sum_s
  w_s k_s v_s^T`` and ``n_S`` likewise with ``k_s``: one batched float32
  product a block.

sLSTM has a genuine sequential dependency (recurrent weights feed h_{t-1}
into the gates): :func:`_slstm_scan` goes through the hand-written kernel
(``kernels/slstm.py``, differentiable through ``SLSTMFunction``) on CUDA
tensors and through its plain version on CPU ones, in every mode.

The caches (mLSTM ``{"C", "n", "m"}``, sLSTM ``{"c", "n", "h", "m"}``) are
float32 whatever the model's cache dtype, as in the reference, and are
updated in place: the model hands each block views of its stacked cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import full_float32_matmul
from ..kernels.ref import slstm_scan_ref
from ..kernels.slstm import SLSTMFunction, slstm_forward
from .layers import Spec, check_engine, rms_norm

__all__ = [
    "mlstm_specs",
    "slstm_specs",
    "mlstm_parallel",
    "mlstm_recurrent_step",
    "mlstm_fold",
    "mlstm_block_full",
    "mlstm_block_decode",
    "slstm_block_full",
    "slstm_block_decode",
    "empty_mlstm_state",
    "empty_slstm_state",
]


# -- specs ----------------------------------------------------------------------------


def mlstm_specs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_proj_factor * d  # inner width
    H = cfg.n_heads
    D = di // H
    return {
        "norm": Spec((d,), ("embed",), init="zeros"),
        "w_up": Spec((d, 2 * di), ("fsdp_embed", "mlp"), std=1.0 / math.sqrt(d)),
        # block-diagonal per-head q/k (v = conv output directly)
        "wq": Spec((H, D, D), ("heads", "head_dim", None), std=1.0 / math.sqrt(D)),
        "wk": Spec((H, D, D), ("heads", "head_dim", None), std=1.0 / math.sqrt(D)),
        "w_if": Spec((di, 2 * H), ("mlp", "heads"), std=1.0 / math.sqrt(di)),
        "b_f": Spec((H,), ("heads",), init="ones"),  # forget-gate bias > 0 at init
        "out_norm": Spec((di,), ("mlp",), init="zeros"),
        "w_down": Spec((di, d), ("mlp", "fsdp_embed"), std=1.0 / math.sqrt(di)),
    }


def slstm_specs(cfg) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    D = d // H
    return {
        "norm": Spec((d,), ("embed",), init="zeros"),
        "w_zifo": Spec((d, 4 * d), ("fsdp_embed", "mlp"), std=1.0 / math.sqrt(d)),
        # block-diagonal recurrent weights per head
        "r_zifo": Spec((4, H, D, D), (None, "heads", "head_dim", None), std=1.0 / math.sqrt(D)),
        "b_zifo": Spec((4 * d,), ("mlp",), init="zeros"),
        "out_norm": Spec((d,), ("embed",), init="zeros"),
        "w_out": Spec((d, d), ("fsdp_embed", "embed"), std=1.0 / math.sqrt(d)),
    }


# -- mLSTM ---------------------------------------------------------------------------------


def _mlstm_qkvif(p, x, cfg, gate_sum=None):
    """Project to per-head q, k, v, and i/f gate logits.  x: [B,S,d].  The
    heads are those of ``p.wq`` ``[H, D, D]``: all of them, or a shard's
    (``p.w_up`` then holds their xc columns, then their z columns, and
    ``p.w_if`` their xc rows: ``gate_sum`` takes the partial gate products
    ``[B,S,2 H_all]`` to the whole products of the shard's i and f
    columns)."""
    B, S, d = x.shape
    H, D = p.wq.shape[0], p.wq.shape[1]
    di = H * D
    up = x @ p.w_up.to(x.dtype)
    xc, z = up[..., :di], up[..., di:]
    xh = xc.reshape(B, S, H, D)
    q = torch.einsum("bshd,hde->bshe", xh, p.wq.to(x.dtype))
    k = torch.einsum("bshd,hde->bshe", xh, p.wk.to(x.dtype)) / math.sqrt(D)
    v = xh
    gates = xc @ p.w_if.to(x.dtype)
    if gate_sum is not None:
        gates = gate_sum(gates)
    gates = gates.to(torch.float32)
    logi = gates[..., :H]
    logf = F.logsigmoid(gates[..., H:] + p.b_f.to(torch.float32))
    return q, k, v, z, logi, logf


def _mlstm_chunk(qb, kT, vh, lih, Fh, q0: int):
    """Query rows ``q0 .. q0 + qc - 1`` (``qb`` ``[B,H,qc,D]``) of the
    stabilized parallel form, against the keys ``0 .. q0 + qc - 1`` (the
    later ones are masked); ``kT`` ``[B,H,D,S]``, ``vh`` ``[B,H,S,D]``,
    ``lih`` / ``Fh`` ``[B,H,S]``.  Returns ``[B,H,qc,D]``."""
    qc = qb.shape[2]
    end = q0 + qc
    logD = (Fh[:, :, q0:end, None] - Fh[:, :, None, :end]
            + lih[:, :, None, :end])  # [B,H,qc,end]
    later = torch.ones((qc, end), dtype=torch.bool, device=qb.device).triu(q0 + 1)
    logD = logD.masked_fill(later, float("-inf"))
    m = torch.clamp_min(logD.amax(dim=-1, keepdim=True), -1e30)  # [B,H,qc,1]
    Dmat = torch.exp(logD - m)
    w = (qb.float() @ kT[..., :end].float()) * Dmat
    numer = w.to(qb.dtype) @ vh[:, :, :end]
    denom = torch.maximum(w.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))  # [B,H,qc,1]
    return numer / denom.to(qb.dtype)


@full_float32_matmul()
def mlstm_parallel(q, k, v, logi, logf, q_chunk: int = 256):
    """Stabilized parallel mLSTM.  q,k,v: [B,S,H,D]; logi/logf: [B,S,H] (f32).

    h_t = sum_s D_ts (q_t.k_s) v_s / max(|sum_s D_ts (q_t.k_s)|, exp(-m_t)),
    log D_ts = F_t - F_s + logi_s (s<=t),  m_t = max_s log D_ts.

    Queries go in chunks of ``min(q_chunk, S)`` (the last one ragged), each
    recomputed in the backward pass when a gradient is needed (the twin of
    the reference's ``jax.checkpoint`` on its chunk body).  The chunks read
    views of q, k, v with the heads leading."""
    B, S, H, D = q.shape
    F_all = torch.cumsum(logf, dim=1)  # [B,S,H] inclusive
    qc = min(q_chunk, S)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, logi, logf))
    qh, vh, kT = q.transpose(1, 2), v.transpose(1, 2), k.permute(0, 2, 3, 1)  # views
    lih, Fh = logi.transpose(1, 2), F_all.transpose(1, 2)
    outs = []
    for q0 in range(0, S, qc):
        args = (qh[:, :, q0:q0 + qc], kT, vh, lih, Fh, q0)
        outs.append(checkpoint(_mlstm_chunk, *args, use_reentrant=False) if remat
                    else _mlstm_chunk(*args))
    return torch.cat([o.transpose(1, 2) for o in outs], dim=1)


def mlstm_recurrent_step(state, q, k, v, logi, logf, combine=None):
    """One decode step.  state: dict(C [B,H,D,D], n [B,H,D], m [B,H]);
    q,k,v: [B,1,H,D]; logi/logf: [B,1,H].  Returns ``(new state, h [B,1,H,D])``.

    With ``combine``, ``C`` / ``n`` hold a slice of the key dims (``C``'s
    rows) and ``q`` / ``k`` the same slice: ``combine(numer [B,H,D], qn
    [B,H])`` sums the partial contractions over the slices before the
    division."""
    C, nvec, m = state["C"], state["n"], state["m"]
    logi = logi[:, 0].to(torch.float32)
    logf = logf[:, 0].to(torch.float32)
    q_, k_, v_ = q[:, 0], k[:, 0], v[:, 0]

    m_new = torch.maximum(logf + m, logi)
    f_ = torch.exp(logf + m - m_new)[..., None]
    i_ = torch.exp(logi - m_new)[..., None]
    C_new = f_[..., None] * C + i_[..., None] * torch.einsum("bhd,bhe->bhde", k_, v_)
    n_new = f_ * nvec + i_ * k_
    with full_float32_matmul():
        numer = torch.einsum("bhd,bhde->bhe", q_.float(), C_new)
    qn = torch.einsum("bhd,bhd->bh", q_.float(), n_new)
    if combine is not None:
        numer, qn = combine(numer, qn)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))[..., None]
    h = (numer / denom)[:, None].to(q.dtype)
    return {"C": C_new, "n": n_new, "m": m_new}, h


@full_float32_matmul()
def mlstm_fold(state, k, v, logi, logf):
    """The state after the steps ``k, v`` [B,S,H,D], ``logi / logf`` [B,S,H]
    from ``state`` (dict C, n, m): the closed form of S
    :func:`mlstm_recurrent_step` updates (see the module docstring), in
    float32.  In bfloat16 the reference rounds each outer product ``k_s
    v_s^T`` to bfloat16 before scaling it; here the products are exact."""
    C0, n0, m0 = state["C"], state["n"], state["m"]
    F_all = torch.cumsum(logf.to(torch.float32), dim=1)  # [B,S,H]
    F_S = F_all[:, -1]  # [B,H]
    a = F_S[:, None] - F_all + logi.to(torch.float32)  # [B,S,H]
    m_S = torch.maximum(m0 + F_S, a.amax(dim=1))
    w = torch.exp(a - m_S[:, None])  # [B,S,H]
    decay = torch.exp(m0 + F_S - m_S)  # [B,H]
    kw = (k.to(torch.float32) * w[..., None]).permute(0, 2, 3, 1)  # [B,H,D,S]
    C = decay[..., None, None] * C0 + kw @ v.to(torch.float32).transpose(1, 2)
    n = decay[..., None] * n0 + kw.sum(dim=-1)
    return {"C": C, "n": n, "m": m_S}


def _mlstm_out(p, h, z, cfg, x_dtype):
    B, S, H, D = h.shape
    hf = rms_norm(h.reshape(B, S, H * D), p.out_norm, cfg.norm_eps)
    gated = hf * F.silu(z)
    return gated @ p.w_down.to(x_dtype)


def _write(cache: dict, state: dict) -> dict:
    for key, t in state.items():
        cache[key].copy_(t)
    return cache


def mlstm_block_full(p, x, cfg, bdef, positions, cache=None, cache_index=None, engine="auto"):
    """Train / prefill.  Returns ``(out, cache)``; a given cache (prefill)
    gets the prompt folded into its state in place."""
    check_engine(engine, x.device)
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    q, k, v, z, logi, logf = _mlstm_qkvif(p, xn, cfg)
    h = mlstm_parallel(q, k, v, logi, logf, q_chunk=cfg.q_chunk)
    out = _mlstm_out(p, h, z, cfg, x.dtype)
    if cache is not None:
        _write(cache, mlstm_fold(cache, k, v, logi, logf))
    return out, cache


def mlstm_block_decode(p, x, cfg, bdef, cache, index):
    """One token: the recurrent update, the cache updated in place."""
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    q, k, v, z, logi, logf = _mlstm_qkvif(p, xn, cfg)
    new_state, h = mlstm_recurrent_step(cache, q, k, v, logi, logf)
    out = _mlstm_out(p, h, z, cfg, x.dtype)
    return out, _write(cache, new_state)


def empty_mlstm_state(cfg, batch: int, device=None) -> dict:
    di = cfg.ssm_proj_factor * cfg.d_model
    H = cfg.n_heads
    D = di // H
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, D, D), dtype=f32, device=device),
        "n": torch.zeros((batch, H, D), dtype=f32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=f32, device=device),
    }


# -- sLSTM --------------------------------------------------------------------------------


def _slstm_scan(p, zifo, cfg, state, engine: str = "auto"):
    """Sequential sLSTM over time.  zifo: [B,S,4d] pre-activations (input
    part); recurrent part added step by step.  Returns (h_seq [B,S,d]
    float32, final state).  ``engine``: ``"cuda"`` the kernel (CUDA tensors
    only), ``"torch"`` the plain version (autograd through its loop),
    ``"auto"`` the kernel's wrapper on any device (``SLSTMFunction`` when a
    gradient is needed)."""
    check_engine(engine, zifo.device)
    R = p.r_zifo.to(torch.float32)  # [4,H,D,D]
    init = tuple(state[key] for key in ("c", "n", "h", "m"))
    if engine == "torch":
        hs, final = slstm_scan_ref(zifo, R, *init)
    elif torch.is_grad_enabled() and (zifo.requires_grad or R.requires_grad):
        hs, *final = SLSTMFunction.apply(zifo, R, *init)
    else:
        hs, final = slstm_forward(zifo, R, *init)
    return hs, dict(zip(("c", "n", "h", "m"), final))


def slstm_block_full(p, x, cfg, bdef, positions, cache=None, cache_index=None, engine="auto"):
    """Train / prefill (and, with ``S = 1``, decode).  Returns ``(out,
    cache)``; a given cache starts the scan from its state and gets the
    final state written into it in place."""
    B, S, d = x.shape
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    zifo = xn @ p.w_zifo.to(x.dtype) + p.b_zifo.to(x.dtype)
    state = cache if cache is not None else empty_slstm_state(cfg, B, device=x.device)
    hs, final = _slstm_scan(p, zifo, cfg, state, engine)
    hn = rms_norm(hs.to(x.dtype), p.out_norm, cfg.norm_eps)
    out = hn @ p.w_out.to(x.dtype)
    if cache is not None:
        _write(cache, final)
    return out, cache


def slstm_block_decode(p, x, cfg, bdef, cache, index):
    return slstm_block_full(p, x, cfg, bdef, None, cache=cache, cache_index=index)


def empty_slstm_state(cfg, batch: int, device=None) -> dict:
    H = cfg.n_heads
    D = cfg.d_model // H
    z = lambda: torch.zeros((batch, H, D), dtype=torch.float32, device=device)  # noqa: E731
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, H, D), -1e30, dtype=torch.float32, device=device)}
