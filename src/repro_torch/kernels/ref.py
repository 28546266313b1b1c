"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function computes on whatever device its tensors live on.  The kernel
wrappers take these for CPU tensors, and ``chip_smoke.py`` holds every
kernel against them on the card.
"""

from __future__ import annotations

import math

import torch

__all__ = ["parzen_score_ref", "mc_hv_counts_ref", "mc_hv_samples_ref", "mc_hv_counts_sets_ref",
           "flash_attention_ref", "crossentropy_ref",
           "crossentropy_lse_ref", "ssd_ref", "ssd_chunked_ref", "ssd_chunk_len", "slstm_scan_ref"]

#: elements of the boolean (samples, points, objectives) cube per chunk
_MC_CUBE_ELEMS = 1 << 27
#: float32 scores per query chunk of the plain attention (1 GiB)
_ATTN_SCORE_ELEMS = 1 << 28
#: float32 logits per row chunk of the plain cross-entropy (1 GiB)
_CE_LOGIT_ELEMS = 1 << 28


def parzen_score_ref(
    cands: torch.Tensor,  # [C]
    l_mus: torch.Tensor, l_sigmas: torch.Tensor, l_log_norm: torch.Tensor,  # [Kl]
    g_mus: torch.Tensor, g_sigmas: torch.Tensor, g_log_norm: torch.Tensor,  # [Kg]
) -> torch.Tensor:
    """TPE acquisition ``log l - log g`` as a [C] float32 tensor: the
    ``(C, K)`` exponent matrix of each side is materialized, clamped at
    ``-1e30`` (so ``-inf``-padded components stay inert) and reduced with
    ``torch.logsumexp`` (oracle for the fused online-accumulation kernel)."""
    cands = cands.to(torch.float32)

    def side(mus, sigmas, ln):
        mus, sigmas, ln = (t.to(torch.float32) for t in (mus, sigmas, ln))
        z = (cands[:, None] - mus[None, :]) / sigmas[None, :]
        e = torch.clamp(-0.5 * z * z + ln[None, :], min=-1e30)
        return torch.logsumexp(e, dim=1)

    return side(l_mus, l_sigmas, l_log_norm) - side(g_mus, g_sigmas, g_log_norm)


def mc_hv_counts_ref(
    points: torch.Tensor,  # [n, m]
    samples: torch.Tensor,  # [s, m]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo hypervolume counts ``(excl [n] float32, total float32
    0-d)`` on the inputs' device: the broadcast ``(s, n, m)`` domination cube
    ``points <= samples`` reduced over objectives, then the dominators per
    sample, the samples with any dominator (``total``) and, per point, the
    samples it alone dominates (``excl``).  Samples go in chunks so the cube
    stays near ``_MC_CUBE_ELEMS`` booleans (oracle for the streaming
    kernel)."""
    points = points.to(torch.float32)
    samples = samples.to(torch.float32)
    n, m = points.shape
    excl = torch.zeros(n, dtype=torch.int64, device=points.device)
    total = torch.zeros((), dtype=torch.int64, device=points.device)
    chunk = max(1, _MC_CUBE_ELEMS // max(1, n * m))
    for start in range(0, len(samples), chunk):
        smp = samples[start:start + chunk]
        dom = (points[None, :, :] <= smp[:, None, :]).all(dim=2)  # [c, n]
        cnt = dom.sum(dim=1)
        total += (cnt > 0).sum()
        excl += (dom & (cnt == 1)[:, None]).sum(dim=0)
    return excl.to(torch.float32), total.to(torch.float32)


def mc_hv_samples_ref(
    lo: torch.Tensor,  # [G, m] float64
    span: torch.Tensor,  # [G, m] float64
    u: torch.Tensor,  # [s, m] float64
) -> torch.Tensor:
    """``[G, s, m]`` float32 samples ``float32(lo + span * u)``: a float64
    product, then a float64 sum, then one rounding to float32, the bits of
    numpy's ``RandomState.uniform(lo, lo + span)`` rounded to float32 when
    ``u`` is the same state's ``random_sample`` (oracle for the sample rule
    of the batched counting kernel)."""
    prod = torch.mul(span[:, None, :], u[None, :, :])
    return torch.add(lo[:, None, :], prod).to(torch.float32)


def mc_hv_counts_sets_ref(
    points: torch.Tensor,  # [N, m] float32
    offsets: torch.Tensor,  # [G + 1] int32
    lo: torch.Tensor,  # [G, m] float64
    span: torch.Tensor,
    u: torch.Tensor,  # [s, m] float64
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(excl [N] float32, total [G] float32)``: :func:`mc_hv_counts_ref`
    for each set's rows ``offsets[g] .. offsets[g + 1]`` against its samples
    from :func:`mc_hv_samples_ref` (oracle for the batched kernel)."""
    bounds = offsets.tolist()
    excl = torch.zeros(points.shape[0], dtype=torch.float32, device=points.device)
    total = torch.zeros(len(bounds) - 1, dtype=torch.float32, device=points.device)
    for g, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        if b > a:
            smp = mc_hv_samples_ref(lo[g:g + 1], span[g:g + 1], u)[0]
            excl[a:b], total[g] = mc_hv_counts_ref(points[a:b], smp)
    return excl, total


def flash_attention_ref(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = -1,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: "int | None" = None,
) -> torch.Tensor:
    """Attention in float32 with the reference's ``attention_ref`` semantics
    (oracle for the flash-attention kernel): scores ``q . k / sqrt(D)``, the
    softcap, ``-1e30`` at masked keys, a softmax, ``P V`` in float32, the
    result cast to ``q``'s dtype.  A query row ``r`` sits at position
    ``q_offset + r``; keys at ``>= kv_len`` are masked.  Query head ``h``
    reads kv head ``h // (Hq // Hkv)``.  Queries go in chunks so the float32
    scores stay near ``_ATTN_SCORE_ELEMS`` elements."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_len = Skv if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    k_pos = torch.arange(Skv, device=q.device)
    out = torch.empty_like(q)  # q's strides, as the kernel's output has
    chunk = max(1, _ATTN_SCORE_ELEMS // max(1, B * Hq * Skv))
    for start in range(0, Sq, chunk):
        n = min(chunk, Sq - start)
        qb = q[:, :, start:start + n].to(torch.float32).reshape(B, Hkv, G, n, D)
        s = torch.einsum("bkgqd,bktd->bkgqt", qb, kf) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        q_pos = q_offset + start + torch.arange(n, device=q.device)
        mask = (k_pos < kv_len)[None, :].expand(n, Skv)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,bktd->bkgqd", p, vf)
        out[:, :, start:start + n] = o.reshape(B, Hq, n, D).to(q.dtype)
    return out


def crossentropy_lse_ref(
    x: torch.Tensor,  # [T, D]
    w: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # [T] int32 / int64
    softcap: float = 0.0,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(nll [T], lse [T])`` in float32 (oracle for the fused cross-entropy
    kernel): ``W`` rounded to ``x``'s dtype, the float32 product, the softcap,
    ``torch.logsumexp`` over the vocabulary and the label logit; a label
    outside ``[0, V)`` contributes no label logit.  Rows go in chunks so the
    float32 logits stay near ``_CE_LOGIT_ELEMS`` elements; autograd runs
    through it.  ``compute_dtype=torch.float64`` computes the same from the
    same rounded operands in float64 (and returns float64): the truth the
    kernel and the float32 version are both measured against."""
    T = x.shape[0]
    V = w.shape[1]
    wc = w.to(x.dtype).to(compute_dtype)
    chunk = max(1, _CE_LOGIT_ELEMS // max(1, V))
    nll, lse = [], []
    for start in range(0, T, chunk):
        logits = x[start:start + chunk].to(compute_dtype) @ wc
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        lab = labels[start:start + chunk].long()
        valid = (lab >= 0) & (lab < V)
        picked = logits.gather(1, lab.clamp(0, V - 1)[:, None])[:, 0]
        lse_c = torch.logsumexp(logits, dim=1)
        lse.append(lse_c)
        nll.append(lse_c - torch.where(valid, picked, torch.zeros((), device=x.device)))
    return torch.cat(nll), torch.cat(lse)


def crossentropy_ref(
    x: torch.Tensor,  # [T, D]
    w: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # [T]
    softcap: float = 0.0,
) -> torch.Tensor:
    """Per-token negative log-likelihood ``lse(x W) - (x W)[label]`` as a [T]
    float32 tensor (see :func:`crossentropy_lse_ref`)."""
    return crossentropy_lse_ref(x, w, labels, softcap)[0]


def ssd_ref(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (post-softplus)
    A: torch.Tensor,  # [H] (negative)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    initial_state: "torch.Tensor | None" = None,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence step by step (the reference's ``ssd_ref``), in
    float32: ``h_t = exp(dt_t A) h_{t-1} + (x_t dt_t) B_t^T`` and ``y_t = h_t
    C_t``, query head ``h`` reading group ``h // (H // G)``.  Returns ``(y
    [B, S, H, P], final state [B, H, P, N])``."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    Bh = Bm.to(f32).repeat_interleave(rep, dim=2)  # [B,S,H,N]
    Ch = Cm.to(f32).repeat_interleave(rep, dim=2)
    dA = torch.exp(dt.to(f32) * A.to(f32)[None, None, :])  # [B,S,H]
    xdt = x.to(f32) * dt.to(f32)[..., None]
    state = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((b, H, P, N), dtype=f32, device=x.device))
    ys = []
    for t in range(S):
        state = state * dA[:, t, :, None, None] + xdt[:, t, :, :, None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk length for ``S`` steps: ``min(chunk, S)``, halved
    until it divides ``S`` (``repro/models/mamba2.py::ssd_chunked``)."""
    L = min(chunk, S)
    while S % L != 0:
        L //= 2
    return L


def ssd_chunked_ref(
    xh: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (post-softplus), float32
    A: torch.Tensor,  # [H] (negative), float32
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    chunk: int = 128,
    initial_state: "torch.Tensor | None" = None,  # [B, H, P, N]
    *,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked SSD (``repro/models/mamba2.py::ssd_chunked``)
    in float32 (``compute_dtype=torch.float64`` gives a yardstick of that
    rounding), its ``lax.scan`` over chunks a Python loop: chunks of
    :func:`ssd_chunk_len` steps; per chunk, the intra-chunk term
    ``sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) x_s dt_s`` (the decay masked
    at ``-inf`` before the ``exp``), the chunk's state contribution, and the
    entering state's term ``exp(cum_t) C_t . h_in``.  Query head ``h`` reads
    group ``h // (H // G)``.  Returns ``(y [B, S, H, P], final state [B, H,
    P, N])``, both in ``compute_dtype``; autograd runs through it."""
    b, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = ssd_chunk_len(S, chunk)
    n = S // L
    ct = compute_dtype
    dA = dt.to(ct) * A.to(ct)[None, None, :]  # [B,S,H] log-decay per step
    xdt = xh.to(ct) * dt.to(ct)[..., None]
    dA_c = dA.reshape(b, n, L, H)
    x_c = xdt.reshape(b, n, L, H, P)
    B_c = Bm.to(ct).reshape(b, n, L, G, N).repeat_interleave(rep, dim=3)  # [b,n,L,H,N]
    C_c = Cm.to(ct).reshape(b, n, L, G, N).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dA_c, dim=2)  # [b,n,L,H] inclusive
    total = cum[:, :, -1:, :]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,n,L,L,H]
    causal = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bcthn,bcshn->bctsh", C_c, B_c)
    y_diag = torch.einsum("bctsh,bcshp->bcthp", cb * decay, x_c)
    decay_out = torch.exp(total - cum)  # [b,n,L,H]
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", B_c, decay_out, x_c)  # [b,n,H,P,N]
    chunk_decay = torch.exp(total[:, :, 0, :])  # [b,n,H]
    carry = (initial_state.to(ct) if initial_state is not None
             else torch.zeros((b, H, P, N), dtype=ct, device=xh.device))
    entering = []
    for c in range(n):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # [b,n,H,P,N]
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", C_c, entering, torch.exp(cum))
    return (y_diag + y_off).reshape(b, S, H, P), carry


def slstm_scan_ref(
    u: torch.Tensor,  # [B, S, 4 d] pre-activations, gate g / head h / dim e at g d + h D + e
    R: torch.Tensor,  # [4, H, D, D] recurrent weights
    c0: torch.Tensor,  # [B, H, D] initial state
    n0: torch.Tensor,
    h0: torch.Tensor,
    m0: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.float32,
    states: bool = False,
) -> tuple:
    """The sLSTM recurrence step by step (the reference's
    ``models/ssm_xlstm.py::_slstm_scan``), in ``compute_dtype``: per step
    ``rec = h @ R`` per head and gate, ``z = tanh``, ``o = sigmoid``, ``i``
    and ``f`` raw logits, ``m' = max(f + m, i)``, ``c' = exp(f + m - m') c
    + exp(i - m') z``, ``n' = max(exp(f + m - m') n + exp(i - m'),
    exp(-m'))`` and ``h' = o c' / n'``.  Returns ``(h_seq [B, S, d], (c, n,
    h, m))``, with ``states`` also the per-step ``(c, n, m)`` as ``[B, S,
    d]`` (what the written-out backward reads); everything in
    ``compute_dtype`` (``torch.float64`` gives a yardstick of float32's
    rounding).  Autograd runs through it."""
    B, S, d4 = u.shape
    H, D = R.shape[1], R.shape[2]
    ct = compute_dtype
    Rc = R.to(ct)
    c, n, h, m = (t.to(ct) for t in (c0, n0, h0, m0))
    hs, cs, ns, ms = [], [], [], []
    for t in range(S):
        rec = torch.einsum("bhd,ghde->gbhe", h, Rc)
        a = u[:, t].to(ct).reshape(B, 4, H, D).transpose(0, 1) + rec
        z, i, f, o = torch.tanh(a[0]), a[1], a[2], torch.sigmoid(a[3])
        m_new = torch.maximum(f + m, i)
        i_ = torch.exp(i - m_new)
        f_ = torch.exp(f + m - m_new)
        c = f_ * c + i_ * z
        n = torch.maximum(f_ * n + i_, torch.exp(-m_new))
        h = o * c / n
        m = m_new
        hs.append(h.reshape(B, d4 // 4))
        if states:
            cs.append(c.reshape(B, d4 // 4))
            ns.append(n.reshape(B, d4 // 4))
            ms.append(m.reshape(B, d4 // 4))
    h_seq = torch.stack(hs, dim=1)
    if not states:
        return h_seq, (c, n, h, m)
    return h_seq, (c, n, h, m), tuple(torch.stack(x, dim=1) for x in (cs, ns, ms))
