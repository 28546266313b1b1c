"""Mixture-of-Experts FFN with token-choice top-k routing.

Two dispatch modes (selected by ``cfg.moe_dispatch``), each the twin of the
reference's:

* ``"einsum"`` — the Mesh-TF/GLaM one-hot capacity dispatch.  Tokens are
  reshaped into groups of ``moe_group`` (halved until it divides the token
  count, as in the reference: the capacity is per group, so the group size
  is part of the function) and dispatched through [G, S_g, E, C] one-hot
  tensors with C = ceil(S_g*k/E * capacity_factor).  A group fills each
  expert's buffer choice-major: every token's first choice before any
  second choice.
* ``"sort"`` — sort-based dispatch: the token-major (token, choice) list is
  stably argsorted by expert id and gathered into [E, C, d] buffers with
  index arithmetic only, one capacity C over all T tokens.  An expert's
  buffer fills token-major.

The two modes therefore drop different tokens once an expert overflows.
Neither renormalizes the combine weights over the surviving assignments
(the reference's module docstring says so, its code does not): a dropped
assignment contributes 0 and the others keep their top-k weights.  Both add
the auxiliary load-balance loss of Shazeer et al. / Switch on the first
choice.

The one-hot dispatch and combine tensors hold the reference's values (0 and
1, the float32 top-k weights); they are built by one scatter per group row
instead of k one-hot products, which gives the same tensors (a token's k
experts are distinct, so no two of its choices share a slot), and the
groups run in blocks of at most ``EXPERT_ROWS`` expert-buffer rows (the
groups are independent, so the blocks change no number).  The sort
path combines each token's k terms in a fixed order, ascending expert id,
in the compute dtype, one rounding per add, as the reference's sequential
scatter-add does: two calls give the same bits on any device.  The expert
products are plain ``torch.bmm`` / ``torch.einsum`` (cuBLAS on the card):
the reference computes them outside any kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ops import full_float32_matmul
from .layers import Spec

__all__ = ["moe_specs", "moe_ffn", "shared_expert_specs", "top_k", "route", "group_size",
           "EXPERT_ROWS"]

#: the einsum dispatch's expert-buffer rows (E x groups x C) a block of groups
EXPERT_ROWS = 1 << 18


def moe_specs(cfg) -> dict:
    d, E, Fd = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    std = 1.0 / math.sqrt(d)
    specs = {
        "router": Spec((d, E), ("embed", "experts"), std=std),
        "w1": Spec((E, d, Fd), ("experts", "fsdp_embed", "mlp"), std=std),
        "w3": Spec((E, d, Fd), ("experts", "fsdp_embed", "mlp"), std=std),
        "w2": Spec((E, Fd, d), ("experts", "mlp", "fsdp_embed"), std=1.0 / math.sqrt(Fd)),
    }
    if cfg.moe_shared_d_ff:
        specs.update(shared_expert_specs(cfg))
    return specs


def shared_expert_specs(cfg) -> dict:
    d, Fd = cfg.d_model, cfg.moe_shared_d_ff
    std = 1.0 / math.sqrt(d)
    return {
        "sw1": Spec((d, Fd), ("fsdp_embed", "mlp"), std=std),
        "sw3": Spec((d, Fd), ("fsdp_embed", "mlp"), std=std),
        "sw2": Spec((Fd, d), ("mlp", "fsdp_embed"), std=1.0 / math.sqrt(Fd)),
    }


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices, the
    lower index first among equal values (``jax.lax.top_k``'s rule, which
    ``torch.topk`` does not promise): a stable descending sort."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(p, x, cfg):
    """Returns (router probabilities [T, E], top-k weights [T, k] float32,
    top-k expert ids [T, k]).  The logits are float32 products (TF32 off) of
    the float32 activations and router."""
    with full_float32_matmul():
        logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, cfg.moe_top_k)
    if cfg.moe_norm_topk:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return probs, w, idx


def _router(p, x, cfg):
    """Returns (top-k weights [T, k] float32, top-k expert ids [T, k], aux
    loss)."""
    probs, w, idx = route(p, x, cfg)
    # Switch aux loss: E * sum_e (fraction of first choices to e) * (mean prob for e)
    E = cfg.moe_experts
    load = F.one_hot(idx[:, 0], E).to(torch.float32).mean(0)
    importance = probs.mean(0)
    aux = E * torch.sum(load * importance)
    return w, idx, aux


def _capacity(tokens_per_group: int, cfg) -> int:
    c = int(math.ceil(tokens_per_group * cfg.moe_top_k / cfg.moe_experts * cfg.moe_capacity))
    return max(c, cfg.moe_top_k)


def group_size(T: int, cfg) -> int:
    """The einsum dispatch's tokens a group: ``moe_group`` (at most T)
    halved until it divides T, as in the reference."""
    Sg = min(cfg.moe_group, T)
    while T % Sg != 0:
        Sg //= 2
    return Sg


def _experts(p, xe: torch.Tensor, dtype) -> torch.Tensor:
    """SwiGLU of every expert over its rows: xe [E, R, d] -> [E, R, d]."""
    h = torch.bmm(xe, p.w1.to(dtype))
    g = torch.bmm(xe, p.w3.to(dtype))
    return torch.bmm(F.silu(h) * g, p.w2.to(dtype))


# -- einsum (one-hot) dispatch --------------------------------------------------------------


def _moe_einsum(p, xt, w, idx, cfg, experts=None, group=None):
    """xt: [T, d] flat tokens.  Under expert parallelism
    (``models/tensor_parallel.py``) ``experts = (lo, hi)`` names the experts
    whose weights ``p`` holds: only their buffers are filled and run, and
    the result is their part of the sum over experts; ``group`` is then the
    group size of the whole batch, of which ``xt`` holds whole groups."""
    T, d = xt.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    Sg = group_size(T, cfg) if group is None else group
    G = T // Sg
    C = _capacity(Sg, cfg)

    xg = xt.reshape(G, Sg, d)
    wg = w.reshape(G, Sg, k)
    ig = idx.reshape(G, Sg, k)

    # each (token, choice)'s position in its expert's buffer: a cumsum over
    # the group of the choice's one-hot, after every earlier choice's count
    slots, keeps = [], []
    prev_counts = torch.zeros((G, 1, E), dtype=torch.int64, device=xt.device)
    for j in range(k):
        e = ig[:, :, j]
        onehot = F.one_hot(e, E)  # [G, Sg, E]
        pos = torch.cumsum(onehot, dim=1) - 1 + prev_counts
        prev_counts = prev_counts + onehot.sum(dim=1, keepdim=True)
        pos = pos.gather(2, e[..., None])[..., 0]  # [G, Sg]
        keeps.append(pos < C)
        slots.append(e * C + torch.clamp(pos, max=C - 1))
    slot = torch.stack(slots, dim=-1)  # [G, Sg, k]: distinct within a token
    keep = torch.stack(keeps, dim=-1)
    # the groups are independent: run them in blocks of at most
    # EXPERT_ROWS buffer rows (E x groups x C), so that a served group whose
    # odd length halves the group to a few tokens (thousands of groups, C
    # = k each) does not hold every group's [E, G, C, d] buffer at once
    ys = []
    step = max(1, EXPERT_ROWS // (E * C))
    for g0 in range(0, G, step):
        g1 = min(g0 + step, G)
        n = g1 - g0
        dispatch = torch.zeros((n, Sg, E * C), dtype=xt.dtype, device=xt.device).scatter(
            2, slot[g0:g1], keep[g0:g1].to(xt.dtype))
        combine = torch.zeros((n, Sg, E * C), dtype=torch.float32, device=xt.device).scatter(
            2, slot[g0:g1], wg[g0:g1] * keep[g0:g1].to(torch.float32))
        dispatch, combine = dispatch.view(n, Sg, E, C), combine.view(n, Sg, E, C)
        ne = E
        if experts is not None:  # this rank's experts (the reference's "experts" anchor)
            dispatch, combine = dispatch[:, :, experts[0]:experts[1]], combine[:, :, experts[0]:experts[1]]
            ne = experts[1] - experts[0]
        xe = torch.einsum("gsec,gsd->egcd", dispatch, xg[g0:g1])
        o = _experts(p, xe.reshape(ne, n * C, d), xt.dtype).view(ne, n, C, d)
        ys.append(torch.einsum("egcd,gsec->gsd", o, combine.to(xt.dtype)))
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    return y.reshape(T, d)


# -- sort-based dispatch ------------------------------------------------------------------------


def _moe_sort(p, xt, w, idx, cfg, experts=None, before=None, tokens=None):
    """Sort-based dispatch without [T, E, C] one-hots.

    1. flatten (token, choice) pairs token-major, sort by expert id (stable),
    2. compute each pair's slot within its expert (rank - expert start),
    3. add token vectors into [E*C, d] buffers (the slots are distinct; a
       dropped pair adds an exact 0 to the last slot), run the experts,
    4. gather back and combine each token's k terms in ascending expert
       order, one compute-dtype rounding per add.

    Under a mesh (``models/tensor_parallel.py``) ``xt`` is one batch shard's
    tokens of a microbatch of ``tokens`` tokens, the shards in token order:
    ``before`` [E] counts each expert's pairs on the earlier shards, so a
    pair's rank within its expert is its rank here plus that count, held to
    the microbatch's one capacity; the buffers hold this shard's kept pairs
    only (at most one a token an expert: ``min(C, T)`` rows an expert).
    ``experts = (lo, hi)`` names the experts whose weights ``p`` holds: the
    other experts' pairs add nothing here, and the result is these experts'
    part of the sum over experts.
    """
    T, d = xt.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = _capacity(T if tokens is None else tokens, cfg)
    rows = C if before is None else min(C, T)
    lo, hi = experts or (0, E)
    ne = hi - lo
    dev = xt.device

    flat_e = idx.reshape(-1)  # [T*k]
    flat_w = w.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    stok = flat_tok[order]
    sw = flat_w[order]

    # rank within expert: global rank - start offset of that expert
    counts = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(T * k, device=dev) - starts[se]
    keep = ranks < C if before is None else ranks + before[se] < C
    if experts is not None:
        keep = keep & (se >= lo) & (se < hi)
    slot = torch.clamp((se - lo) * rows + torch.clamp(ranks, max=rows - 1), 0, ne * rows - 1)

    keep_x = keep[:, None].to(xt.dtype)
    buf = torch.zeros((ne * rows, d), dtype=xt.dtype, device=dev).index_add(
        0, torch.where(keep, slot, ne * rows - 1), xt[stok] * keep_x)
    o = _experts(p, buf.view(ne, rows, d), xt.dtype).view(ne * rows, d)

    terms = o[slot] * keep_x * sw[:, None].to(xt.dtype)  # [T*k, d], sorted order
    # back to token-major, then each token's terms in ascending expert order
    token_major = torch.empty_like(order).scatter_(0, order, torch.arange(T * k, device=dev))
    by_expert = torch.argsort(idx, dim=-1)  # a token's experts are distinct
    pick = token_major.view(T, k).gather(1, by_expert)
    terms = terms[pick.reshape(-1)].view(T, k, d)
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]
    return y


def moe_ffn(p, x, cfg):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    w, idx, aux = _router(p, xt, cfg)
    if cfg.moe_dispatch == "sort":
        y = _moe_sort(p, xt, w, idx, cfg)
    else:
        y = _moe_einsum(p, xt, w, idx, cfg)
    if cfg.moe_shared_d_ff:
        h = xt @ p.sw1.to(xt.dtype)
        g = xt @ p.sw3.to(xt.dtype)
        y = y + (F.silu(h) * g) @ p.sw2.to(xt.dtype)
    return y.reshape(B, S, d), aux
