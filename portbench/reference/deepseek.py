"""Plain float32 reference of DeepSeek-V2-Lite (arXiv:2405.04434) as the
benchmark's ``deepseek`` configurations run it.

``first_k_dense_replace`` dense layers (multi-head latent attention and a
SwiGLU FFN), then layers of MLA and a mixture-of-experts FFN: a softmax
router, top-``num_experts_per_tok`` routed experts, ``n_shared_experts``
shared ones; a final RMS norm and an untied head.

MLA is written in its plain form: ``c_kv = norm(x W_dkv)``, per-head keys
``[c_kv W_uk, rope(x W_kr)]`` and values ``c_kv W_uv``, causal softmax over
``q . k / sqrt(qk_nope + qk_rope)``.

The routing is token-choice with a capacity, as the configuration runs it
(``moe_dispatch: einsum``): the tokens of one forward call, flattened row
by row, fall in groups of ``moe_group_tokens`` (halved until it divides the
call's tokens); in a group each expert takes at most ``C = max(ceil(group *
k / E * moe_capacity_factor), k)`` assignments, filled choice-major (every
token's first choice before any second choice), and an assignment past
``C`` adds nothing; the kept ones keep their top-k weights.  The auxiliary
loss is Switch's, ``E * sum_e (share of first choices to e) * (mean
probability of e)`` over the call's tokens, per MoE layer.

Departures from the published model (listed in the configuration file):
no YaRN scaling of the rotary embedding (plain RoPE, theta 10000, the head's
halves as pairs), the top-k weights normalized to sum to 1, the batch-level
Switch auxiliary loss instead of the sequence-level one, the capacity above,
and ``(1 + scale)`` RMS norm gains.

Beside the reference, what the harness needs of the family: ``expected``
(the program's sizes against the file's), ``forward_flops`` (the model
FLOPs of the ``mfu`` metrics) and ``smoke_sizes`` (the CPU tests' cells).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import cross_entropy_sum, einsum, mm, rms_norm, rope, swiglu

__all__ = ["dims", "param_table", "hidden", "head", "loss_sum", "route", "group_size", "capacity",
           "expected", "forward_flops", "smoke_sizes"]


def dims(c: dict) -> dict:
    if (c.get("rope_scaling") or {}).get("factor", 1) > 1:
        raise ValueError("the reference applies plain RoPE: a YaRN factor above 1 is not implemented")
    return {
        "d": c["hidden_size"], "H": c["num_attention_heads"], "L": c["kv_lora_rank"],
        "nope": c["qk_nope_head_dim"], "rp": c["qk_rope_head_dim"], "dv": c["v_head_dim"],
        "ff": c["intermediate_size"], "eff": c["moe_intermediate_size"],
        "E": c["n_routed_experts"], "k": c["num_experts_per_tok"],
        "shared": c["n_shared_experts"], "V": c["vocab_size"], "eps": c["rms_norm_eps"],
        "theta": c["rope_theta"], "layers": c["num_hidden_layers"],
        "dense": c["first_k_dense_replace"], "norm_topk": c["norm_topk_prob"],
        "group": c["moe_group_tokens"], "cf": c["moe_capacity_factor"],
        "aux_coef": c["moe_aux_coef"],
    }


def _name(m: dict, layer: int) -> str:
    """The parameter prefix of layer ``layer``: ``head.<i>`` for the dense
    layers, ``stack.<j>.0`` for the MoE layers."""
    return f"head.{layer}" if layer < m["dense"] else f"stack.{layer - m['dense']}.0"


def param_table(c: dict) -> list:
    """``[(name, shape, mean, std)]`` in the order of the benchmark's draw;
    norm gains get a spread of 0.1 around 0."""
    m = dims(c)
    d, H, L, nope, rp, dv = m["d"], m["H"], m["L"], m["nope"], m["rp"], m["dv"]
    s = 1.0 / math.sqrt(d)
    table = [("embed", (m["V"], d), 0.0, 0.02), ("final_norm", (d,), 0.0, 0.1),
             ("out", (d, m["V"]), 0.0, s)]
    for layer in range(m["layers"]):
        pre = _name(m, layer)
        table += [
            (f"{pre}.attn.kv_norm", (L,), 0.0, 0.1),
            (f"{pre}.attn.w_dkv", (d, L), 0.0, s),
            (f"{pre}.attn.w_kr", (d, rp), 0.0, s),
            (f"{pre}.attn.w_uk", (L, H, nope), 0.0, 1.0 / math.sqrt(L)),
            (f"{pre}.attn.w_uv", (L, H, dv), 0.0, 1.0 / math.sqrt(L)),
            (f"{pre}.attn.wo", (H, dv, d), 0.0, 1.0 / math.sqrt(H * dv)),
            (f"{pre}.attn.wq", (d, H, nope + rp), 0.0, s),
            (f"{pre}.ln1", (d,), 0.0, 0.1),
            (f"{pre}.ln2", (d,), 0.0, 0.1),
        ]
        if layer < m["dense"]:
            ff = m["ff"]
            table += [(f"{pre}.w1", (d, ff), 0.0, s),
                      (f"{pre}.w2", (ff, d), 0.0, 1.0 / math.sqrt(ff)),
                      (f"{pre}.w3", (d, ff), 0.0, s)]
        else:
            E, eff, sff = m["E"], m["eff"], m["shared"] * m["eff"]
            table += [
                (f"{pre}.moe.router", (d, E), 0.0, s),
                (f"{pre}.moe.sw1", (d, sff), 0.0, s),
                (f"{pre}.moe.sw2", (sff, d), 0.0, 1.0 / math.sqrt(sff)),
                (f"{pre}.moe.sw3", (d, sff), 0.0, s),
                (f"{pre}.moe.w1", (E, d, eff), 0.0, s),
                (f"{pre}.moe.w2", (E, eff, d), 0.0, 1.0 / math.sqrt(eff)),
                (f"{pre}.moe.w3", (E, d, eff), 0.0, s),
            ]
    return table


def _mla(p: dict, pre: str, x: torch.Tensor, m: dict, prec) -> torch.Tensor:
    b, S, d = x.shape
    H, nope, rp = m["H"], m["nope"], m["rp"]
    pos = torch.arange(S, device=x.device)
    q = mm(x, p[f"{pre}.attn.wq"].reshape(d, -1), prec).reshape(b, S, H, nope + rp)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], pos, m["theta"])
    c_kv = rms_norm(mm(x, p[f"{pre}.attn.w_dkv"], prec), p[f"{pre}.attn.kv_norm"], m["eps"])
    k_rope = rope(mm(x, p[f"{pre}.attn.w_kr"], prec)[:, :, None, :], pos, m["theta"])
    k_nope = einsum("btl,lhn->bthn", c_kv, p[f"{pre}.attn.w_uk"], prec)
    v = einsum("btl,lhv->bthv", c_kv, p[f"{pre}.attn.w_uv"], prec)
    scale = 1.0 / math.sqrt(nope + rp)
    outs = []
    for r in range(b):  # one row at a time, queries in blocks: [H, q, S] scores
        row = []
        for lo in range(0, S, 2048):
            hi = min(lo + 2048, S)
            s = (einsum("qhn,thn->hqt", q_nope[r, lo:hi], k_nope[r], prec)
                 + einsum("qhn,tn->hqt", q_rope[r, lo:hi], k_rope[r, :, 0], prec)) * scale
            mask = torch.arange(S, device=x.device)[None, :] <= torch.arange(
                lo, hi, device=x.device)[:, None]
            probs = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            row.append(einsum("hqt,thv->qhv", probs, v[r], prec))
        outs.append(torch.cat(row))
    o = torch.stack(outs).reshape(b, S, -1)
    return mm(o, p[f"{pre}.attn.wo"].reshape(-1, d), prec)


def route(x: torch.Tensor, router: torch.Tensor, m: dict, prec=None):
    """``(probabilities [T, E], top-k weights [T, k], top-k experts [T,
    k])``; among equal probabilities the lower expert comes first."""
    probs = torch.softmax(mm(x, router, prec), dim=-1)
    values, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = values[:, :m["k"]], experts[:, :m["k"]]
    if m["norm_topk"]:
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, w, idx


def group_size(T: int, m: dict) -> int:
    g = min(m["group"], T)
    while T % g:
        g //= 2
    return g


def capacity(group: int, m: dict) -> int:
    return max(int(math.ceil(group * m["k"] / m["E"] * m["cf"])), m["k"])


def ranks(idx: torch.Tensor, m: dict) -> tuple[torch.Tensor, int]:
    """``(each assignment's place [T, k] in its expert's buffer, the
    capacity C)``: its group filled choice-major, an assignment kept where
    its place is under C."""
    T, k = idx.shape
    g = group_size(T, m)
    onehot = F.one_hot(idx.reshape(T // g, g, k), m["E"])  # [G, g, k, E]
    # the same expert's earlier choices in the group, then the earlier
    # tokens' same choice
    before = onehot.sum(1, keepdim=True).cumsum(2) - onehot.sum(1, keepdim=True)
    rank = before + onehot.cumsum(1) - onehot
    return (rank * onehot).sum(-1).reshape(T, k), capacity(g, m)


def _kept(idx: torch.Tensor, m: dict) -> torch.Tensor:
    rank, C = ranks(idx, m)
    return rank < C


def _moe_call(p: dict, pre: str, xt: torch.Tensor, m: dict, prec):
    """One forward call's MoE FFN over its tokens ``xt [T, d]``: ``(y,
    aux)``."""
    probs, w, idx = route(xt, p[f"{pre}.moe.router"], m, prec)
    keep = _kept(idx, m)
    E = m["E"]
    load = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(load * probs.mean(0))
    y = torch.zeros_like(xt)
    w = w * keep
    for e in range(E):
        tok, choice = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(xt[tok], p[f"{pre}.moe.w1"][e], p[f"{pre}.moe.w3"][e], p[f"{pre}.moe.w2"][e],
                     prec)
        y = y.index_add(0, tok, out * w[tok, choice][:, None])
    y = y + swiglu(xt, p[f"{pre}.moe.sw1"], p[f"{pre}.moe.sw3"], p[f"{pre}.moe.sw2"], prec)
    return y, aux


def _layer(p: dict, layer: int, x: torch.Tensor, m: dict, prec, calls):
    pre = _name(m, layer)
    x = x + _mla(p, pre, rms_norm(x, p[f"{pre}.ln1"], m["eps"]), m, prec)
    h = rms_norm(x, p[f"{pre}.ln2"], m["eps"])
    if layer < m["dense"]:
        return x + swiglu(h, p[f"{pre}.w1"], p[f"{pre}.w3"], p[f"{pre}.w2"], prec), h.new_zeros(())
    ys, aux = [], h.new_zeros(())
    for lo, hi in calls:
        part = h[:, lo:hi]
        y, a = _moe_call(p, pre, part.reshape(-1, part.shape[-1]), m, prec)
        ys.append(y.reshape(part.shape))
        aux = aux + a
    return x + torch.cat(ys, dim=1), aux


def hidden(p: dict, tokens: torch.Tensor, c: dict, prec=None, calls=None):
    """``(final-normed hidden states [B, S, d], summed auxiliary loss)``.
    ``calls`` lists the forward calls the positions were served in, as
    ``(first, end)`` position ranges (default: one call over all ``S``):
    each call's tokens route as one batch."""
    m = dims(c)
    S = tokens.shape[1]
    calls = calls or [(0, S)]
    x = p["embed"][tokens.long()]
    aux = x.new_zeros(())
    for layer in range(m["layers"]):
        if torch.is_grad_enabled():
            x, a = checkpoint(_layer, p, layer, x, m, prec, calls, use_reentrant=False)
        else:
            x, a = _layer(p, layer, x, m, prec, calls)
        aux = aux + a
    return rms_norm(x, p["final_norm"], m["eps"]), aux


def head(p: dict) -> torch.Tensor:
    """The output head ``[d, V]``."""
    return p["out"]


def loss_sum(p: dict, tokens: torch.Tensor, labels: torch.Tensor, c: dict, prec=None):
    """``(summed token cross-entropy, summed auxiliary loss)`` of one batch."""
    h, aux = hidden(p, tokens, c, prec)
    return cross_entropy_sum(h.reshape(-1, h.shape[-1]), head(p), labels.reshape(-1), prec), aux


def expected(cfg, c: dict) -> dict:
    """``{name: (the program's value, the file's value)}`` of the sizes
    that the program's configuration ``cfg`` and the file ``c`` both state,
    beyond the ones every family states."""
    dense = c["first_k_dense_replace"]
    return {
        "kv_lora_rank": (cfg.kv_lora_rank, c["kv_lora_rank"]),
        "qk_nope_dim": (cfg.qk_nope_dim, c["qk_nope_head_dim"]),
        "qk_rope_dim": (cfg.qk_rope_dim, c["qk_rope_head_dim"]),
        "v_head_dim": (cfg.v_head_dim, c["v_head_dim"]),
        "head_blocks": (tuple((b.kind, b.ffn, b.d_ff) for b in cfg.head_blocks),
                        (("mla", "swiglu", c["intermediate_size"]),) * dense),
        "superblock": (tuple((b.kind, b.ffn) for b in cfg.superblock), (("mla", "moe"),)),
        "n_superblocks": (cfg.n_superblocks, c["num_hidden_layers"] - dense),
        "moe_experts": (cfg.moe_experts, c["n_routed_experts"]),
        "moe_top_k": (cfg.moe_top_k, c["num_experts_per_tok"]),
        "moe_d_ff": (cfg.moe_d_ff, c["moe_intermediate_size"]),
        "moe_shared_d_ff": (cfg.moe_shared_d_ff, c["n_shared_experts"] * c["moe_intermediate_size"]),
        "moe_norm_topk": (cfg.moe_norm_topk, c["norm_topk_prob"]),
        "moe_group": (cfg.moe_group, c["moe_group_tokens"]),
        "moe_capacity": (cfg.moe_capacity, c["moe_capacity_factor"]),
        "moe_aux_coef": (cfg.moe_aux_coef, c["moe_aux_coef"]),
        "moe_dispatch": (cfg.moe_dispatch, c["moe_dispatch"]),
    }


def smoke_sizes(cfg) -> dict:
    """The file's sizes of this family that the program's (smoke)
    configuration ``cfg`` sets, as the file names them."""
    return dict(kv_lora_rank=cfg.kv_lora_rank, qk_nope_head_dim=cfg.qk_nope_dim,
                qk_rope_head_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
                intermediate_size=cfg.head_blocks[0].d_ff, moe_intermediate_size=cfg.moe_d_ff,
                n_routed_experts=cfg.moe_experts, num_experts_per_tok=cfg.moe_top_k,
                n_shared_experts=cfg.moe_shared_d_ff // cfg.moe_d_ff,
                first_k_dense_replace=len(cfg.head_blocks), moe_group_tokens=cfg.moe_group)


def forward_flops(c: dict, S: int) -> int:
    """Model FLOPs of one forward pass over one sequence of ``S`` tokens:
    ``2 x S x`` the matrix parameters a token touches (MLA's projections,
    the dense layers' SwiGLU, a MoE layer's router, its top-k routed and
    its shared experts, the head; embedding lookups and norm gains are no
    products), plus causal attention's ``QK^T`` and ``PV`` over the
    ``S (S + 1) / 2`` (query, key) pairs of each layer."""
    m = dims(c)
    d, H, L, nope, rp, dv = m["d"], m["H"], m["L"], m["nope"], m["rp"], m["dv"]
    mla = d * H * (nope + rp) + d * L + d * rp + L * H * (nope + dv) + H * dv * d
    moe = d * m["E"] + 3 * d * m["eff"] * (m["k"] + m["shared"])
    params = (m["layers"] * mla + m["dense"] * 3 * d * m["ff"] + (m["layers"] - m["dense"]) * moe
              + d * m["V"])
    return 2 * params * S + m["layers"] * 2 * H * (nope + rp + dv) * (S * (S + 1) // 2)
