"""Attention: GQA with sliding-window / logit-softcap, and the KV-cache
prefill and decode paths.

The full-sequence path goes through the flash-attention kernel
(``kernels/flash_attention.py``) on every device: on a CUDA tensor the
hand-written kernel, on a CPU tensor its plain PyTorch version.  It is
differentiable (``FlashAttentionFunction``: the kernel forward, a written-out
backward over query chunks of ``cfg.q_chunk`` rows), so training runs through
the same kernel.  The kernel and its plain version keep the softmax
probabilities in float32 for ``P V`` (as the reference's Pallas kernel
does); the reference's ``attention_full`` rounds them to the compute dtype
first, so in bfloat16 the two differ by one bfloat16 rounding.

The KV cache is a pair of tensors updated in place.

Multi-head latent attention (MLA, DeepSeek-V2) has no kernel in the
reference: it is plain products over query chunks, and so it is here
(``torch.einsum`` / ``torch.matmul``, cuBLAS on the card), with the
reference's rounding points: the absorbed query ``q_nope @ w_uk`` in the
compute dtype, the scores float32 products of compute-dtype operands (TF32
off), the probabilities rounded to the compute dtype before ``P c_kv``.  The
reference halves its query chunk until it divides S; here the chunks are
``min(q_chunk, S)`` rows with a ragged last one (each row has its own
softmax, so the function is the same, and an odd S costs no thousands of
one-row chunks).  Each chunk is recomputed in the backward pass
(``torch.utils.checkpoint``, the twin of the reference's ``jax.checkpoint``).
Its cache holds ``c_kv`` [B, T, kv_lora] and ``k_rope`` [B, T, rope] and is
updated in place.
"""

from __future__ import annotations

import math

import torch

from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import FlashAttentionFunction
from ..kernels.ops import full_float32_matmul
from ..kernels.ref import flash_attention_ref
from .layers import ENGINES, Spec, apply_rope, check_engine, rms_norm, rope, softcap

__all__ = [
    "ATTN_ENGINES",
    "attn_specs",
    "mla_specs",
    "attention_full",
    "attention_decode",
    "decode_probs",
    "decode_scores",
    "attn_block_full",
    "attn_block_decode",
    "mla_block_full",
    "mla_block_decode",
    "empty_kv_cache",
    "empty_mla_cache",
]

#: "auto": the kernel's wrapper (kernel on CUDA tensors, plain version on CPU
#: ones); "cuda": the kernel (CUDA tensors only); "torch": the plain version
ATTN_ENGINES = ENGINES


# -- parameter specs -----------------------------------------------------------------


def attn_specs(cfg) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = 1.0 / math.sqrt(d)
    return {
        "wq": Spec((d, H, Dh), ("fsdp_embed", "heads", "head_dim"), std=std),
        "wk": Spec((d, KV, Dh), ("fsdp_embed", "kv_heads", "head_dim"), std=std),
        "wv": Spec((d, KV, Dh), ("fsdp_embed", "kv_heads", "head_dim"), std=std),
        "wo": Spec((H, Dh, d), ("heads", "head_dim", "fsdp_embed"), std=1.0 / math.sqrt(H * Dh)),
    }


def mla_specs(cfg) -> dict:
    """Multi-head Latent Attention (DeepSeek-V2).  K/V are stored compressed:
    c_kv = x @ w_dkv (kv_lora dims) plus a single shared rope key head."""
    d, H = cfg.d_model, cfg.n_heads
    L = cfg.kv_lora_rank
    nope, rp, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    std = 1.0 / math.sqrt(d)
    return {
        "wq": Spec((d, H, nope + rp), ("fsdp_embed", "heads", "head_dim"), std=std),
        "w_dkv": Spec((d, L), ("fsdp_embed", "kv_lora"), std=std),
        "kv_norm": Spec((L,), ("kv_lora",), init="zeros"),
        "w_kr": Spec((d, rp), ("fsdp_embed", "head_dim"), std=std),
        "w_uk": Spec((L, H, nope), ("kv_lora", "heads", "head_dim"), std=1.0 / math.sqrt(L)),
        "w_uv": Spec((L, H, dv), ("kv_lora", "heads", "head_dim"), std=1.0 / math.sqrt(L)),
        "wo": Spec((H, dv, d), ("heads", "head_dim", "fsdp_embed"), std=1.0 / math.sqrt(H * dv)),
    }


# -- core attention ---------------------------------------------------------------------


def attention_full(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    *,
    window: int = -1,
    attn_softcap: float | None = None,
    q_offset: int = 0,
    kv_len: int | None = None,
    engine: str = "auto",
    q_chunk: int = 256,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention of ``q`` over the first
    ``kv_len`` (default ``T``) keys, the query rows at positions
    ``q_offset ..``; returns [B, S, H, D] in ``q``'s dtype.  Keys and values
    in another dtype (a bfloat16 cache under float32 compute) are cast to
    ``q``'s, as the reference's einsums promote them.  Differentiable: the
    ``"torch"`` engine through the plain version's ops, the others through
    ``FlashAttentionFunction``, whose backward runs over query chunks of
    ``q_chunk`` rows."""
    check_engine(engine, q.device)
    if k.dtype != q.dtype:
        k, v = k.to(q.dtype), v.to(q.dtype)
    # [B, H, S, D] views of the [B, S, H, D] tensors: both read them in place
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    cap = attn_softcap or 0.0
    if engine == "torch":
        out = flash_attention_ref(q, k, v, causal=True, window=window, softcap=cap,
                                  q_offset=q_offset, kv_len=kv_len)
    else:
        out = FlashAttentionFunction.apply(q, k, v, True, window, cap, q_offset, kv_len, q_chunk)
    return out.transpose(1, 2)


def attention_decode(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, T, KV, D]
    v_cache: torch.Tensor,
    index: int,  # current position (tokens < index are valid)
    *,
    window: int = -1,
    attn_softcap: float | None = None,
) -> torch.Tensor:
    """One query against the cache (plain PyTorch: the reference has no
    decode kernel).  Scores are the compute-dtype products accumulated in
    float32; the probabilities are rounded to ``q``'s dtype before ``P V``,
    as in the reference."""
    B, _, H, D = q.shape
    _, T, KV, _ = k_cache.shape
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    probs = decode_probs(s, index, window, attn_softcap, q.dtype)
    out_dtype = torch.promote_types(q.dtype, v_cache.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", probs.float(), v_cache.float()).to(out_dtype)
    return o.reshape(B, 1, H, D)


def decode_probs(s: torch.Tensor, index: int, window: int, attn_softcap, dtype) -> torch.Tensor:
    """A decode step's probabilities from its float32 scores ``s [..., T]``
    (already scaled): keys after ``index`` or ``window`` or more positions
    below it masked at ``-1e30``, the softcap, the softmax, rounded to
    ``dtype``."""
    return torch.softmax(decode_scores(s, index, window, attn_softcap), dim=-1).to(dtype)


def decode_scores(s: torch.Tensor, index: int, window: int, attn_softcap,
                  first: int = 0) -> torch.Tensor:
    """:func:`decode_probs`' scores before the softmax: softcapped, and
    masked at ``-1e30`` where the key's position (``first`` for the last
    dim's first entry: a shard of a cache split along its sequence) is after
    ``index`` or ``window`` or more positions below it."""
    k_pos = first + torch.arange(s.shape[-1], device=s.device)
    mask = k_pos <= index
    if window > 0:
        mask &= (index - k_pos) < window
    if attn_softcap:
        s = softcap(s, attn_softcap)
    return torch.where(mask, s, torch.full((), -1e30, device=s.device))


# -- block-level wrappers (projections + rope + attention) ------------------------------------


def _project_qkv(p, x, cfg, positions, compute_dtype):
    B, S, d = x.shape

    def proj(w):
        return (x @ w.to(compute_dtype).reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p.wq), proj(p.wk), proj(p.wv)
    sin, cos = rope(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _out_proj(p, o, dtype):
    B, S, H, Dh = o.shape
    return o.reshape(B, S, H * Dh) @ p.wo.to(dtype).reshape(H * Dh, -1)


def _is_ring(bdef, capacity: int) -> bool:
    """Whether a KV cache of ``capacity`` slots is a ring: sliding-window
    layers keep only a window-sized ring cache (gemma2's local layers: 4096
    slots instead of the full context)."""
    return 0 < bdef.window and capacity <= bdef.window


def attn_block_full(p, x, cfg, bdef, positions, cache=None, cache_index=None, engine="auto"):
    """Full-sequence attention sub-block.  Returns (out, cache); the cache
    (when given) is updated in place."""
    B, S, d = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, x.dtype)
    if cache is not None and _is_ring(bdef, cache["k"].shape[1]):
        # prefill a window ring cache: attend over the fresh k/v, store the
        # last W tokens at slots (pos % W).  (Ring prefill assumes
        # cache_index == 0.)
        o = attention_full(q, k, v, window=bdef.window, attn_softcap=cfg.attn_softcap,
                           engine=engine, q_chunk=cfg.q_chunk)
        W = cache["k"].shape[1]
        take = min(W, S)
        slots = torch.arange(S - take, S, device=x.device) % W
        cache["k"][:, slots] = k[:, S - take:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, S - take:].to(cache["v"].dtype)
    elif cache is not None:
        # attend over the cached (dtype-rounded) k/v up to cache_index + S
        cache["k"][:, cache_index:cache_index + S] = k.to(cache["k"].dtype)
        cache["v"][:, cache_index:cache_index + S] = v.to(cache["v"].dtype)
        o = attention_full(
            q, cache["k"], cache["v"], window=bdef.window, attn_softcap=cfg.attn_softcap,
            q_offset=cache_index, kv_len=cache_index + S, engine=engine, q_chunk=cfg.q_chunk,
        )
    else:
        o = attention_full(q, k, v, window=bdef.window, attn_softcap=cfg.attn_softcap,
                           engine=engine, q_chunk=cfg.q_chunk)
    return _out_proj(p, o, x.dtype), cache


def attn_block_decode(p, x, cfg, bdef, cache, index):
    """One-token decode with the cache updated in place.  x: [B, 1, d]."""
    positions = torch.full((x.shape[0], 1), index, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, x.dtype)
    if _is_ring(bdef, cache["k"].shape[1]):
        # ring slots hold exactly the last W positions (rope was applied at the
        # absolute position before caching); a slot s is filled iff s <= index.
        slot = index % cache["k"].shape[1]
        window = -1
    else:
        slot = index
        window = bdef.window
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    o = attention_decode(q, cache["k"], cache["v"], index, window=window,
                         attn_softcap=cfg.attn_softcap)
    return _out_proj(p, o, x.dtype), cache


def empty_kv_cache(cfg, batch: int, capacity: int, dtype, window: int = -1, device=None) -> dict:
    if window > 0:
        capacity = min(capacity, window)
    shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# -- MLA -------------------------------------------------------------------------------------


def _mla_qkv(p, x, cfg, positions, compute_dtype):
    B, S, d = x.shape
    H = cfg.n_heads
    nope, rp = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ p.wq.to(compute_dtype).reshape(d, -1)).reshape(B, S, H, nope + rp)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    sin, cos = rope(positions, rp, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)

    c_kv = rms_norm(x @ p.w_dkv.to(compute_dtype), p.kv_norm, cfg.norm_eps)
    k_rope = x @ p.w_kr.to(compute_dtype)
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0, :]  # single shared head
    return q_nope, q_rope, c_kv, k_rope


def _mla_chunk(q_abs, q_rope, c_kv, k_rope, w_uv, q_pos, kv_len, scale):
    """One query chunk: float32 scores of compute-dtype operands (TF32 off),
    the probabilities rounded to the compute dtype, then ``(P c_kv) w_uv``.
    q_abs [B, q, H, L], q_rope [B, q, H, rope] -> [B, q, H, dv]."""
    T = c_kv.shape[1]
    with full_float32_matmul():
        s = torch.einsum("bqhl,btl->bhqt", q_abs.float(), c_kv.float())
        s = s + torch.einsum("bqhk,btk->bhqt", q_rope.float(), k_rope.float())
    s = s * scale
    k_pos = torch.arange(T, device=c_kv.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if kv_len is not None:
        mask &= k_pos[None, :] < kv_len
    s = torch.where(mask, s, torch.full((), -1e30, device=s.device))
    probs = torch.softmax(s, dim=-1).to(c_kv.dtype)
    # value up-projection after prob-weighting in compressed space
    ctx = torch.einsum("bhqt,btl->bqhl", probs, c_kv)
    return torch.einsum("bqhl,lhv->bqhv", ctx, w_uv)


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, cfg, q_offset, kv_len, compute_dtype, q_chunk):
    """Attention in compressed space.

    Absorb w_uk into q (the MLA trick): score = (q_nope @ w_uk) . c_kv
    + q_rope . k_rope, so the cache stays [T, kv_lora + rope].  Values are
    un-compressed per head after the probs.  The query rows run in chunks of
    ``min(q_chunk, S)`` (the last one ragged), each recomputed in backward.
    The cache is in the compute dtype or bfloat16; a bfloat16 cache under
    float32 compute is cast up exactly, as the reference's products promote
    it.  A float32 cache under bfloat16 compute, where the reference's
    products would promote to float32 instead, is refused."""
    B, S, H, _ = q_nope.shape
    if c_kv.dtype not in (compute_dtype, torch.bfloat16):
        raise ValueError(f"an MLA cache in {c_kv.dtype} under {compute_dtype} compute: the cache "
                         f"must be in the compute dtype or bfloat16")
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    c_kv, k_rope = c_kv.to(compute_dtype), k_rope.to(compute_dtype)
    w_uv = p.w_uv.to(compute_dtype)
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope, p.w_uk.to(compute_dtype))
    qc = min(q_chunk, S)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q_abs, q_rope, c_kv, k_rope, w_uv))
    outs = []
    for lo in range(0, S, qc):
        hi = min(lo + qc, S)
        q_pos = q_offset + torch.arange(lo, hi, device=q_nope.device)
        args = (q_abs[:, lo:hi], q_rope[:, lo:hi], c_kv, k_rope, w_uv, q_pos, kv_len, scale)
        outs.append(checkpoint(_mla_chunk, *args, use_reentrant=False) if remat
                    else _mla_chunk(*args))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def mla_block_full(p, x, cfg, bdef, positions, cache=None, cache_index=None):
    """Full-sequence MLA sub-block.  Returns (out, cache); the cache (when
    given) is updated in place and the queries attend over its first
    ``cache_index + S`` rows (the rows past them, masked in the reference,
    add exact zeros there)."""
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions, x.dtype)
    kv_len = None
    if cache is not None:
        kv_len = cache_index + S
        cache["c_kv"][:, cache_index:kv_len] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, cache_index:kv_len] = k_rope.to(cache["k_rope"].dtype)
        c_kv, k_rope = cache["c_kv"][:, :kv_len], cache["k_rope"][:, :kv_len]
    o = _mla_attend(
        p, q_nope, q_rope, c_kv, k_rope, cfg,
        q_offset=cache_index if cache is not None else 0,
        kv_len=kv_len, compute_dtype=x.dtype,
        q_chunk=cfg.q_chunk if cache is None else cfg.prefill_q_chunk,
    )
    return _out_proj(p, o, x.dtype), cache


def mla_block_decode(p, x, cfg, bdef, cache, index):
    """One-token MLA decode with the cache updated in place; the query reads
    the whole capacity under the ``index + 1`` mask, as the reference does."""
    positions = torch.full((x.shape[0], 1), index, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions, x.dtype)
    cache["c_kv"][:, index] = c_kv[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, index] = k_rope[:, 0].to(cache["k_rope"].dtype)
    o = _mla_attend(
        p, q_nope, q_rope, cache["c_kv"], cache["k_rope"], cfg,
        q_offset=index, kv_len=index + 1, compute_dtype=x.dtype, q_chunk=1,
    )
    return _out_proj(p, o, x.dtype), cache


def empty_mla_cache(cfg, batch: int, capacity: int, dtype, device=None) -> dict:
    return {
        "c_kv": torch.zeros((batch, capacity, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, capacity, cfg.qk_rope_dim), dtype=dtype, device=device),
    }
